// flash_fwd: tiled online-softmax attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of paddle_tpu/ops/flash_attention.py
// (launched by `_flash_call`). Same function: for each (b*n) row and query
// row, O = softmax(scale * q.K^T + bias, causal/kv_len masks) . V and the
// row log-sum-exp, with scores, running max/sum and the accumulator in f32;
// in bf16 each k-block's unnormalised p is rounded to bf16 before P.V at
// the reference's block size and rounding point (flash_fwd_body.cuh).
//
// Layout: q (bn, sq, d), k/v (bn, sk, d), row-major, fp32 or bf16; bias
// (bn, sk) f32 per-key additive, or null; O (bn, sq, d) in the input type;
// lse (bn, sq) f32 (the TPU kernel's 128-lane padding was a Mosaic tiling
// artifact and is gone). Any head dim d with d % 4 == 0 up to 256 runs: the
// kernel is instantiated for d rounded up to a multiple of 16 (DP) and
// zero-fills the padded columns in shared memory.
//
// Translation. On the TPU the k-tiles of one query tile run in order on one
// core and carry m, l and the accumulator in VMEM scratch from one grid step
// to the next. Blocks on Hopper run in parallel and in no order, so the
// sequential k dimension becomes a loop inside the block: one block of 256
// threads owns 64 query rows of one (b*n) row and walks the k-tiles of 64
// keys, staging each K and V tile in shared memory; m, l and the 64 x DP
// accumulator stay in registers (each thread: 4 rows x DP/16 columns).
// Causal runs stop at the last tile that touches the diagonal.
//
// Bound on this card. FLOPs 4*bn*sq*sk*d (about half when causal) against
// the bytes of q, k, v and o, 16*bn*s*d in fp32 at sq = sk = s: s/4 FLOP
// per byte (s/8 causal), 128 at GPT-2's s = 1024, far above the H100's
// 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte, so it is bound by operations.
// This version uses plain f32 FMAs (no TF32 tensor cores: the reference
// runs at "highest" precision), so its ceiling is the 67 TFLOP/s
// non-tensor fp32 rate. What the design does about it:
// register tiling (a 4 x 4 score micro-tile per thread, 4-wide shared loads
// laid out bank-conflict free) so that shared memory feeds the FMA units,
// and the causal tile skip halves the work. wgmma/TMA come in a later
// change. The body is in flash_fwd_body.cuh, which flash_small_fwd.cu's
// fp32 path shares.
#include "flash_fwd_body.cuh"

using namespace flash;

namespace {

template <typename T, int DP>
__global__ void __launch_bounds__(tiled::NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ o, float* __restrict__ lse, int sq, int sk,
                 int d, int causal, float sm_scale) {
  tiled::fwd_body<T, DP>(q, k, v, bias, o, lse, sq, sk, d, causal, sm_scale);
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* bias, void* o, void* lse, int bn,
                                int sq, int sk, int d, int is_bf16,
                                int causal, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 4 != 0 || d > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
#define FLASH_FWD_CASE(DD)                                                  \
  case DD:                                                                  \
    return is_bf16                                                          \
               ? tiled::launch_fwd<__nv_bfloat16, DD>(                      \
                     flash_fwd_kernel<__nv_bfloat16, DD>, q, k, v, bias, o, \
                     lse, bn, sq, sk, d, causal, sm_scale, st)              \
               : tiled::launch_fwd<float, DD>(                              \
                     flash_fwd_kernel<float, DD>, q, k, v, bias, o, lse,    \
                     bn, sq, sk, d, causal, sm_scale, st);
  switch ((d + 15) / 16 * 16) {
    FLASH_FOR_EACH_DP(FLASH_FWD_CASE)
  }
#undef FLASH_FWD_CASE
  return (int)cudaErrorInvalidValue;
}
