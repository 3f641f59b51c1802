// flash_fwd: tiled online-softmax attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of paddle_tpu/ops/flash_attention.py
// (launched by `_flash_call`). Same function: for each (b*n) row and query
// row, O = softmax(scale * q.K^T + bias, causal/kv_len masks) . V and the
// row log-sum-exp, with scores, running max/sum and the accumulator in f32;
// in bf16 each k-block's unnormalised p is rounded to bf16 before P.V at
// the reference's block size and rounding point.
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
// sequential k dimension becomes a loop inside the block: one block owns
// 64 (128 in bf16 on wgmma) query rows of one (b*n) row and walks the
// k-tiles of 64 keys, staging each K and V tile in shared memory; m, l and
// the accumulator stay in registers. Causal runs stop at the last tile
// that touches the diagonal.
//
// Bound on this card. FLOPs 4*bn*sq*sk*d (about half when causal) against
// the bytes of q, k, v and o, 16*bn*s*d in fp32 at sq = sk = s: s/4 FLOP
// per byte (s/8 causal), 128 at GPT-2's s = 1024, far above the H100's
// 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte: fp32 is bound by operations. In
// bf16 (half the bytes, 989 TFLOP/s) the causal GPT-2 shape sits near the
// balance point, its bytes bound a little above its operations. Three
// bodies, picked by the launch (the library alone holds the rule, and
// flash_fwd_blocks_per_sm reports it):
//
//  * fp32 with DP <= 64 (GPT-2's serve and train path): the tensor cores
//    at fp32 accuracy, three TF32 mma.sync products of hi + lo split
//    operands a product (495 / 3 = 165 TFLOP/s against the FMA units'
//    67), K/V double-buffered by cp.async, P as the A operand in
//    registers; flash_fwd_tc.cuh, fwd_tc::f32_query_block. Kernel:
//    flash_fwd_kernel_tc.
//  * bf16 with DP <= 128: wgmma, two passes over each reference k-block
//    (its row max, then p rounded to bf16 at the reference's point and
//    P.V); flash_fwd_tc.cuh, fwd_tc::bf16_query_block. Kernel:
//    flash_fwd_kernel_wgmma.
//  * the rest (fp32 above DP 64, bf16 above DP 128): the register-tiled
//    f32 FMA body of flash_fwd_body.cuh, which flash_small_fwd.cu's fp32
//    path shares. Kernel: flash_fwd_kernel.
//
// The tensor-core grids are (bn, query tiles) with the last query tile,
// the heaviest under the causal mask, first on the slow dimension.
#include <type_traits>

#include "flash_fwd_body.cuh"
#include "flash_fwd_tc.cuh"

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

template <int DP>
__global__ void __launch_bounds__(fwd_tc::kF32Threads)
flash_fwd_kernel_tc(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ bias, float* __restrict__ o,
                    float* __restrict__ lse, int sq, int sk, int d,
                    int causal, float sm_scale) {
  // one extern shared array of one type for both tensor-core kernels
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile = gridDim.y - 1 - blockIdx.y;
  fwd_tc::f32_query_block<DP>(q, k, v, bias, o, lse, blockIdx.x,
                              tile * fwd_tc::kF32Rows, sq, sk, d, causal,
                              sm_scale, reinterpret_cast<float*>(smem));
}

template <int DP>
__global__ void __launch_bounds__(fwd_tc::kBf16Threads)
flash_fwd_kernel_wgmma(const tc::bf16* __restrict__ q,
                       const tc::bf16* __restrict__ k,
                       const tc::bf16* __restrict__ v,
                       const float* __restrict__ bias,
                       tc::bf16* __restrict__ o, float* __restrict__ lse,
                       int sq, int sk, int d, int causal, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile = gridDim.y - 1 - blockIdx.y;
  fwd_tc::bf16_query_block<DP>(q, k, v, bias, o, lse, blockIdx.x,
                               tile * fwd_tc::kBf16Rows, sq, sk, d, causal,
                               sm_scale, smem);
}

template <typename T, int DP>
constexpr bool kTensorCores =
    std::is_same<T, float>::value ? DP <= fwd_tc::kF32MaxDP
                                  : DP <= fwd_tc::kBf16MaxDP;

// The body a launch at (T, DP) runs, handed to fn as (kernel, grid,
// threads, dynamic shared memory bytes).
template <typename T, int DP, typename Fn>
int with_body(int bn, int sq, Fn fn) {
  if constexpr (kTensorCores<T, DP> && std::is_same<T, float>::value)
    return fn(flash_fwd_kernel_tc<DP>,
              dim3(bn, (sq + fwd_tc::kF32Rows - 1) / fwd_tc::kF32Rows),
              fwd_tc::kF32Threads, fwd_tc::F32Smem<DP>::kBytes);
  else if constexpr (kTensorCores<T, DP>)
    return fn(flash_fwd_kernel_wgmma<DP>,
              dim3(bn, (sq + fwd_tc::kBf16Rows - 1) / fwd_tc::kBf16Rows),
              fwd_tc::kBf16Threads, fwd_tc::Bf16Smem<DP>::kBytes);
  else
    return fn(flash_fwd_kernel<T, DP>,
              dim3((sq + tiled::BQ - 1) / tiled::BQ, bn), tiled::NT,
              tiled::smem_bytes<DP>());
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* o, void* lse, int bn, int sq, int sk, int d, int causal,
           float sm_scale, cudaStream_t stream) {
  return with_body<T, DP>(bn, sq, [&](auto kern, dim3 grid, int threads,
                                      size_t smem) {
    return launch_kernel(kern, grid, threads, smem, stream,
                         static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v),
                         static_cast<const float*>(bias), static_cast<T*>(o),
                         static_cast<float*>(lse), sq, sk, d, causal,
                         sm_scale);
  });
}

// Blocks an SM holds of the body at (T, DP); sets *tensor_cores to
// whether that body is a tensor-core one.
template <typename T, int DP>
int query(int* tensor_cores) {
  *tensor_cores = kTensorCores<T, DP>;
  return with_body<T, DP>(1, 1, [](auto kern, dim3, int threads,
                                   size_t smem) {
    return blocks_per_sm(kern, threads, smem);
  });
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
    return is_bf16 ? launch<__nv_bfloat16, DD>(q, k, v, bias, o, lse, bn,   \
                                               sq, sk, d, causal, sm_scale, \
                                               st)                          \
                   : launch<float, DD>(q, k, v, bias, o, lse, bn, sq, sk,   \
                                       d, causal, sm_scale, st);
  switch ((d + 15) / 16 * 16) {
    FLASH_FOR_EACH_DP(FLASH_FWD_CASE)
  }
#undef FLASH_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

// Blocks of the kernel that a launch at head dim d runs that fit on one
// SM, or minus a cudaError_t; *tensor_cores is set to 1 where that kernel
// is a tensor-core body (flash_fwd_kernel_tc, flash_fwd_kernel_wgmma),
// else 0.
extern "C" int flash_fwd_blocks_per_sm(int d, int is_bf16,
                                       int* tensor_cores) {
  if (d <= 0 || d % 4 != 0 || d > kMaxHeadDim)
    return -(int)cudaErrorInvalidValue;
#define FLASH_FWD_QUERY(DD)                                                 \
  case DD:                                                                  \
    return is_bf16 ? query<__nv_bfloat16, DD>(tensor_cores)                 \
                   : query<float, DD>(tensor_cores);
  switch ((d + 15) / 16 * 16) {
    FLASH_FOR_EACH_DP(FLASH_FWD_QUERY)
  }
#undef FLASH_FWD_QUERY
  return -(int)cudaErrorInvalidValue;
}
