// flash_small_bwd: short-sequence flash-attention backward in one launch,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_small_bwd_kernel` of
// paddle_tpu/ops/flash_attention.py (launched by `_small_bwd_call`), which
// the dispatch picks when sq, sk <= 512 (`_small_ok`). Same function as
// the tiled pair flash_bwd_dkv + flash_bwd_dq: dQ, dK, dV and the per-key
// bias grad from the saved lse, in one launch.
//
// Layout: q, dO (bn, sq, d), k/v (bn, sk, d), fp32 or bf16; bias (bn, sk)
// f32 or null; lse, delta (bn, sq) f32; dQ, dK, dV in the input type, db
// (bn, sk) f32.
//
// Translation. The TPU kernel holds B whole (sq, sk) f32 score tiles in VMEM
// and reads dQ, dK and dV off them in one pass. A Hopper block has at most
// 227 KB of shared memory, less than one (b*n) row's K and V at sk = 512,
// d = 64 in f32 (256 KB), so one row is split over several blocks of one
// grid: the first ceil(sk/64) blocks of a row each own 64 keys (dK, dV, db;
// the BwdDkv body) and the rest each own 64 query rows (dQ; the BwdDq
// body). Every output element has one owner block, so there are no float
// atomics and a rerun gives the same bits. The price: both kinds of block
// recompute S and dP for their tile, 14 FLOP per kept pair and column
// against the single pass's 10.
//
// Bound on this card: 10 FLOP per kept pair and column against reading q,
// k, v, dO once; at s = 512 far above the 20 FLOP/byte fp32 balance point,
// so bound by operations (plain f32 FMAs). Design against it: the two block
// kinds share one launch, so they fill the card together, and each runs
// the register-tiled bodies of the tiled kernels.
#include "flash_bwd_common.cuh"

namespace {

using namespace flash;

template <typename T, int DP>
__global__ void __launch_bounds__(kBwdThreads)
flash_small_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ bias,
                       const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       T* __restrict__ dk, T* __restrict__ dv,
                       float* __restrict__ db, int sq, int sk, int d,
                       int causal, float sm_scale, int n_key_blocks) {
  extern __shared__ __align__(16) float smem[];
  const int bx = blockIdx.x;
  if (bx < n_key_blocks)
    BwdDkv<T, DP>::run(q, k, v, bias, dout, lse, delta, dk, dv, db,
                       blockIdx.y, bx * kBwdOwn, sq, sk, d, causal, sm_scale,
                       smem);
  else
    BwdDq<T, DP>::run(q, k, v, bias, dout, lse, delta, dq, blockIdx.y,
                      (bx - n_key_blocks) * kBwdOwn, sq, sk, d, causal,
                      sm_scale, smem);
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* dout, const void* lse, const void* delta, void* dq,
           void* dk, void* dv, void* db, int bn, int sq, int sk, int d,
           int causal, float sm_scale, cudaStream_t stream) {
  constexpr int kFloats = BwdDkv<T, DP>::kSmemFloats > BwdDq<T, DP>::kSmemFloats
                              ? BwdDkv<T, DP>::kSmemFloats
                              : BwdDq<T, DP>::kSmemFloats;
  const size_t smem = (size_t)kFloats * sizeof(float);
  auto kern = flash_small_bwd_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_key_blocks = (sk + kBwdOwn - 1) / kBwdOwn;
  dim3 grid(n_key_blocks + (sq + kBwdOwn - 1) / kBwdOwn, bn);
  kern<<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(db), sq,
      sk, d, causal, sm_scale, n_key_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int flash_small_bwd_launch(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dq, void* dk,
                                      void* dv, void* db, int bn, int sq,
                                      int sk, int d, int is_bf16, int causal,
                                      float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 4 != 0 || d > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
#define FLASH_SMALL_BWD_CASE(DD)                                            \
  case DD:                                                                  \
    return is_bf16                                                          \
               ? launch<__nv_bfloat16, DD>(q, k, v, bias, dout, lse, delta, \
                                           dq, dk, dv, db, bn, sq, sk, d,   \
                                           causal, sm_scale, st)            \
               : launch<float, DD>(q, k, v, bias, dout, lse, delta, dq, dk, \
                                   dv, db, bn, sq, sk, d, causal, sm_scale, \
                                   st);
  switch ((d + 15) / 16 * 16) {
    FLASH_FOR_EACH_DP(FLASH_SMALL_BWD_CASE)
  }
#undef FLASH_SMALL_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
