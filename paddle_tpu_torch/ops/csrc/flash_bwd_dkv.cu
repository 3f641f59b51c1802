// flash_bwd_dkv: key-owning half of the tiled flash-attention backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_dkv_kernel` of
// paddle_tpu/ops/flash_attention.py (first launch of `_flash_bwd_call`).
// Same function: for each (b*n) row and key, dV = P^T . dO, dK = scale *
// dS^T . Q and, with a per-key bias, db = colsum(dS), where P = exp(scale *
// q.K^T + bias - lse) under the causal / kv-length masks and dS = P * (dO .
// V^T - delta), delta = rowsum(dO * O) from the caller.
//
// Layout: q, dO (bn, sq, d), k/v (bn, sk, d), fp32 or bf16; bias (bn, sk)
// f32 or null; lse, delta (bn, sq) f32; dK, dV in the input type, db (bn,
// sk) f32. Head dims d % 4 == 0 up to 256, padded to DP as in flash_fwd.
//
// Translation. On the TPU the q-tiles of one k-tile run in order on one core
// and carry dK, dV and db in VMEM scratch. Here one block of 256 threads
// owns 64 keys of one (b*n) row (so dK, dV and db need no atomics), keeps
// their K and V tiles in shared memory and loops over the q-tiles, staging Q
// and dO; the dK and dV accumulators stay in registers. Causal runs start at
// the first q-tile that reaches the diagonal (the skip at :174).
//
// Bound on this card: 8 FLOP per kept (query, key) pair and head-dim column
// (S, dP, dV and dK products) against reading q, k, v, dO once: at GPT-2's
// s = 1024 that is far above the H100's 20 FLOP/byte fp32 balance point, so
// it is bound by operations, here plain f32 FMAs (no TF32, the reference
// runs at "highest" precision). Design against it: register micro-tiles
// fed by 4-wide, bank-conflict-free shared reads, P and dS shared through
// shared memory so each is computed once per tile, and the causal skip.
// wgmma/TMA come in a later change.
#include "flash_bwd_common.cuh"

namespace {

using namespace flash;

template <typename T, int DP>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ db, int sq,
                     int sk, int d, int causal, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  BwdDkv<T, DP>::run(q, k, v, bias, dout, lse, delta, dk, dv, db, blockIdx.y,
                     blockIdx.x * kBwdOwn, sq, sk, d, causal, sm_scale, smem);
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* dout, const void* lse, const void* delta, void* dk,
           void* dv, void* db, int bn, int sq, int sk, int d, int causal,
           float sm_scale, cudaStream_t stream) {
  const size_t smem = (size_t)BwdDkv<T, DP>::kSmemFloats * sizeof(float);
  auto kern = flash_bwd_dkv_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sk + kBwdOwn - 1) / kBwdOwn, bn);
  kern<<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(db), sq, sk, d, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv,
                                    void* db, int bn, int sq, int sk, int d,
                                    int is_bf16, int causal, float sm_scale,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 4 != 0 || d > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
#define FLASH_BWD_DKV_CASE(DD)                                              \
  case DD:                                                                  \
    return is_bf16                                                          \
               ? launch<__nv_bfloat16, DD>(q, k, v, bias, dout, lse, delta, \
                                           dk, dv, db, bn, sq, sk, d,       \
                                           causal, sm_scale, st)            \
               : launch<float, DD>(q, k, v, bias, dout, lse, delta, dk, dv, \
                                   db, bn, sq, sk, d, causal, sm_scale, st);
  switch ((d + 15) / 16 * 16) {
    FLASH_FOR_EACH_DP(FLASH_BWD_DKV_CASE)
  }
#undef FLASH_BWD_DKV_CASE
  return (int)cudaErrorInvalidValue;
}
