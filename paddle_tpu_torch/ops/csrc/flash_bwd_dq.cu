// flash_bwd_dq: query-owning half of the tiled flash-attention backward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_dq_kernel` of
// paddle_tpu/ops/flash_attention.py (second launch of `_flash_bwd_call`).
// Same function: for each (b*n) row and query row, dQ = scale * dS . K with
// dS = P * (dO . V^T - delta) and P recomputed from q, k and the saved lse.
//
// Layout as flash_bwd_dkv: q, dO (bn, sq, d), k/v (bn, sk, d), fp32 or
// bf16; bias (bn, sk) f32 or null; lse, delta (bn, sq) f32; dQ (bn, sq, d)
// in the input type.
//
// Translation. On the TPU the k-tiles of one q-tile run in order on one core
// and carry dQ in VMEM scratch. Here one block of 256 threads owns 64 query
// rows of one (b*n) row (no atomics), keeps their Q and dO tiles in shared
// memory and loops over the k-tiles up to the causal diagonal, staging K and
// V; the dQ accumulator stays in registers.
//
// Bound on this card: 6 FLOP per kept pair and head-dim column (S, dP and
// dQ products) against reading q, k, v, dO once: bound by operations, with
// plain f32 FMAs. Design against it as in flash_bwd_dkv: register
// micro-tiles fed by 4-wide shared reads, dS shared through shared memory
// (transposed, so one 16-byte read gives a thread its 4 rows), and the
// causal cut of the k loop.
#include "flash_bwd_common.cuh"

namespace {

using namespace flash;

template <typename T, int DP>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, int d, int causal, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  BwdDq<T, DP>::run(q, k, v, bias, dout, lse, delta, dq, blockIdx.y,
                    blockIdx.x * kBwdOwn, sq, sk, d, causal, sm_scale, smem);
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* dout, const void* lse, const void* delta, void* dq,
           int bn, int sq, int sk, int d, int causal, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = (size_t)BwdDq<T, DP>::kSmemFloats * sizeof(float);
  auto kern = flash_bwd_dq_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBwdOwn - 1) / kBwdOwn, bn);
  kern<<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), sq, sk, d,
      causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dq, int bn,
                                   int sq, int sk, int d, int is_bf16,
                                   int causal, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 4 != 0 || d > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
#define FLASH_BWD_DQ_CASE(DD)                                               \
  case DD:                                                                  \
    return is_bf16                                                          \
               ? launch<__nv_bfloat16, DD>(q, k, v, bias, dout, lse, delta, \
                                           dq, bn, sq, sk, d, causal,       \
                                           sm_scale, st)                    \
               : launch<float, DD>(q, k, v, bias, dout, lse, delta, dq, bn, \
                                   sq, sk, d, causal, sm_scale, st);
  switch ((d + 15) / 16 * 16) {
    FLASH_FOR_EACH_DP(FLASH_BWD_DQ_CASE)
  }
#undef FLASH_BWD_DQ_CASE
  return (int)cudaErrorInvalidValue;
}
