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
// and carry dQ in VMEM scratch. Here one block owns 64 query rows of one
// (b*n) row (no atomics), keeps their Q and dO tiles in shared memory and
// loops over the k-tiles up to the causal diagonal, staging K and V; the dQ
// accumulator stays in registers.
//
// Bound on this card: 6 FLOP per kept pair and head-dim column (S, dP and
// dQ products) against reading q, k, v, dO once: bound by operations. Two
// bodies, picked by the launch as in flash_bwd_dkv:
//
//  * fp32 with DP <= 64: the tensor cores at fp32 accuracy (three TF32
//    mma.sync products of split operands, K/V/bias double-buffered by
//    cp.async, P on the SFU; flash_bwd_tc.cuh, tf32::query_block). The grid
//    puts the q-tile on its slow dimension, the last q-tile first: under
//    the causal mask q-tile t walks t + 1 k-tiles, so the first wave takes
//    the heaviest blocks. Kernel: flash_bwd_dq_kernel_tc.
//  * bf16, and fp32 with DP > 64: flash_bwd_common.cuh's register-tiled f32
//    FMA body BwdDq (dS shared through shared memory, transposed). Kernel:
//    flash_bwd_dq_kernel.
#include <type_traits>

#include "flash_bwd_common.cuh"
#include "flash_bwd_tc.cuh"

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

// grid (bn, q-tiles): blockIdx.x the (b*n) row, blockIdx.y counts q-tiles
// from the last (the heaviest under the causal mask)
template <int DP>
__global__ void __launch_bounds__(tf32::NT, 2)
flash_bwd_dq_kernel_tc(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ bias,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dq, int sq, int sk, int d,
                       int causal, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  const int tile = gridDim.y - 1 - blockIdx.y;
  tf32::query_block<DP>(q, k, v, bias, dout, lse, delta, dq, blockIdx.x,
                        tile * tf32::OWN, sq, sk, d, causal, sm_scale, smem);
}

template <typename T, int DP>
constexpr bool kTensorCores = std::is_same<T, float>::value &&
                              DP <= tf32::kMaxDP;

// The body a launch at (T, DP) runs, handed to fn as (kernel, grid,
// threads, dynamic shared memory bytes).
template <typename T, int DP, typename Fn>
int with_body(int bn, int sq, Fn fn) {
  if constexpr (kTensorCores<T, DP>)
    return fn(flash_bwd_dq_kernel_tc<DP>,
              dim3(bn, (sq + tf32::OWN - 1) / tf32::OWN), tf32::NT,
              tf32::Smem<DP>::kBytes);
  else
    return fn(flash_bwd_dq_kernel<T, DP>,
              dim3((sq + kBwdOwn - 1) / kBwdOwn, bn), kBwdThreads,
              (size_t)BwdDq<T, DP>::kSmemFloats * sizeof(float));
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* dout, const void* lse, const void* delta, void* dq,
           int bn, int sq, int sk, int d, int causal, float sm_scale,
           cudaStream_t stream) {
  return with_body<T, DP>(bn, sq, [&](auto kern, dim3 grid, int threads,
                                      size_t smem) {
    return launch_kernel(
        kern, grid, threads, smem, stream, static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), sq, sk, d, causal, sm_scale);
  });
}

// Blocks an SM holds of the body at (T, DP); sets *tensor_cores to
// whether that body is the tensor-core one.
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

// Blocks of the kernel that a launch at head dim d runs that fit on one
// SM, or minus a cudaError_t; *tensor_cores is set to 1 where that kernel
// is the tensor-core body (flash_bwd_dq_kernel_tc), else 0.
extern "C" int flash_bwd_dq_blocks_per_sm(int d, int is_bf16,
                                          int* tensor_cores) {
  if (d <= 0 || d % 4 != 0 || d > kMaxHeadDim)
    return -(int)cudaErrorInvalidValue;
#define FLASH_BWD_DQ_QUERY(DD)                                              \
  case DD:                                                                  \
    return is_bf16 ? query<__nv_bfloat16, DD>(tensor_cores)                 \
                   : query<float, DD>(tensor_cores);
  switch ((d + 15) / 16 * 16) {
    FLASH_FOR_EACH_DP(FLASH_BWD_DQ_QUERY)
  }
#undef FLASH_BWD_DQ_QUERY
  return -(int)cudaErrorInvalidValue;
}
