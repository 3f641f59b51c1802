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
// and carry dK, dV and db in VMEM scratch. Here one block owns 64 keys of
// one (b*n) row (so dK, dV and db need no atomics), keeps their K and V
// tiles in shared memory and loops over the q-tiles, staging Q and dO; the
// dK and dV accumulators stay in registers. Causal runs start at the first
// q-tile that reaches the diagonal (the skip at :174).
//
// Bound on this card: 8 FLOP per kept (query, key) pair and head-dim column
// (S, dP, dV and dK products) against reading q, k, v, dO once: at GPT-2's
// s = 1024 far above the balance point, so bound by operations. The
// reference runs fp32 at "highest" precision, so TF32 alone is not enough.
// Two bodies, picked by the launch:
//
//  * fp32 with DP <= 64 (GPT-2's training path): the tensor cores at fp32
//    accuracy, each product as three TF32 mma.sync products of split
//    operands, four warps a block, Q/dO/lse/delta double-buffered by
//    cp.async, P on the SFU (flash_bwd_tc.cuh, tf32::key_block); ceiling
//    495 / 3 TFLOP/s. The grid puts the key tile on its slow dimension,
//    tile 0 first: under the causal mask key tile t walks sq/64 - t
//    q-tiles, so the first wave takes the heaviest blocks and the last
//    wave the lightest. Kernel: flash_bwd_dkv_kernel_tc.
//  * bf16, and fp32 with DP > 64: flash_bwd_common.cuh's register-tiled f32
//    FMA body BwdDkv (67 TFLOP/s ceiling), 256 threads, synchronous
//    staging. Kernel: flash_bwd_dkv_kernel.
#include <type_traits>

#include "flash_bwd_common.cuh"
#include "flash_bwd_tc.cuh"

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

// grid (bn, key tiles): blockIdx.x the (b*n) row, blockIdx.y the key tile
template <int DP>
__global__ void __launch_bounds__(tf32::NT, 2)
flash_bwd_dkv_kernel_tc(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ bias,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float* __restrict__ db, int sq, int sk, int d,
                        int causal, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  tf32::key_block<DP>(q, k, v, bias, dout, lse, delta, dk, dv, db,
                      blockIdx.x, blockIdx.y * tf32::OWN, sq, sk, d, causal,
                      sm_scale, smem);
}

template <typename T, int DP>
constexpr bool kTensorCores = std::is_same<T, float>::value &&
                              DP <= tf32::kMaxDP;

// The body a launch at (T, DP) runs, handed to fn as (kernel, grid,
// threads, dynamic shared memory bytes).
template <typename T, int DP, typename Fn>
int with_body(int bn, int sk, Fn fn) {
  if constexpr (kTensorCores<T, DP>)
    return fn(flash_bwd_dkv_kernel_tc<DP>,
              dim3(bn, (sk + tf32::OWN - 1) / tf32::OWN), tf32::NT,
              tf32::Smem<DP>::kBytes);
  else
    return fn(flash_bwd_dkv_kernel<T, DP>,
              dim3((sk + kBwdOwn - 1) / kBwdOwn, bn), kBwdThreads,
              (size_t)BwdDkv<T, DP>::kSmemFloats * sizeof(float));
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* dout, const void* lse, const void* delta, void* dk,
           void* dv, void* db, int bn, int sq, int sk, int d, int causal,
           float sm_scale, cudaStream_t stream) {
  return with_body<T, DP>(bn, sk, [&](auto kern, dim3 grid, int threads,
                                      size_t smem) {
    return launch_kernel(
        kern, grid, threads, smem, stream, static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(db),
        sq, sk, d, causal, sm_scale);
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

// Blocks of the kernel that a launch at head dim d runs that fit on one
// SM, or minus a cudaError_t; *tensor_cores is set to 1 where that kernel
// is the tensor-core body (flash_bwd_dkv_kernel_tc), else 0.
extern "C" int flash_bwd_dkv_blocks_per_sm(int d, int is_bf16,
                                           int* tensor_cores) {
  if (d <= 0 || d % 4 != 0 || d > kMaxHeadDim)
    return -(int)cudaErrorInvalidValue;
#define FLASH_BWD_DKV_QUERY(DD)                                             \
  case DD:                                                                  \
    return is_bf16 ? query<__nv_bfloat16, DD>(tensor_cores)                 \
                   : query<float, DD>(tensor_cores);
  switch ((d + 15) / 16 * 16) {
    FLASH_FOR_EACH_DP(FLASH_BWD_DKV_QUERY)
  }
#undef FLASH_BWD_DKV_QUERY
  return -(int)cudaErrorInvalidValue;
}
