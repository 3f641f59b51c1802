// Shared helpers of the fused residual + LayerNorm kernels
// (residual_ln_fwd.cu, residual_ln_bwd.cu): one warp owns one row of H
// values and keeps it in registers, VEC neighbouring values a load (a
// float2 or an __nv_bfloat162 pair when H is even, so every row starts on
// a pair boundary; one value otherwise), lane l holding the vectors
// l, l + 32, l + 64, ... of the row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rln {

constexpr float kEps = 1e-5f;   // tools/spike_residual_ln.py EPS
constexpr int kWarps = 8;       // warps (rows in flight) of a block
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ void load_vec(const float* p, float (&o)[1]) {
  o[0] = *p;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&o)[1]) {
  o[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void load_vec(const float* p, float (&o)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&o)[2]) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = v.x;
  o[1] = v.y;
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[1]) {
  *p = v[0];
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Vectors a lane holds: NV, the smallest of these with 32 * NV >= H / VEC.
// With VEC = 2 that covers H <= 2048, with VEC = 1 (odd H) H <= 1023.
constexpr int kMaxVecsPerLane = 32;
#define RLN_FOR_EACH_NV(X) X(1) X(2) X(4) X(8) X(12) X(16) X(24) X(32)

}  // namespace rln
