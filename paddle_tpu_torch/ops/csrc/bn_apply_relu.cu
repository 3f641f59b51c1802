// bn_apply_relu: out = relu(y * scale + shift), per-column scale and shift,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `kern` of `bn_apply_relu` in
// tools/spike_conv_bn.py (its pallas_call): the second pass of train-mode
// batch-norm after conv_bn_stats, normalising y with the batch statistics
// folded into scale = gamma / sqrt(var + eps) and shift = beta - mean * scale
// (computed outside the kernel, as in JAX) and applying the ReLU.
//
// Layout: y, out (M, C) bf16 row-major; scale, shift (C,) f32. The value is
// computed in f32 as (y * scale) + shift, each step rounded as torch's
// elementwise ops round it (no fused multiply-add), and stored in bf16.
//
// Translation. The TPU kernel walks (512, C) row blocks. Here one grid-stride
// pass over the M * C values: when C % 8 == 0 (and the pointers are 16-byte
// aligned, which the caller checks) each step moves 8 values, 16 bytes, with
// one load and one store, and reads the 8 columns' scale and shift as two
// float4 each; otherwise one value a step.
//
// Bound on this card: bytes. y read and out written once: 411 MB at
// (401408, 256), 122.7 us at 3.35 TB/s; 3 operations a value.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float apply(float v, float sc, float sh) {
  return fmaxf(__fadd_rn(__fmul_rn(v, sc), sh), 0.f);
}

__global__ void __launch_bounds__(kThreads)
bn_apply_relu_vec8(const __nv_bfloat16* __restrict__ y,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift,
                   __nv_bfloat16* __restrict__ out, long long chunks, int C) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < chunks; i += stride) {
    const int col = (int)((i * 8) % C);
    const uint4 raw = reinterpret_cast<const uint4*>(y)[i];
    const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
    const float4 sc0 = *reinterpret_cast<const float4*>(scale + col);
    const float4 sc1 = *reinterpret_cast<const float4*>(scale + col + 4);
    const float4 sh0 = *reinterpret_cast<const float4*>(shift + col);
    const float4 sh1 = *reinterpret_cast<const float4*>(shift + col + 4);
    const float sc[8] = {sc0.x, sc0.y, sc0.z, sc0.w,
                         sc1.x, sc1.y, sc1.z, sc1.w};
    const float sh[8] = {sh0.x, sh0.y, sh0.z, sh0.w,
                         sh1.x, sh1.y, sh1.z, sh1.w};
    __align__(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = __float2bfloat16(apply(__bfloat162float(v[e]), sc[e], sh[e]));
    reinterpret_cast<uint4*>(out)[i] = *reinterpret_cast<const uint4*>(o);
  }
}

__global__ void __launch_bounds__(kThreads)
bn_apply_relu_scalar(const __nv_bfloat16* __restrict__ y,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     __nv_bfloat16* __restrict__ out, long long total, int C) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += stride) {
    const int col = (int)(i % C);
    out[i] = __float2bfloat16(
        apply(__bfloat162float(y[i]), scale[col], shift[col]));
  }
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted. `vec8` (C % 8 == 0,
// y, out, scale and shift 16-byte aligned) selects 16-byte steps; `blocks`
// is the grid size.
extern "C" int bn_apply_relu_launch(const void* y, const void* scale,
                                    const void* shift, void* out, int M,
                                    int C, int vec8, int blocks,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || C <= 0 || blocks <= 0 || (vec8 && C % 8))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)M * C;
  if (vec8)
    bn_apply_relu_vec8<<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(y),
        static_cast<const float*>(scale), static_cast<const float*>(shift),
        static_cast<__nv_bfloat16*>(out), total / 8, C);
  else
    bn_apply_relu_scalar<<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(y),
        static_cast<const float*>(scale), static_cast<const float*>(shift),
        static_cast<__nv_bfloat16*>(out), total, C);
  return (int)cudaGetLastError();
}
