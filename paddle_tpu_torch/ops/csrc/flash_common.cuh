// Shared helpers of the flash-attention kernels (flash_fwd.cu,
// flash_small_fwd.cu and, through flash_bwd_common.cuh, the backward
// kernels): typed 4-wide loads and stores between device memory (fp32 or
// bf16) and f32 registers / shared memory, and the 16-lane reductions that
// combine a score row held by 16 threads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

// Masked score: large negative, not -inf, so a row whose every key is
// masked still gives a finite answer (paddle_tpu _NEG_INF = -1e30).
constexpr float kNeg = -1e30f;

// The masked score of the tensor-core kernels: scale, then the per-key add
// (bias, or 0), then the causal mask (row < col), in the plain version's
// order and with no contraction into an FMA, so that every pass over a
// score computes the same value.
__device__ __forceinline__ float masked_score(float s, float scale,
                                              float add, int row, int col,
                                              int causal) {
  const float x = __fadd_rn(__fmul_rn(s, scale), add);
  return (causal && row < col) ? kNeg : x;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
  __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
  float2 a = __bfloat1622float2(lo);
  float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Copy rows [row0, row0 + ROWS) of a row-major (nrows, d) matrix into
// shared memory as rows of DP floats with stride DP + 4 (the pad keeps
// 16-byte alignment and spreads 4-wide column reads over the banks). DP is
// the head dim rounded up to a multiple of 16; columns d..DP-1 and rows past
// nrows are zero, so padding never feeds garbage into a product.
template <int ROWS, int DP, int NTHREADS, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int nrows, int d, int tid) {
  constexpr int V = DP / 4;
  for (int idx = tid; idx < ROWS * V; idx += NTHREADS) {
    const int r = idx / V;
    const int c = (idx % V) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows && c < d) val = load4(src + (size_t)(row0 + r) * d + c);
    *reinterpret_cast<float4*>(dst + r * (DP + 4) + c) = val;
  }
}

// max / sum over the 16 lanes that share (lane / 16): the 16 threads of one
// row group hold that row's scores between them.
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Output columns of one thread: CPT = DP / 16 columns, in chunks of VEC
// contiguous columns (4, 2 or 1, whichever divides CPT); chunk ch of column
// group cg starts at ch * 16 * VEC + cg * VEC, so the 16 threads of a row
// group read 16 neighbouring VEC-wide pieces of a V row at once.
template <int DP>
struct OutCols {
  static_assert(DP % 16 == 0, "the padded head dim is a multiple of 16");
  static constexpr int CPT = DP / 16;
  static constexpr int VEC = CPT % 4 == 0 ? 4 : (CPT % 2 == 0 ? 2 : 1);
  static constexpr int CHUNKS = CPT / VEC;
  static __device__ __forceinline__ int col(int ch, int cg) {
    return ch * 16 * VEC + cg * VEC;
  }
};

// The padded head dims the kernels are instantiated for: every multiple of
// 16 up to kMaxHeadDim, so any head dim d with d % 4 == 0 runs, padded to
// the next one (the row stores are 4-wide, hence d % 4).
constexpr int kMaxHeadDim = 256;

#define FLASH_FOR_EACH_DP(X)                                                \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176)    \
  X(192) X(208) X(224) X(240) X(256)

// Kernel launch helpers of the flash libraries, whose launches pick one
// of several bodies.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kern, size_t smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launches `kern` with `smem` bytes of dynamic shared memory; a cudaError_t.
template <typename Kernel, typename... Args>
inline int launch_kernel(Kernel kern, dim3 grid, int threads, size_t smem,
                         cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Blocks of `kern` that fit on one SM at `threads` threads and `smem`
// bytes of dynamic shared memory (after allowing that much), or minus a
// cudaError_t.
template <typename Kernel>
inline int blocks_per_sm(Kernel kern, int threads, size_t smem) {
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads,
                                                      smem);
  return err != cudaSuccess ? -(int)err : n;
}

}  // namespace flash
