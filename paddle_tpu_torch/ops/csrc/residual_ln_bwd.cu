// residual_ln_bwd: the recompute-backward of out = LayerNorm(x + r) * scale
// + bias, for Hopper (sm_90a).
//
// Replaces the TPU kernel `bwd_kernel` of tools/spike_residual_ln.py
// (launched by `bwd_rule`). Per row, from the saved mu and rstd and the
// recomputed s = x + r (no saved activation):
//   xhat = (s - mu) * rstd,  gs = g * scale,
//   ds = (gs - mean(gs) - xhat * mean(gs * xhat)) * rstd     (x's type)
// and over all rows dscale = sum(g * xhat), dbias = sum(g)  (f32). The
// residual add hands ds to both x and r.
//
// Layout: x, r, g, ds (M, H) fp32 or bf16 (one type); scale (H,) f32; mu,
// rstd (M,) f32; partial (nblocks, 2, H) f32 workspace; dscale, dbias (H,)
// f32.
//
// Translation. The TPU kernel accumulates dscale and dbias in VMEM across
// its sequential grid. Blocks run in parallel here, so there is no carry
// and no float atomics: each block's 8 warps walk rows blockIdx.x * 8 +
// warp, + 8 * gridDim.x, ..., one row a warp at a time held in registers,
// each lane summing its own columns of g * xhat and g in registers; the
// block then adds its warps' sums in warp order through shared memory and
// writes one (2, H) partial row. A second grid sums the partial rows in
// row order. Every sum has a fixed order, so a rerun gives the same bits.
// The caller sizes the grid, two blocks an SM (capped by M / 8), which
// keeps the workspace at (264, 2, H) on 132 SMs, 1.6 MB at H = 768, where
// a block per 8 rows would need 100 MB at M = 131072.
//
// Bound on this card: bytes. It reads x, r, g and writes ds once (4 * M * H
// * elem bytes, 100.7 MB at (16384, 768) bf16, 30.1 us at 3.35 TB/s); the
// partial rows add 2 * 2 * nblocks * H * 4 bytes (3.2 MB there).
#include "residual_ln_common.cuh"

namespace {

using namespace rln;

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
residual_ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                       const float* __restrict__ scale,
                       const float* __restrict__ mu,
                       const float* __restrict__ rstd,
                       const T* __restrict__ g, T* __restrict__ ds,
                       float* __restrict__ partial, int M, int H) {
  __shared__ float red[2 * 32 * kMaxVecsPerLane * 2];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nvec = H / VEC;

  float acc_sc[NV][VEC], acc_b[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc_sc[k][i] = acc_b[k][i] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < M;
       row += gridDim.x * kWarps) {
    const size_t base = (size_t)row * H;
    const float m = mu[row];
    const float rs = rstd[row];
    float xhat[NV][VEC], gg[NV][VEC];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = lane + 32 * k;
      if (v < nvec) {
        float a[VEC], b[VEC], sc[VEC];
        load_vec(x + base + (size_t)v * VEC, a);
        load_vec(r + base + (size_t)v * VEC, b);
        load_vec(g + base + (size_t)v * VEC, gg[k]);
        load_vec(scale + v * VEC, sc);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          xhat[k][i] = (a[i] + b[i] - m) * rs;
          const float gs = gg[k][i] * sc[i];
          m1 += gs;
          m2 += gs * xhat[k][i];
          acc_sc[k][i] += gg[k][i] * xhat[k][i];
          acc_b[k][i] += gg[k][i];
        }
      }
    }
    m1 = warp_sum(m1) / (float)H;
    m2 = warp_sum(m2) / (float)H;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = lane + 32 * k;
      if (v < nvec) {
        float sc[VEC], o[VEC];
        load_vec(scale + v * VEC, sc);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          o[i] = (gg[k][i] * sc[i] - m1 - xhat[k][i] * m2) * rs;
        store_vec(ds + base + (size_t)v * VEC, o);
      }
    }
  }

  // the block's column sums, warp 0 + warp 1 + ... in that order; the last
  // warp writes the block's partial row
  float* out = partial + (size_t)blockIdx.x * 2 * H;
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = lane + 32 * k;
        if (v < nvec) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const int c = v * VEC + i;
            float a = acc_sc[k][i], b = acc_b[k][i];
            if (w > 0) {
              a += red[c];
              b += red[H + c];
            }
            if (w < kWarps - 1) {
              red[c] = a;
              red[H + c] = b;
            } else {
              out[c] = a;
              out[H + c] = b;
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

// dscale (blockIdx.y == 0) and dbias (1): each block sums the partial rows
// of 32 columns, warp w taking rows w, w + 8, ... in order, then warp 0
// adds the 8 warp sums in warp order.
__global__ void __launch_bounds__(kThreads)
residual_ln_bwd_finalize(const float* __restrict__ partial, int nparts,
                         int H, float* __restrict__ dscale,
                         float* __restrict__ dbias) {
  __shared__ float red[kWarps][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = blockIdx.x * 32 + lane;
  const int which = blockIdx.y;
  float acc = 0.f;
  if (col < H)
    for (int p = warp; p < nparts; p += kWarps)
      acc += partial[((size_t)p * 2 + which) * H + col];
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < H) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][lane];
    (which == 0 ? dscale : dbias)[col] = t;
  }
}

template <typename T, int VEC, int NV>
int launch(const void* x, const void* r, const void* scale, const void* mu,
           const void* rstd, const void* g, void* ds, void* partial,
           void* dscale, void* dbias, int M, int H, int nblocks,
           cudaStream_t stream) {
  residual_ln_bwd_kernel<T, VEC, NV><<<nblocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const float*>(scale), static_cast<const float*>(mu),
      static_cast<const float*>(rstd), static_cast<const T*>(g),
      static_cast<T*>(ds), static_cast<float*>(partial), M, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H + 31) / 32, 2);
  residual_ln_bwd_finalize<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), nblocks, H,
      static_cast<float*>(dscale), static_cast<float*>(dbias));
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int dispatch(const void* x, const void* r, const void* scale, const void* mu,
             const void* rstd, const void* g, void* ds, void* partial,
             void* dscale, void* dbias, int M, int H, int nblocks,
             cudaStream_t stream) {
  const int nvec = H / VEC;
#define RLN_BWD_CASE(N)                                                    \
  if (32 * (N) >= nvec)                                                    \
    return launch<T, VEC, N>(x, r, scale, mu, rstd, g, ds, partial, dscale, \
                             dbias, M, H, nblocks, stream);
  RLN_FOR_EACH_NV(RLN_BWD_CASE)
#undef RLN_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns a cudaError_t: 0 when both launches were accepted. `partial` is
// (nblocks, 2, H) f32 and nblocks the main grid's size (1 <= nblocks).
extern "C" int residual_ln_bwd_launch(const void* x, const void* r,
                                      const void* scale, const void* mu,
                                      const void* rstd, const void* g,
                                      void* ds, void* partial, void* dscale,
                                      void* dbias, int M, int H, int nblocks,
                                      int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || H <= 0 || nblocks <= 0 || H > 2 * 32 * kMaxVecsPerLane)
    return (int)cudaErrorInvalidValue;
  if (H % 2 == 0)
    return is_bf16
               ? dispatch<__nv_bfloat16, 2>(x, r, scale, mu, rstd, g, ds,
                                            partial, dscale, dbias, M, H,
                                            nblocks, st)
               : dispatch<float, 2>(x, r, scale, mu, rstd, g, ds, partial,
                                    dscale, dbias, M, H, nblocks, st);
  return is_bf16 ? dispatch<__nv_bfloat16, 1>(x, r, scale, mu, rstd, g, ds,
                                              partial, dscale, dbias, M, H,
                                              nblocks, st)
                 : dispatch<float, 1>(x, r, scale, mu, rstd, g, ds, partial,
                                      dscale, dbias, M, H, nblocks, st);
}
