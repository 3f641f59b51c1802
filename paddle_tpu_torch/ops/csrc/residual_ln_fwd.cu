// residual_ln_fwd: out = LayerNorm(x + r) * scale + bias, saving the per-row
// mean and rstd, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fwd_kernel` of tools/spike_residual_ln.py
// (launched by `_fwd_call`), the forward of the spike's fused residual-add +
// LayerNorm: BERT's encoder tail x = LN(x + sublayer_out).
//
// Layout: x, r (M, H) row-major, fp32 or bf16 (the same type); scale, bias
// (H,) f32; out (M, H) in x's type; mu, rstd (M,) f32. All math in f32:
// s = x + r, mu = mean(s), var = mean((s - mu)^2) (two passes over the
// registers, as the TPU kernel does), rstd = rsqrt(var + 1e-5).
//
// Translation. The TPU kernel takes bm = 256 rows a grid step and its grid
// m // bm drops a ragged tail. Here one warp owns one row and holds it in
// registers (3 bf16 pairs a lane at H = 768), so the two reductions are
// warp shuffles with no shared memory and no block barrier; a block runs 8
// rows, the grid ceil(M / 8) blocks, and the warps past the last row exit,
// so any M works.
//
// Bound on this card: bytes. It reads x and r and writes out once (3 * M *
// H * elem bytes, 75.5 MB at (16384, 768) bf16, 22.6 us at 3.35 TB/s)
// against ~8 FLOP a value; the design reads each value once, with
// neighbouring lanes on neighbouring pairs so each warp load is 128 bytes.
#include "residual_ln_common.cuh"

namespace {

using namespace rln;

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
residual_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out,
                       float* __restrict__ mu, float* __restrict__ rstd,
                       int M, int H) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= M) return;
  const int nvec = H / VEC;
  const size_t base = (size_t)row * H;

  float s[NV][VEC];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = lane + 32 * k;
    if (v < nvec) {
      float a[VEC], b[VEC];
      load_vec(x + base + (size_t)v * VEC, a);
      load_vec(r + base + (size_t)v * VEC, b);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[k][i] = a[i] + b[i];
        sum += s[k][i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) s[k][i] = 0.f;
    }
  }
  const float mean = warp_sum(sum) / (float)H;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (lane + 32 * k < nvec) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[k][i] -= mean;
        sq += s[k][i] * s[k][i];
      }
    }
  }
  const float rs = rsqrtf(warp_sum(sq) / (float)H + kEps);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = lane + 32 * k;
    if (v < nvec) {
      float sc[VEC], bi[VEC], o[VEC];
      load_vec(scale + v * VEC, sc);
      load_vec(bias + v * VEC, bi);
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = s[k][i] * rs * sc[i] + bi[i];
      store_vec(out + base + (size_t)v * VEC, o);
    }
  }
  if (lane == 0) {
    mu[row] = mean;
    rstd[row] = rs;
  }
}

template <typename T, int VEC, int NV>
int launch(const void* x, const void* r, const void* scale, const void* bias,
           void* out, void* mu, void* rstd, int M, int H,
           cudaStream_t stream) {
  const int blocks = (M + kWarps - 1) / kWarps;
  residual_ln_fwd_kernel<T, VEC, NV><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<float*>(mu),
      static_cast<float*>(rstd), M, H);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int dispatch(const void* x, const void* r, const void* scale,
             const void* bias, void* out, void* mu, void* rstd, int M, int H,
             cudaStream_t stream) {
  const int nvec = H / VEC;
#define RLN_FWD_CASE(N)                                                   \
  if (32 * (N) >= nvec)                                                   \
    return launch<T, VEC, N>(x, r, scale, bias, out, mu, rstd, M, H, stream);
  RLN_FOR_EACH_NV(RLN_FWD_CASE)
#undef RLN_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted. H even takes the
// pair loads (H <= 2048), H odd single values (H <= 1023).
extern "C" int residual_ln_fwd_launch(const void* x, const void* r,
                                      const void* scale, const void* bias,
                                      void* out, void* mu, void* rstd, int M,
                                      int H, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (H % 2 == 0)
    return is_bf16 ? dispatch<__nv_bfloat16, 2>(x, r, scale, bias, out, mu,
                                                rstd, M, H, st)
                   : dispatch<float, 2>(x, r, scale, bias, out, mu, rstd, M,
                                        H, st);
  return is_bf16 ? dispatch<__nv_bfloat16, 1>(x, r, scale, bias, out, mu,
                                              rstd, M, H, st)
                 : dispatch<float, 1>(x, r, scale, bias, out, mu, rstd, M, H,
                                      st);
}
