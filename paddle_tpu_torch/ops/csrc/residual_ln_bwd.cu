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
// Bound on this card: bytes. It reads x, r, g and writes ds once (4 * M * H
// * elem bytes, 100.7 MB at (16384, 768) bf16, 30.1 us at 3.35 TB/s); the
// partial rows add 2 * 2 * nblocks * H * 4 bytes. Reaching it takes some
// 25 KB of loads in flight on each SM, and few instructions a byte.
//
// Design. One warp owns one row at a time, lane l holding the vectors l,
// l + 32, ... of VEC values: 16 bytes (8 bf16 or 4 fp32) where H allows it
// (H % 8 == 0 in bf16, H % 4 == 0 in fp32), else a pair (even H) or one
// value (odd H). Where a row's x, r and g take at most 48 registers a
// lane (H <= 1024 in bf16 and H <= 512 in fp32 on 16-byte vectors), the
// warp loads row i + gridDim.x * 8's x, r, g, mu and rstd into registers
// before it reduces and stores row i, so two rows of every warp are in
// flight. dscale and dbias are summed per warp in shared memory
// (each lane its own columns, in the warp's row order), which keeps the
// registers for the prefetch and lets two or more blocks of 8 warps share
// an SM (the grid: that occupancy times the SMs, from
// residual_ln_bwd_config, capped by M / 8). The block adds its warps' sums
// in warp order into one (2, H) partial row; a second grid sums the partial
// rows in a fixed order. No float atomics: a rerun gives the same bits.
// The rows a warp takes (blockIdx.x * 8 + warp, + 8 gridDim.x, ...) and the
// grid fix the order of every sum; tests/test_torch_residual_ln_order.py
// emulates it on the CPU.
#include "residual_ln_common.cuh"

namespace {

using namespace rln;

// VEC values of type T as 32-bit words (a bf16 single in the low half)
template <typename T, int VEC>
struct Vec {
  static constexpr int kBytes = (int)sizeof(T) * VEC;
  static constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;

  static __device__ __forceinline__ void load(const T* p,
                                              uint32_t (&w)[kWords]) {
    if constexpr (kBytes == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if constexpr (kBytes == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
    } else if constexpr (kBytes == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }

  static __device__ __forceinline__ void unpack(const uint32_t (&w)[kWords],
                                                float (&o)[VEC]) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = __uint_as_float(w[i]);
    } else if constexpr (VEC == 1) {
      o[0] = __uint_as_float(w[0] << 16);
    } else {
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) {
        o[2 * i] = __uint_as_float(w[i] << 16);
        o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }

  static __device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
    if constexpr (sizeof(T) == 4) {
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      else if constexpr (VEC == 2)
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
      else
        *reinterpret_cast<float*>(p) = v[0];
    } else if constexpr (VEC == 1) {
      *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(v[0]);
    } else {
      uint32_t w[VEC / 2];
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) {
        __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<uint32_t*>(&h);
      }
      if constexpr (VEC == 8)
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
      else if constexpr (VEC == 4)
        *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<uint32_t*>(p) = w[0];
    }
  }
};

// VEC floats of shared memory at p (aligned to 4 VEC bytes): read, and add
template <int VEC>
__device__ __forceinline__ void smem_read(const float* p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x, v[i + 1] = t.y, v[i + 2] = t.z, v[i + 3] = t.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}
template <int VEC>
__device__ __forceinline__ void smem_add(float* p, const float (&a)[VEC]) {
  float v[VEC];
  smem_read<VEC>(p, v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] += a[i];
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// A row's x, r, g (NV vectors a lane) and its mu, rstd.
template <typename T, int VEC, int NV>
struct Row {
  using V = Vec<T, VEC>;
  uint32_t x[NV][V::kWords], r[NV][V::kWords], g[NV][V::kWords];
  float mu, rstd;

  __device__ __forceinline__ void load(const T* px, const T* pr, const T* pg,
                                       const float* pmu, const float* prs,
                                       int row, int H, int lane) {
    const size_t base = (size_t)row * H;
    const int nvec = H / VEC;
    mu = pmu[row];
    rstd = prs[row];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = lane + 32 * k;
      if (v < nvec) {
        V::load(px + base + (size_t)v * VEC, x[k]);
        V::load(pr + base + (size_t)v * VEC, r[k]);
        V::load(pg + base + (size_t)v * VEC, g[k]);
      }
    }
  }
};

// Registers of x, r and g a lane holds for one row, and the most for which
// the next row is prefetched.
template <typename T, int VEC, int NV>
__host__ __device__ constexpr bool prefetches() {
  return 3 * NV * Vec<T, VEC>::kWords <= 48;
}

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads, 2)
residual_ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                       const float* __restrict__ scale,
                       const float* __restrict__ mu,
                       const float* __restrict__ rstd,
                       const T* __restrict__ g, T* __restrict__ ds,
                       float* __restrict__ partial, int M, int H) {
  constexpr bool kPrefetch = prefetches<T, VEC, NV>();
  using V = Vec<T, VEC>;
  // kWarps x (dscale, dbias) sums of H each, then scale
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nvec = H / VEC;
  float* acc_sc = sm + warp * 2 * H;
  float* acc_b = acc_sc + H;
  float* ssc = sm + kWarps * 2 * H;
  for (int c = lane; c < 2 * H; c += 32) acc_sc[c] = 0.f;
  for (int c = threadIdx.x; c < H; c += kThreads) ssc[c] = scale[c];
  __syncthreads();

  const int stride = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  Row<T, VEC, NV> cur;
  if (kPrefetch && first < M) cur.load(x, r, g, mu, rstd, first, H, lane);
  for (int row = first; row < M; row += stride) {
    Row<T, VEC, NV> nxt;
    if constexpr (kPrefetch) {
      if (row + stride < M)
        nxt.load(x, r, g, mu, rstd, row + stride, H, lane);
    } else {
      cur.load(x, r, g, mu, rstd, row, H, lane);
    }
    const float m = cur.mu, rs = cur.rstd;
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = lane + 32 * k;
      if (v < nvec) {
        float a[VEC], b[VEC], gg[VEC], sc[VEC], gx[VEC];
        V::unpack(cur.x[k], a);
        V::unpack(cur.r[k], b);
        V::unpack(cur.g[k], gg);
        smem_read<VEC>(ssc + v * VEC, sc);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xhat = (a[i] + b[i] - m) * rs;
          const float gs = gg[i] * sc[i];
          m1 += gs;
          m2 += gs * xhat;
          gx[i] = __fmul_rn(gg[i], xhat);   // rounded before the sum (no FMA)
        }
        smem_add<VEC>(acc_sc + v * VEC, gx);
        smem_add<VEC>(acc_b + v * VEC, gg);
      }
    }
    m1 = warp_sum(m1) / (float)H;
    m2 = warp_sum(m2) / (float)H;
    const size_t base = (size_t)row * H;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = lane + 32 * k;
      if (v < nvec) {
        float a[VEC], b[VEC], gg[VEC], sc[VEC], o[VEC];
        V::unpack(cur.x[k], a);
        V::unpack(cur.r[k], b);
        V::unpack(cur.g[k], gg);
        smem_read<VEC>(ssc + v * VEC, sc);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xhat = (a[i] + b[i] - m) * rs;
          o[i] = (gg[i] * sc[i] - m1 - xhat * m2) * rs;
        }
        V::store(ds + base + (size_t)v * VEC, o);
      }
    }
    if constexpr (kPrefetch) cur = nxt;
  }
  __syncthreads();

  // the block's column sums, warp 0 + warp 1 + ... in that order
  float* out = partial + (size_t)blockIdx.x * 2 * H;
  for (int c = threadIdx.x; c < 2 * H; c += kThreads) {
    float t = sm[c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += sm[w * 2 * H + c];
    out[c] = t;
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

int smem_bytes(int H) { return (2 * kWarps + 1) * H * (int)sizeof(float); }

// The kernel for (T, VEC, NV), its shared memory allowed: what the launch
// and the configuration query share.
template <typename T, int VEC, int NV>
const void* kernel_for(int H) {
  auto k = residual_ln_bwd_kernel<T, VEC, NV>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_bytes(H));
  return reinterpret_cast<const void*>(k);
}

// The two launches of the build (T, VEC, NV) on the caller's arguments.
struct Launch {
  const void *x, *r, *scale, *mu, *rstd, *g;
  void *ds, *partial, *dscale, *dbias;
  int M, H, nblocks;
  cudaStream_t stream;

  template <typename T, int VEC, int NV>
  int run() const {
    kernel_for<T, VEC, NV>(H);
    residual_ln_bwd_kernel<T, VEC, NV>
        <<<nblocks, kThreads, smem_bytes(H), stream>>>(
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
};

// The build's kernel, for the configuration query.
struct Query {
  int H;
  const void** kernel;

  template <typename T, int VEC, int NV>
  int run() const {
    *kernel = kernel_for<T, VEC, NV>(H);
    return 0;
  }
};

// Vectors a lane holds, with the one before it in the list: a build N is
// made only where some H within the limits needs it (32 PREV vectors of
// VEC values fall short of the largest H).
#define RLN_BWD_FOR_EACH_NV(X)                                         \
  X(1, 0) X(2, 1) X(3, 2) X(4, 3) X(6, 4) X(8, 6) X(12, 8) X(16, 12) \
  X(24, 16) X(32, 24)
constexpr int kMaxH = 2 * 32 * kMaxVecsPerLane;   // 2048

// fn.run<T, VEC, NV>() for the fewest vectors a lane that cover a row of H;
// cudaErrorInvalidValue where none does (odd H > 1023).
template <typename T, int VEC, typename F>
int with_nv(int H, const F& fn) {
  const int nvec = H / VEC;
#define RLN_BWD_CASE(N, PREV)                 \
  if constexpr (32 * (PREV)*VEC < kMaxH) {    \
    if (32 * (N) >= nvec)                     \
      return fn.template run<T, VEC, N>();    \
  }
  RLN_BWD_FOR_EACH_NV(RLN_BWD_CASE)
#undef RLN_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

// The build for (H, dtype): the widest vector H allows.
template <typename F>
int with_build(int H, int is_bf16, const F& fn) {
  if (H <= 0 || H > kMaxH) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (H % 8 == 0) return with_nv<__nv_bfloat16, 8>(H, fn);
    if (H % 2 == 0) return with_nv<__nv_bfloat16, 2>(H, fn);
    return with_nv<__nv_bfloat16, 1>(H, fn);
  }
  if (H % 4 == 0) return with_nv<float, 4>(H, fn);
  if (H % 2 == 0) return with_nv<float, 2>(H, fn);
  return with_nv<float, 1>(H, fn);
}

}  // namespace

// The backward's grid for (M, H, dtype) on the current card of `sms` SMs,
// also the rows of the partial workspace: the blocks of 8 warps an SM
// holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor) times the SMs, no
// more than M / 8 rounded up, in out[0]. Returns a cudaError_t.
extern "C" int residual_ln_bwd_config(int M, int H, int is_bf16, int sms,
                                      int* out) {
  if (M <= 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  const void* kernel = nullptr;
  const int err = with_build(H, is_bf16, Query{H, &kernel});
  if (err) return err;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem_bytes(H));
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int rows8 = (M + kWarps - 1) / kWarps;
  out[0] = rows8 < per_sm * sms ? rows8 : per_sm * sms;
  return 0;
}

// Returns a cudaError_t: 0 when both launches were accepted. `partial` is
// (nblocks, 2, H) f32 and nblocks the main grid's size (1 <= nblocks).
extern "C" int residual_ln_bwd_launch(const void* x, const void* r,
                                      const void* scale, const void* mu,
                                      const void* rstd, const void* g,
                                      void* ds, void* partial, void* dscale,
                                      void* dbias, int M, int H, int nblocks,
                                      int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || nblocks <= 0) return (int)cudaErrorInvalidValue;
  return with_build(H, is_bf16,
                    Launch{x, r, scale, mu, rstd, g, ds, partial, dscale,
                           dbias, M, H, nblocks, st});
}
