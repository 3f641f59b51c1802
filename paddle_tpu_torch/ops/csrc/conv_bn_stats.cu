// conv_bn_stats: y = x @ w stored in bf16, with the per-column sum and sum of
// squares of the f32 product, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_conv_bn_stats` of tools/spike_conv_bn.py
// (its pallas_call). A ResNet bottleneck's 1x1 conv in NHWC is this product
// over (N*H*W, Cin) rows; the column sums are train-mode batch-norm's
// statistics, taken as the product's epilogue instead of a second pass over
// y. As on the TPU, the sums are of the f32 product, before it is rounded to
// bf16 for the store.
//
// Layout: x (M, K) bf16, w (K, C) bf16, both row-major and 16-byte aligned;
// y (M, C) bf16; partial (row_blocks, 2, C) f32 workspace; s, q (C,) f32.
// K and C are multiples of 8 (one 16-byte load of 8 values never straddles
// the edge), any M >= 1.
//
// Translation. A block computes a 128 x 64 tile of y: 8 warps, each a 32 x 32
// piece as 2 x 2 WMMA 16x16x16 bf16 fragments with f32 accumulators, over K
// in steps of 32 staged in shared memory (zeros past M, K and C). The TPU
// carries the column sums across its sequential grid in VMEM scratch; blocks
// run in parallel here, so there is no carry and no float atomics (PR 3's
// residual_ln_bwd design): the block puts its f32 tile in shared memory,
// stores y from it, and sums each of its columns over its rows in a fixed
// order into one (2, C-slice) row of `partial`; a second grid sums the
// partial rows in row-block order. A rerun gives the same bits.
//
// Bound on this card: bytes at ResNet-50's shapes with K <= 1024 (x read, y
// written: 102.8 MB, 30.7 us at (401408, 64, 64) and 3.35 TB/s), operations
// at (6144, 2048, 512) (12.9 GFLOP, 13.0 us at the 989.4 TFLOP/s bf16 peak).
// This first version loads its tiles synchronously (no cp.async/TMA
// pipeline) and re-reads x once per 64-column block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kBM = 128;       // rows of y a block computes
constexpr int kBN = 64;        // columns of y a block computes
constexpr int kBK = 32;        // depth staged at a time
constexpr int kThreads = 256;  // 8 warps: 4 along M x 2 along N
constexpr int kLdA = kBK + 8;  // padded leading dims (WMMA wants multiples of
constexpr int kLdB = kBN + 8;  // 8 bf16 / 4 f32; the pad spreads the banks)
constexpr int kLdC = kBN + 4;
constexpr int kWarps = kThreads / 32;

// shared memory holds the operand tiles (a: kBM x kLdA, then b: kBK x
// kLdB, bf16) and, after the last product, the f32 result tile (kBM x kLdC)
// over them
constexpr int kOperandBytes = (kBM * kLdA + kBK * kLdB) * 2;
constexpr int kResultBytes = kBM * kLdC * 4;
constexpr int kSmemBytes =
    kOperandBytes > kResultBytes ? kOperandBytes : kResultBytes;

__global__ void __launch_bounds__(kThreads)
conv_bn_stats_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ y,
                     float* __restrict__ partial, int M, int K, int C) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __shared__ float red[4][kBN][2];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + kBM * kLdA;
  float* sc = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int c = tid; c < kBM * kBK / 8; c += kThreads) {
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      const int gr = row0 + r, gk = k0 + kc;
      uint4 v = zero;
      if (gr < M && gk < K)
        v = *reinterpret_cast<const uint4*>(x + (size_t)gr * K + gk);
      *reinterpret_cast<uint4*>(&sa[r * kLdA + kc]) = v;
    }
    for (int c = tid; c < kBK * kBN / 8; c += kThreads) {
      const int r = c / (kBN / 8), nc = (c % (kBN / 8)) * 8;
      const int gk = k0 + r, gn = col0 + nc;
      uint4 v = zero;
      if (gk < K && gn < C)
        v = *reinterpret_cast<const uint4*>(w + (size_t)gk * C + gn);
      *reinterpret_cast<uint4*>(&sb[r * kLdB + nc]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &sa[(wm * 32 + i * 16) * kLdA + kk],
                               kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &sb[kk * kLdB + wn * 32 + j * 16],
                               kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the f32 tile into shared memory (over the operand tiles: every warp is
  // past the last sync of the loop)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          &sc[(wm * 32 + i * 16) * kLdC + wn * 32 + j * 16], acc[i][j],
          kLdC, wmma::mem_row_major);
  __syncthreads();

  // y in bf16, 8 values (16 bytes) a store
  for (int c = tid; c < kBM * kBN / 8; c += kThreads) {
    const int r = c / (kBN / 8), nc = (c % (kBN / 8)) * 8;
    const int gr = row0 + r, gn = col0 + nc;
    if (gr < M && gn < C) {
      __align__(16) __nv_bfloat16 o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = __float2bfloat16(sc[r * kLdC + nc + e]);
      *reinterpret_cast<uint4*>(y + (size_t)gr * C + gn) =
          *reinterpret_cast<const uint4*>(o);
    }
  }

  // column sums of the f32 tile over the block's rows: thread (quarter,
  // column) sums its 32 rows in order, then the four quarters in order
  {
    const int col = tid % kBN, quarter = tid / kBN;
    const int rows = min(kBM, M - row0);
    float s = 0.f, s2 = 0.f;
    for (int r = quarter * 32; r < min(quarter * 32 + 32, rows); ++r) {
      const float v = sc[r * kLdC + col];
      s += v;
      s2 += v * v;
    }
    red[quarter][col][0] = s;
    red[quarter][col][1] = s2;
  }
  __syncthreads();
  if (tid < kBN && col0 + tid < C) {
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int qt = 0; qt < 4; ++qt) {
      s += red[qt][tid][0];
      s2 += red[qt][tid][1];
    }
    partial[((size_t)blockIdx.x * 2 + 0) * C + col0 + tid] = s;
    partial[((size_t)blockIdx.x * 2 + 1) * C + col0 + tid] = s2;
  }
}

// s (blockIdx.y == 0) and q (1): each block sums the partial rows of 32
// columns, warp w taking rows w, w + 8, ... in order, then warp 0 adds the 8
// warp sums in warp order.
__global__ void __launch_bounds__(kThreads)
conv_bn_stats_finalize(const float* __restrict__ partial, int nparts, int C,
                       float* __restrict__ s, float* __restrict__ q) {
  __shared__ float red[kWarps][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = blockIdx.x * 32 + lane;
  const int which = blockIdx.y;
  float acc = 0.f;
  if (col < C)
    for (int p = warp; p < nparts; p += kWarps)
      acc += partial[((size_t)p * 2 + which) * C + col];
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < C) {
    float t = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) t += red[wi][lane];
    (which == 0 ? s : q)[col] = t;
  }
}

}  // namespace

// Returns a cudaError_t: 0 when both launches were accepted. `partial` is
// (row_blocks, 2, C) f32 with row_blocks = ceil(M / 128).
extern "C" int conv_bn_stats_launch(const void* x, const void* w, void* y,
                                    void* partial, void* s, void* q, int M,
                                    int K, int C, int row_blocks,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || C <= 0 || K % 8 || C % 8 ||
      row_blocks != (M + kBM - 1) / kBM)
    return (int)cudaErrorInvalidValue;
  dim3 grid(row_blocks, (C + kBN - 1) / kBN);
  conv_bn_stats_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(partial), M, K, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 fgrid((C + 31) / 32, 2);
  conv_bn_stats_finalize<<<fgrid, kThreads, 0, st>>>(
      static_cast<const float*>(partial), row_blocks, C,
      static_cast<float*>(s), static_cast<float*>(q));
  return (int)cudaGetLastError();
}
