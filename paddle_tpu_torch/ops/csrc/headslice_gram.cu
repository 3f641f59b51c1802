// headslice_gram: the Gram matrix mat @ mat^T of one head's (s, d) slice of
// x (b, s, n, d), read in place through x's strides, for Hopper (sm_90a).
//
// Replaces the TPU kernel `kern` of tools/mosaic_repro_headslice.py (its
// pallas_call). That repro asks whether a kernel can take attention tensors
// in their native (batch, seq, heads, head_dim) layout, cutting a
// (1, s, 1, d) block out of the middle `heads` dim and using it as an (s, d)
// matrix; Mosaic could not lower that squeeze, so the JAX flash kernels copy
// q, k and v to (b * heads, s, d) first. Here the slice is only strides: the
// kernel reads x[b, i, head, k] at b * sb + i * ss + head * sn + k * sd and
// never copies it. On the tensor-core body the slice is a TMA tensor map
// over x's four dims (d, n, s, b) whose box is (32, 1, 64, 1): the repro's
// (1, s, 1, d) BlockSpec in hardware.
//
// Which head. The TPU grid runs a (b, head) program for every head, and its
// output block map ignores the head index, so on the sequential grid each
// head overwrites the last one's (b, s, s) block and the last head's Gram
// matrix is what remains. Here only that head writes: the caller passes
// head = n - 1 and no program is launched for the heads whose results the
// TPU discards, so the result is the same (b, s, s) f32 on every run.
//
// Bound on this card (3.35 TB/s; 495 TFLOP/s TF32, 67 fp32 outside the
// tensor cores). The work is 2 b s^2 d FLOPs over b s d * 4 bytes read and
// b s^2 * 4 written, so the output dominates the bytes. At GPT-2's
// attention shape (2, 1024, 12, 64): 268 MFLOP, 8.91 MB, bound by bytes at
// 2.66 us (fp32 FMA 4.01 us, split TF32 three products 1.63 us). At the
// repro's (4, 128, 12, 64): 8.4 MFLOP, 393 kB, 0.117 us by bytes, under a
// launch (~1 us on an H100): there the kernel is a launch and one block's
// chain of loads, split, products, staging and stores.
//
// Design of the tensor-core body (headslice_gram_kernel_tc):
// - Symmetry. G is symmetric, so a block computes one 64 x 64 tile (ti, tj)
//   with ti <= tj, b * T(T + 1) / 2 blocks for T = ceil(s / 64) (the tile
//   list in batch-major, row-major order over the upper triangle), and
//   stores it twice: as itself at (ti, tj) and as its transpose at (tj, ti).
//   A diagonal tile stores its upper half and that half's mirror. So
//   G[i, j] and G[j, i] come from the same accumulator and are bitwise
//   equal, and about half the products of a full walk are done.
// - Loads. One thread issues TMA loads of the two 64-row panels of the
//   slice (one on a diagonal tile), ceil(d / 32) boxes of 64 rows x 32 f32
//   (128 bytes) each, 128-byte swizzled, completed on one mbarrier; rows
//   past s and columns past d arrive as zeros.
// - Products. Split TF32: each loaded value x becomes hi (rounded to TF32,
//   flash_bwd_tc.cuh's tf32::split) in place and lo = x - hi in a second
//   panel at the same offset, and wgmma m64n64k8 TF32 (one warpgroup, both
//   operands K-major in shared memory, the layout TMA left) takes three
//   products a k-step in order, lo_i.hi_j + hi_i.lo_j + hi_i.hi_j, into f32
//   accumulators. One TF32 product misses the repro's 2e-5 tolerance
//   (tests/test_torch_headslice_order.py emulates both). mma.sync with the
//   split in registers gave the same bits and was ~9 % slower on an H100.
// - Stores. The tile and its transpose are staged over the panels as
//   128-byte-swizzled boxes (32 distinct banks for the transpose's scalar
//   stores) and written by TMA stores, which clip at s.
// - Grid. One tile a block, 66.5 KB of shared memory at d = 64, so three
//   blocks an SM: GPT-2's 272 tiles are resident at once (0.69 of a wave,
//   two or three blocks on each SM) and the repro's 12 take 12 SMs
//   (headslice_gram_config reports both). A block moves ~288 KB through
//   shared memory a tile (TMA in, the split, wgmma's operand reads, the
//   staging, TMA out), and that traffic, with each block's chain of
//   dependent phases, is what holds the body at GPT-2's shape; the stores
//   of 8.39 MB are not the limit there. One persistent block an SM, its
//   next tile's loads and this tile's stores in flight under the products,
//   was slower on an H100 (a single warpgroup an SM runs its phases at
//   their latency), and so were stores straight from the accumulators.
//
// What TMA cannot address goes to the SIMT body (headslice_gram_kernel):
// the tensor-core body needs x 16-byte aligned, an inner stride of 1, the
// other three strides positive multiples of 4 elements (16 bytes), s a
// multiple of 4 (the output's row stride, 16 bytes) and d <= 224 (its four
// panels in a block's shared memory). `route` is the one home of that rule.
// The SIMT body computes every output from its own 32 x 32 tile, staging
// 32 rows of each operand, 32 columns of d at a time; each of its 256
// threads sums 4 outputs over d in order with fmaf, so G[i, j] and G[j, i]
// are the same sums and bitwise equal there too.
#include "flash_bwd_tc.cuh"
#include "hopper_tma.cuh"

#include <cstdint>

namespace {

using namespace hopper;

constexpr int kTile = 32;        // SIMT body: a 32 x 32 tile
constexpr int kThreads = 256;

constexpr int kTcTile = 64;      // tensor-core body: a 64 x 64 tile
constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kBoxCols = 32;     // f32 columns of a 128-byte swizzled box
constexpr int kBoxFloats = kTcTile * kBoxCols;  // 8 KB
constexpr int kTcMaxD = 224;  // four panels of d / 32 boxes in 227 KB

__global__ void __launch_bounds__(kThreads)
headslice_gram_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int S, int D, long long sb, long long ss,
                      long long sd, long long head_offset) {
  __shared__ float qi[kTile][kTile + 1];
  __shared__ float kj[kTile][kTile + 1];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const float* xb = x + (long long)blockIdx.z * sb + head_offset;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d0 = 0; d0 < D; d0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile;
      const int gd = d0 + c;
      qi[r][c] = (i0 + r < S && gd < D) ? xb[(i0 + r) * ss + gd * sd] : 0.f;
      kj[r][c] = (j0 + r < S && gd < D) ? xb[(j0 + r) * ss + gd * sd] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kTile; ++c) {
      const float kv = kj[tx][c];
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[m] = fmaf(qi[ty + 8 * m][c], kv, acc[m]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + ty + 8 * m, j = j0 + tx;
    if (i < S && j < S) out[((long long)blockIdx.z * S + i) * S + j] = acc[m];
  }
}

// float index of (row r, column c < 32) of a 64 x 32 box in the 128-byte
// swizzle: the 16-byte chunk c / 4 of row r sits at chunk (c / 4) ^ (r % 8)
__device__ __forceinline__ int swz(int r, int c) {
  return r * kBoxCols + (((c >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// d (64 x 64, f32) (+)= A (64 x 8) . B^T (64 x 8), both TF32 in shared
// memory, K-major (the only major-ness wgmma takes for TF32), 128-byte
// swizzled; accumulate = 0 overwrites d. The tensor cores read the top 19
// bits of each f32 operand.
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__global__ void __launch_bounds__(kTcThreads)
headslice_gram_kernel_tc(const __grid_constant__ CUtensorMap tmx,
                         const __grid_constant__ CUtensorMap tmo, int nt,
                         int nbox, int ksteps, int head) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bar;
  float* base = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // the block's tile: batch-major, then row-major over ti <= tj
  const int per_batch = nt * (nt + 1) / 2;
  const int b = blockIdx.x / per_batch;
  int r = blockIdx.x % per_batch, ti = 0;
  while (r >= nt - ti) {
    r -= nt - ti;
    ++ti;
  }
  const int tj = ti + r;
  const bool diag = ti == tj;
  // the panels of rows ti and tj (one on a diagonal tile) as loaded, then
  // their hi parts in place and their lo parts at the same offsets after
  const int panel = nbox * kBoxFloats;
  const float* hi_a = base;
  const float* hi_b = diag ? base : base + panel;
  float* lo = base + 2 * panel;
  const float* lo_a = lo;
  const float* lo_b = diag ? lo : lo + panel;

  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar, (diag ? 1 : 2) * panel * 4);
    for (int k = 0; k < nbox; ++k) {
      tma_load_4d(base + k * kBoxFloats, &tmx, &bar, k * kBoxCols, head,
                  ti * kTcTile, b);
      if (!diag)
        tma_load_4d(base + panel + k * kBoxFloats, &tmx, &bar, k * kBoxCols,
                    head, tj * kTcTile, b);
    }
  }
  mbar_wait(&bar, 0);

  // x = hi + lo (flash_bwd_tc.cuh's split), once for each loaded value
  const int n = (diag ? 1 : 2) * panel;
  for (int e = 4 * threadIdx.x; e < n; e += 4 * kTcThreads) {
    float4 v = *reinterpret_cast<const float4*>(base + e);
    uint4 h, l;
    flash::tf32::split(v.x, h.x, l.x);
    flash::tf32::split(v.y, h.y, l.y);
    flash::tf32::split(v.z, h.z, l.z);
    flash::tf32::split(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(base + e) = h;
    *reinterpret_cast<uint4*>(lo + e) = l;
  }
  fence_async_smem();
  __syncthreads();

  // three products a k-step, in order: lo_a.hi_b, hi_a.lo_b, hi_a.hi_b
  float acc[32];
  wgmma_fence();
  for (int ks = 0; ks < ksteps; ++ks) {
    const int box = (ks >> 2) * kBoxFloats;
    const uint64_t step = 2 * (ks & 3);   // 32 bytes a k-step, 16-byte units
    const uint64_t dha = desc_sw128(hi_a + box, 16, 1024) + step;
    const uint64_t dhb = desc_sw128(hi_b + box, 16, 1024) + step;
    wgmma_tf32(acc, desc_sw128(lo_a + box, 16, 1024) + step, dhb, ks != 0);
    wgmma_tf32(acc, dha, desc_sw128(lo_b + box, 16, 1024) + step, 1);
    wgmma_tf32(acc, dha, dhb, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<32>(acc);

  // stage the tile (two boxes) and its transpose (two more) over the
  // panels, once every product has read them. Accumulator element i of
  // thread t is (16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2),
  // 8 (i / 4) + 2 (t % 4) + i % 2).
  __syncthreads();
  float* st = base;
  float* stt = diag ? base : base + 2 * kBoxFloats;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int i = r0 + 8 * ((e >> 1) & 1);
    const int j = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
    if (diag && i > j) continue;
    st[(j >> 5) * kBoxFloats + swz(i, j & 31)] = acc[e];
    stt[(i >> 5) * kBoxFloats + swz(j, i & 31)] = acc[e];
  }
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      tma_store_3d(&tmo, st + k * kBoxFloats, tj * kTcTile + k * kBoxCols,
                   ti * kTcTile, b);
      if (!diag)
        tma_store_3d(&tmo, stt + k * kBoxFloats,
                     ti * kTcTile + k * kBoxCols, tj * kTcTile, b);
    }
    bulk_commit();
    bulk_wait_read();
  }
}

// The launch of (B, S, N, D) at x's strides: which body, its tiles and
// grid, and the tensor-core body's dynamic shared memory.
struct Route {
  int body;    // 1 the tensor-core body, 0 the SIMT body
  int tile, tiles, grid, nt, nbox, smem;
};

bool positive_multiple_of_4(long long v) { return v > 0 && v % 4 == 0; }

Route route(int B, int S, int D, long long sb, long long ss, long long sn,
            long long sd, bool x_aligned) {
  Route r{};
  r.body = x_aligned && sd == 1 && positive_multiple_of_4(sn) &&
           positive_multiple_of_4(ss) && positive_multiple_of_4(sb) &&
           S % 4 == 0 && D <= kTcMaxD;
  r.tile = r.body ? kTcTile : kTile;
  r.nt = (S + r.tile - 1) / r.tile;
  r.tiles = B * (r.body ? r.nt * (r.nt + 1) / 2 : r.nt * r.nt);
  r.grid = r.tiles;
  r.nbox = (D + kBoxCols - 1) / kBoxCols;
  // the hi and lo parts of two panels of nbox boxes (room for the four
  // staging boxes), and room to align the start to 1024 bytes (the
  // swizzle's period)
  r.smem = r.body ? 1024 + 4 * r.nbox * kBoxFloats * 4 : 0;
  return r;
}

bool args_ok(int B, int S, int N, int D, int head) {
  return B > 0 && S > 0 && N > 0 && D > 0 && head >= 0 && head < N;
}

int launch_tc(const void* x, void* out, int B, int S, int N, int D,
              long long sb, long long ss, long long sn, int head,
              const Route& r, cudaStream_t st) {
  // x as (d, n, s, b), a box one head wide; out (B, S, S) as (s, s, b)
  const cuuint64_t xdims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)S,
                               (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)sn * 4, (cuuint64_t)ss * 4,
                                  (cuuint64_t)sb * 4};
  const cuuint32_t xbox[4] = {kBoxCols, 1, kTcTile, 1};
  const cuuint64_t odims[3] = {(cuuint64_t)S, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t ostrides[2] = {(cuuint64_t)S * 4,
                                  (cuuint64_t)S * (cuuint64_t)S * 4};
  const cuuint32_t obox[3] = {kBoxCols, kTcTile, 1};
  CUtensorMap mx, mo;
  if (!make_map_f32(&mx, x, 4, xdims, xstrides, xbox) ||
      !make_map_f32(&mo, out, 3, odims, ostrides, obox))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      headslice_gram_kernel_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      r.smem);
  if (err != cudaSuccess) return (int)err;
  headslice_gram_kernel_tc<<<r.grid, kTcThreads, r.smem, st>>>(
      mx, mo, r.nt, r.nbox, (D + 7) / 8, head);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch configuration for x (B, S, N, D) at strides (sb, ss, sn, sd)
// (elements), x_misalign = x's address % 16, on a card of `sms` SMs:
// out[0] the body (1 tensor cores, 0 SIMT), out[1] the tile's rows,
// out[2] the tiles, out[3] the grid, out[4] the blocks an SM can hold,
// out[5] a block's dynamic shared memory. Returns a cudaError_t.
extern "C" int headslice_gram_config(int B, int S, int N, int D,
                                     long long sb, long long ss, long long sn,
                                     long long sd, int x_misalign, int sms,
                                     int* out) {
  if (!args_ok(B, S, N, D, N - 1) || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const Route r = route(B, S, D, sb, ss, sn, sd, x_misalign == 0);
  int per_sm = 0;
  cudaError_t err;
  if (r.body) {
    err = cudaFuncSetAttribute(headslice_gram_kernel_tc,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               r.smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, headslice_gram_kernel_tc, kTcThreads, r.smem);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, headslice_gram_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = r.body;
  out[1] = r.tile;
  out[2] = r.tiles;
  out[3] = r.grid;
  out[4] = per_sm;
  out[5] = r.smem;
  return 0;
}

// Returns a cudaError_t: 0 when the launch was accepted. Strides are in
// elements; `head` selects the slice x[:, :, head, :] (the caller passes
// n - 1); out is (B, S, S) f32, contiguous. The body is `route`'s.
extern "C" int headslice_gram_launch(const void* x, void* out, int B, int S,
                                     int N, int D, long long sb,
                                     long long ss, long long sn,
                                     long long sd, int head, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!args_ok(B, S, N, D, head)) return (int)cudaErrorInvalidValue;
  const Route r = route(B, S, D, sb, ss, sn, sd,
                        reinterpret_cast<uintptr_t>(x) % 16 == 0);
  if (r.body)
    return launch_tc(x, out, B, S, N, D, sb, ss, sn, head, r, st);
  dim3 grid(r.nt, r.nt, B);
  headslice_gram_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(out), S, D, sb, ss,
      sd, (long long)head * sn);
  return (int)cudaGetLastError();
}
