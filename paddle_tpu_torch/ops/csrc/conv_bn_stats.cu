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
// y (M, C) bf16; partial (rows, 2, C) f32 workspace; s, q (C,) f32. K and C
// are multiples of 8 (the tensor maps' row strides are then multiples of 16
// bytes), any M >= 1.
//
// Bound on this card (3.35 TB/s, 989.4 TFLOP/s bf16): bytes at the spike's
// four shapes with K <= 1024 (x read, y written: 30.7 us at (401408, 64,
// 64), 76.8 us at (401408, 64, 256), 38.3 us at (100352, 512, 128), 19.3 us
// at (25088, 1024, 256)), operations at (6144, 2048, 512) (12.9 GFLOP, 13.0
// us). At K = 64 the product is a streaming pass with 4 k16 steps a tile:
// what matters is bytes in flight and an epilogue that hides under the next
// tile's loads; at K = 2048 it is the tensor cores' rate.
//
// Design: the Hopper GEMM shape.
// - Tensor cores: wgmma m64nBNk16 bf16 -> f32 with both operands in shared
//   memory (hopper_tma.cuh): x a K-major A, w an MN-major B read with the
//   transpose flag. A tile is 128 rows x BN columns, two consumer
//   warpgroups of 64 rows each; BN is 64 where C <= 64, else 128 (column
//   blocks of 128 side by side). A 256-wide tile would read x once for C <=
//   256, and at (6144, 2048, 512) 96 such tiles cost the busiest SM as
//   many columns as 192 tiles of 128 (two on 60 SMs); but with 128
//   accumulators a thread it spilled under either register split (40/232,
//   24/240) and took about twice as long on an H100 at the three shapes
//   with C >= 256 as 128-wide blocks, whose second read of x comes from L2
//   (the column blocks of one row block run side by side).
// - Asynchronous copies: a producer warpgroup (one thread issues; registers
//   lowered by setmaxnreg, the consumers' raised) keeps TMA loads of 128 x
//   64 x tiles and 64 x BN w tiles (128-byte swizzle, zeros past M, K and
//   C) in flight through a ring of STAGES slots, completed on mbarriers;
//   consumers free a slot when their wgmma has read it. Where one k-step and
//   one column block cover the whole of w (K <= 64, C <= BN), w is loaded
//   once into each slot and then only x streams.
// - Persistent blocks: one block an SM walks tiles t = blockIdx.x,
//   + gridDim.x, ..., the column blocks of a row block adjacent; the grid
//   is a multiple of the column blocks, so a block keeps one column block
//   for all its tiles. The producer fetches the next tile while the
//   consumers run this tile's epilogue.
// - Epilogue: y is rounded to bf16 into a 128-byte-swizzled staging tile
//   (conflict-free 4-byte stores) and written by TMA stores, which clip at
//   M and C. The column sums come from the f32 accumulator registers in a
//   fixed order: each thread adds its two rows (r, r + 8); the eight lanes
//   g = 0..7 that share a column reduce-scatter it over lane bits 4, 3, 2
//   (pairs g, g ^ 4; then g, g ^ 2; then g, g ^ 1), leaving lane l the
//   warp's sums of columns 2l, 2l + 1 of each 64-column chunk; through
//   shared memory consumer thread i adds value i (s or q of one column) of
//   the four warps of each warpgroup in order, then warpgroup 0 +
//   warpgroup 1, and keeps the block's running sum over its tiles in walk
//   order in a register. Each block writes one partial row (its column
//   block of a (rows, 2, C) workspace, rows = gridDim.x / column blocks); a
//   second grid sums the rows in a fixed order. No float atomics: a rerun
//   gives the same bits. tests/test_torch_conv_bn_order.py emulates this
//   order on the CPU.
#include "hopper_tma.cuh"

#include <cstdint>

namespace {

using namespace hopper;

constexpr int kBM = 128;          // rows of a tile (two warpgroups of 64)
constexpr int kBK = 64;           // depth of a ring slot (128-byte rows)
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreads = 384;     // + the producer warpgroup
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use
constexpr int kABytes = kBM * kBK * 2;
constexpr int kFinalizeThreads = 256;

template <int BN>
struct Tile {
  static constexpr int kBBytes = kBK * BN * 2;        // BN / 64 boxes of 8 KB
  static constexpr int kYBytes = kBM * BN * 2;        // BN / 64 boxes of 16 KB
  static constexpr int kRedBytes = 8 * 2 * BN * 4;    // (warp, s/q, column)
  static constexpr int kFixed = 1024 + kYBytes + kRedBytes + 256;
  static constexpr int kStagesFit = (kSmemMax - kFixed) / (kABytes + kBBytes);
  static constexpr int kStages = kStagesFit > 8 ? 8 : kStagesFit;
  static constexpr int kSmem = kFixed + kStages * (kABytes + kBBytes);
  static_assert(kStages >= 3, "the ring needs three slots");
  // one (s or q, column) value of a tile for each consumer thread
  static_assert(2 * BN <= kConsumers, "a value a consumer thread");
};

// the lane's two columns of one 64-column chunk: the sum over the warp's
// 16 rows, reduce-scattered (see the note above). v holds 16 values, n =
// 2 jj + e for column 8 jj + 2 (lane % 4) + e of the chunk; the result is in
// v[0], v[1] (columns 2 lane, 2 lane + 1).
__device__ __forceinline__ void reduce_scatter16(float (&v)[16], int lane) {
  const bool b2 = lane & 16, b1 = lane & 8, b0 = lane & 4;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float send = b2 ? v[n] : v[n + 8];
    const float keep = b2 ? v[n + 8] : v[n];
    v[n] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float send = b1 ? v[n] : v[n + 4];
    const float keep = b1 ? v[n + 4] : v[n];
    v[n] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float send = b0 ? v[n] : v[n + 2];
    const float keep = b0 ? v[n + 2] : v[n];
    v[n] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_stats_kernel(const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmw,
                     const __grid_constant__ CUtensorMap tmy,
                     float* __restrict__ partial, int C, int k_steps,
                     int col_blocks, int tiles) {
  using T = Tile<BN>;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sa = smem;                      // S x 16 KB
  unsigned char* sb = sa + S * kABytes;          // S x kBBytes
  unsigned char* sy = sb + S * T::kBBytes;       // kYBytes
  float* red = reinterpret_cast<float*>(sy + T::kYBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(red) + T::kRedBytes);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  // the warpgroup, read from lane 0 so the compiler sees it uniform across
  // the warp (setmaxnreg wants the branch warp-uniform)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);   // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (role == kConsumers / 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    regs_dec<40>();
    if (tid == kConsumers) {
      const bool w_resident = k_steps == 1 && col_blocks == 1;
      int stage = 0, phase = 0, issued = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int rb = t / col_blocks, cb = t % col_blocks;
        for (int ks = 0; ks < k_steps; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          const bool load_w = !w_resident || issued < S;
          mbar_expect_tx(&full[stage],
                         kABytes + (load_w ? T::kBBytes : 0));
          tma_load_2d(sa + stage * kABytes, &tmx, &full[stage], ks * kBK,
                      rb * kBM);
          if (load_w) {
#pragma unroll
            for (int nb = 0; nb < BN / 64; ++nb)
              tma_load_2d(sb + stage * T::kBBytes + nb * 8192, &tmw,
                          &full[stage], cb * BN + nb * 64, ks * kBK);
          }
          ++issued;
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- two consumer warpgroups ----
  regs_inc<232>();
  const int wg = tid / 128;         // rows 64 wg .. of the tile
  const int wi = (tid / 32) % 4;    // warp in the warpgroup: rows 16 wi ..
  const int lane = tid % 32;
  const int g = lane / 4, p = lane % 4;
  const int cb = blockIdx.x % col_blocks;

  float acc[BN / 2];
  float run = 0.f;   // the block's sum of value `tid` (s or q, column)

  int stage = 0, phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int rb = t / col_blocks;
    for (int ks = 0; ks < k_steps; ++ks) {
      mbar_wait(&full[stage], phase);
      const uint64_t da =
          desc_sw128(sa + stage * kABytes + wg * 64 * 128, 16, 1024);
      const uint64_t db = desc_sw128(sb + stage * T::kBBytes, 8192, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        SST<BN>::mma(acc, da + 2 * kk, db + 128 * kk, (ks | kk) != 0);
      wgmma_commit();
      wgmma_wait_all();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    fence_regs<BN / 2>(acc);

    // the staging tile and `red` are free once the previous tile's stores
    // have read the one and every consumer has read the other
    if (tid == 0) bulk_wait_read();
    named_sync(1, kConsumers);
    const int r0 = wg * 64 + wi * 16 + g;   // this thread's rows r0, r0 + 8
#pragma unroll
    for (int ch = 0; ch < BN / 64; ++ch) {
      float vs[16], vq[16];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = ch * 8 + jj;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = acc[4 * j + e], b = acc[4 * j + 2 + e];
          vs[2 * jj + e] = __fadd_rn(a, b);
          vq[2 * jj + e] = __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
        }
        // y, rounded to bf16, into box ch of the staging tile: row r at
        // 128 r, 16-byte chunk jj at jj ^ (r % 8), and r % 8 == g
        unsigned char* box = sy + ch * 16384 + ((jj ^ g) << 4) + 4 * p;
        __nv_bfloat162 lo = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        __nv_bfloat162 hi =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        *reinterpret_cast<__nv_bfloat162*>(box + r0 * 128) = lo;
        *reinterpret_cast<__nv_bfloat162*>(box + (r0 + 8) * 128) = hi;
      }
      reduce_scatter16(vs, lane);
      reduce_scatter16(vq, lane);
      float* rw = red + (wg * 4 + wi) * 2 * BN + ch * 64 + 2 * lane;
      *reinterpret_cast<float2*>(rw) = make_float2(vs[0], vs[1]);
      *reinterpret_cast<float2*>(rw + BN) = make_float2(vq[0], vq[1]);
    }
    fence_async_smem();
    named_sync(1, kConsumers);
    if (tid == 0) {
#pragma unroll
      for (int ch = 0; ch < BN / 64; ++ch)
        if (cb * BN + ch * 64 < C)
          tma_store_2d(&tmy, sy + ch * 16384, cb * BN + ch * 64, rb * kBM);
      bulk_commit();
    }
    // the tile's sums: the warps of each warpgroup in order, then
    // warpgroup 0 + warpgroup 1, added to the block's running sum
    if (tid < 2 * BN) {
      float w0 = red[tid], w1 = red[4 * 2 * BN + tid];
#pragma unroll
      for (int w = 1; w < 4; ++w) {
        w0 = __fadd_rn(w0, red[w * 2 * BN + tid]);
        w1 = __fadd_rn(w1, red[(4 + w) * 2 * BN + tid]);
      }
      run = __fadd_rn(run, __fadd_rn(w0, w1));
    }
  }
  if (tid == 0) bulk_wait();

  // the block's partial row: its column block of row blockIdx.x / col_blocks
  const int which = tid / BN, col = cb * BN + tid % BN;
  if (tid < 2 * BN && col < C)
    partial[((size_t)(blockIdx.x / col_blocks) * 2 + which) * C + col] = run;
}

// s (blockIdx.y == 0) and q (1): each block sums the partial rows of 32
// columns, warp w taking rows w, w + 8, ... in order, then warp 0 adds the 8
// warp sums in warp order.
__global__ void __launch_bounds__(kFinalizeThreads)
conv_bn_stats_finalize(const float* __restrict__ partial, int nparts, int C,
                       float* __restrict__ s, float* __restrict__ q) {
  constexpr int kWarps = kFinalizeThreads / 32;
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

// The launch configuration, the one home of these rules.
struct Config {
  int bn, col_blocks, row_blocks, tiles, grid, rows;
};

Config with_bn(int M, int C, int sms, int bn) {
  Config c;
  c.bn = bn;
  c.col_blocks = (C + bn - 1) / bn;
  c.row_blocks = (M + kBM - 1) / kBM;
  c.tiles = c.row_blocks * c.col_blocks;
  // a multiple of the column blocks, so a block keeps one column block;
  // one block an SM (the ring takes most of its shared memory)
  const int per_col = sms / c.col_blocks > 0 ? sms / c.col_blocks : 1;
  c.rows = c.row_blocks < per_col ? c.row_blocks : per_col;
  c.grid = c.rows * c.col_blocks;
  return c;
}

Config pick_tile(int M, int C, int sms) {
  return with_bn(M, C, sms, C <= 64 ? 64 : 128);
}

template <int BN>
int launch(const void* x, const void* w, void* y, float* partial, float* s,
           float* q, int M, int K, int C, const Config& c,
           cudaStream_t st) {
  CUtensorMap mx, mw, my;
  if (!make_map_bf16(&mx, x, M, K, kBM, kBK) ||
      !make_map_bf16(&mw, w, K, C, kBK, 64) ||
      !make_map_bf16(&my, y, M, C, kBM, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_bn_stats_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<BN>::kSmem);
  if (err != cudaSuccess) return (int)err;
  conv_bn_stats_kernel<BN><<<c.grid, kThreads, Tile<BN>::kSmem, st>>>(
      mx, mw, my, partial, C, (K + kBK - 1) / kBK, c.col_blocks, c.tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 fgrid((C + 31) / 32, 2);
  conv_bn_stats_finalize<<<fgrid, kFinalizeThreads, 0, st>>>(partial, c.rows,
                                                             C, s, q);
  return (int)cudaGetLastError();
}

}  // namespace

// The configuration for (M, K, C) on a card of `sms` SMs: out[0] the tile
// width, out[1] the grid, out[2] the workspace's rows, out[3] the ring's
// slots, out[4] the main kernel's dynamic shared memory. Returns a
// cudaError_t.
extern "C" int conv_bn_stats_config(int M, int K, int C, int sms, int* out) {
  if (M <= 0 || K <= 0 || C <= 0 || K % 8 || C % 8 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const Config c = pick_tile(M, C, sms);
  out[0] = c.bn;
  out[1] = c.grid;
  out[2] = c.rows;
  out[3] = c.bn == 64 ? Tile<64>::kStages : Tile<128>::kStages;
  out[4] = c.bn == 64 ? Tile<64>::kSmem : Tile<128>::kSmem;
  return 0;
}

// Returns a cudaError_t: 0 when both launches were accepted. `partial` is
// (rows, 2, C) f32 with rows as conv_bn_stats_config gives it for `sms`.
extern "C" int conv_bn_stats_launch(const void* x, const void* w, void* y,
                                    void* partial, void* s, void* q, int M,
                                    int K, int C, int sms, int rows,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || C <= 0 || K % 8 || C % 8 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const Config c = pick_tile(M, C, sms);
  if (rows != c.rows) return (int)cudaErrorInvalidValue;
  float* pp = static_cast<float*>(partial);
  float* ps = static_cast<float*>(s);
  float* pq = static_cast<float*>(q);
  return c.bn == 64 ? launch<64>(x, w, y, pp, ps, pq, M, K, C, c, st)
                    : launch<128>(x, w, y, pp, ps, pq, M, K, C, c, st);
}
