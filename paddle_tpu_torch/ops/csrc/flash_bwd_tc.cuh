// Tensor-core bodies of the tiled flash-attention backward in fp32, for
// Hopper (sm_90a): key_block (dK, dV, db; flash_bwd_dkv.cu) and
// query_block (dQ; flash_bwd_dq.cu), for padded head dims DP <= 64. bf16, larger head
// dims and flash_small_bwd's fp32 path keep the FMA bodies of
// flash_bwd_common.cuh.
//
// Accuracy. The reference runs fp32 at "highest" precision, so one TF32
// product (10 explicit mantissa bits) is not enough. Every product here is
// split: x = hi + lo with hi = x rounded to TF32 (to nearest) and lo =
// x - hi (exact in f32), handed to the tensor cores as it is: they read
// the top 19 bits of a TF32 operand, so lo is truncated, which leaves hi +
// lo within 2^-21 of x. Then a.b = al.bh + ah.bl + ah.bh with f32
// accumulation: three TF32 products a product, so a ceiling of 495 / 3 =
// 165 TFLOP/s against the 67 TFLOP/s of the FMA units
// (tests/test_torch_flash_bwd_split.py emulates it and shows that one
// unsplit TF32 product misses the kernels' tolerance). The split costs
// three ALU operations an element, on the full-rate pipes: an integer add
// and mask for hi, a subtraction for lo. cvt.rna.tf32.f32 gives the same
// hi but runs on a slower pipe, and rounding lo as well adds an operation
// an element that the 2^-21 above does not need (early variants with
// either were slower on an H100; history only, not remeasured).
//
// Why mma.sync and not wgmma. wgmma takes TF32 operands from shared memory
// K-major only (the transpose bits exist for 16-bit types), so dV += P^T.dO
// and dK += dS^T.Q would need transposed images of dO and Q, and the split
// hi and lo images of each: past 190 KB of shared memory at 64-row tiles
// before any second stage. mma.sync.m16n8k8 loads its fragments from one
// f32 image in either orientation, splits them in registers and leaves room
// for a cp.async double buffer at two blocks an SM. With a row stride of
// DP + 4 floats both orientations read distinct banks across a warp.
//
// Fragments (PTX ISA, mma.m16n8k8 .tf32; g = lane / 4, t = lane % 4):
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// The order of k inside one product is free, so a score accumulator is the
// A operand of the next product as it stands: slot t carries column 2t and
// slot t + 4 column 2t + 1 (a = c0, c2, c1, c3), and the B operand reads
// the staged rows 2t and 2t + 1 to match. No score tile goes through shared
// memory.
//
// Each block is four warps; warp w owns rows 16w..16w+15 of the block's 64
// keys (or query rows) and computes their scores against the whole looped
// tile. The looped tile (Q, dO, lse and delta for a key block; K, V and the
// key bias for a query block) is staged by cp.async, double-buffered with
// zero fill past the ragged edge, so the next tile's loads overlap this
// tile's products. P = ex2((s * scale + bias - lse) * log2 e) on the SFU.
// One owner block for each output element, no atomics, db summed in a
// fixed order: every rerun gives the same bits.
#pragma once

#include "flash_common.cuh"
#include "wgmma.cuh"  // cp.async groups, ex2.approx, kLog2e

namespace flash {
namespace tf32 {

constexpr int NT = 128;    // four warps
constexpr int OWN = 64;    // keys or query rows a block owns
constexpr int LT = 64;     // rows of a looped tile
constexpr int kMaxDP = 64; // larger head dims keep the FMA bodies

template <int DP>
struct Smem {
  static constexpr int LD = DP + 4;       // row stride, floats
  static constexpr int kTile = 64 * LD;   // floats of a 64-row tile
  // a stage: two looped tiles and two 64-float vectors (lse and delta of a
  // q-tile, or a k-tile's key bias)
  static constexpr int kStage = 2 * kTile + 2 * LT;
  static constexpr size_t kBytes = (2 * kTile + 2 * (size_t)kStage) * 4;
};

// x = hi + lo: hi rounded to TF32, to nearest with ties away from zero
// (the value cvt.rna.tf32.f32 gives, as an integer add and mask), and lo
// the exact rest, which the tensor cores truncate to TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b from split operands, the small terms first
__device__ __forceinline__ void mma3(float* d, const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

// A fragment of 16 staged rows x 8 columns; x points at row g, column t.
template <int LD>
__device__ __forceinline__ void load_a(const float* x, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(x[0], hi[0], lo[0]);
  split(x[8 * LD], hi[1], lo[1]);
  split(x[4], hi[2], lo[2]);
  split(x[8 * LD + 4], hi[3], lo[3]);
}

// B fragment whose n runs along staged rows and k along columns (K^T of
// S = Q.K^T); x points at row g, column t.
__device__ __forceinline__ void load_b_rows(const float* x, uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  split(x[0], hi[0], lo[0]);
  split(x[4], hi[1], lo[1]);
}

// B fragment whose k runs along staged rows, in the slot order of an
// accumulator used as A (rows 2t and 2t + 1), and n along columns; x
// points at row 2t, column g.
template <int LD>
__device__ __forceinline__ void load_b_cols(const float* x, uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  split(x[0], hi[0], lo[0]);
  split(x[LD], hi[1], lo[1]);
}

// The A operand of 8 columns of an accumulator tile (c0..c3 at acc).
__device__ __forceinline__ void acc_as_a(const float* acc, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(acc[0], hi[0], lo[0]);
  split(acc[2], hi[1], lo[1]);
  split(acc[1], hi[2], lo[2]);
  split(acc[3], hi[3], lo[3]);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// Rows [row0, row0 + 64) of a row-major (nrows, d) f32 matrix into a tile
// of row stride DP + 4, asynchronously; rows past nrows and columns past d
// are zero-filled (d % 4 == 0, so a 16-byte piece is wholly in or out).
template <int DP>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int row0, int nrows, int d,
                                           int tid) {
  constexpr int CH = DP / 4;
  for (int idx = tid; idx < 64 * CH; idx += NT) {
    const int r = idx / CH;
    const int c = 4 * (idx % CH);
    const bool ok = row0 + r < nrows && c < d;
    cp_async16(dst + r * Smem<DP>::LD + c,
               ok ? src + (size_t)(row0 + r) * d + c : src, ok);
  }
}

// 64 floats from src[i0..] (zero past n, or all zero without src).
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int i0, int n, int lane64) {
  if (src == nullptr) {
    dst[lane64] = 0.f;
    return;
  }
  const bool ok = i0 + lane64 < n;
  cp_async4(dst + lane64, ok ? src + i0 + lane64 : src, ok);
}

// An accumulator of 16 rows x DP columns (DP / 2 floats a thread; element
// i at row r0 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2t + (i & 1)) times
// scale into rows of a row-major (nrows, d) f32 output; rows past nrows
// and columns past d are not stored.
template <int DP>
__device__ __forceinline__ void store_acc(float* dst, const float* acc,
                                          float scale, int r0, int nrows,
                                          int d, int t) {
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int row = r0 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * t;
    if (row < nrows && col < d)  // d is even: the pair is wholly in or out
      *reinterpret_cast<float2*>(dst + (size_t)row * d + col) =
          make_float2(acc[i] * scale, acc[i + 1] * scale);
  }
}

// Keys [k0, k0 + 64) of row bh: dK, dV and (with a bias) db. Loops over
// the q-tiles from the first that reaches the causal diagonal.
template <int DP>
__device__ __forceinline__ void key_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ db, int bh, int k0, int sq,
    int sk, int d, int causal, float sm_scale, float* smem) {
  using SM = Smem<DP>;
  constexpr int LD = SM::LD;
  float* ks = smem;
  float* vs = ks + SM::kTile;
  auto qs = [&](int b) { return vs + SM::kTile + b * SM::kStage; };
  auto os = [&](int b) { return qs(b) + SM::kTile; };
  auto lds = [&](int b) { return os(b) + SM::kTile; };  // lse, then delta

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = (tid >> 5) * 16 + g;  // own keys kr, kr + 8 (tile-local)
  const size_t qoff = (size_t)bh * sq * d;
  const size_t koff = (size_t)bh * sk * d;
  float kadd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + kr + 8 * h;
    kadd[h] = (bias != nullptr && key < sk) ? bias[(size_t)bh * sk + key]
                                            : 0.f;
  }

  stage_rows<DP>(ks, k + koff, k0, sk, d, tid);
  stage_rows<DP>(vs, v + koff, k0, sk, d, tid);
  const int t0 = causal ? k0 / LT : 0;  // q-tiles above see no key here
  const int nq = (sq + LT - 1) / LT;
  auto stage = [&](int tt) {
    const int b = tt & 1;
    const int q0 = tt * LT;
    stage_rows<DP>(qs(b), q + qoff, q0, sq, d, tid);
    stage_rows<DP>(os(b), dout + qoff, q0, sq, d, tid);
    if (tid < LT)
      stage_vec(lds(b), lse + (size_t)bh * sq, q0, sq, tid);
    else
      stage_vec(lds(b) + LT, delta + (size_t)bh * sq, q0, sq, tid - LT);
  };
  if (t0 < nq) stage(t0);
  tc::cp_async_commit();

  float adk[DP / 2], adv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) adk[i] = adv[i] = 0.f;
  float dbs[2] = {0.f, 0.f};

  for (int tt = t0; tt < nq; ++tt) {
    const int b = tt & 1;
    const int q0 = tt * LT;
    if (tt + 1 < nq) stage(tt + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();  // q-tile tt (and, at the first, K and V) in place
    const float* Q = qs(b);
    const float* O = os(b);
    const float* L = lds(b);
    const float* D = L + LT;

    // S^T = K.Q^T and dP^T = V.dO^T: own keys x 64 queries
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 8; ++kc) {
      uint32_t kh[4], kl[4], vh[4], vl[4];
      load_a<LD>(ks + kr * LD + 8 * kc + t, kh, kl);
      load_a<LD>(vs + kr * LD + 8 * kc + t, vh, vl);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bh[2], bl[2];
        load_b_rows(Q + (8 * nt + g) * LD + 8 * kc + t, bh, bl);
        mma3(st + 4 * nt, kh, kl, bh, bl);
        load_b_rows(O + (8 * nt + g) * LD + 8 * kc + t, bh, bl);
        mma3(dpt + 4 * nt, vh, vl, bh, bl);
      }
    }
    // P^T and dS^T in place; db's partial sums
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int qc = 8 * (i >> 2) + 2 * t + (i & 1);  // tile-local query
      const int row = q0 + qc;
      const int key = k0 + kr + 8 * h;
      const float x = masked_score(st[i], sm_scale, kadd[h], row, key,
                                   causal);
      const float p = (row < sq && key < sk)
                          ? tc::exp2_approx((x - L[qc]) * tc::kLog2e)
                          : 0.f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - D[qc]);
      dbs[h] += dpt[i];
    }
    // dV += P^T.dO and dK += dS^T.Q over the tile's 64 queries
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      acc_as_a(st + 4 * j, ph, pl);
      acc_as_a(dpt + 4 * j, sh, sl);
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        uint32_t bh[2], bl[2];
        load_b_cols<LD>(O + (8 * j + 2 * t) * LD + 8 * nd + g, bh, bl);
        mma3(adv + 4 * nd, ph, pl, bh, bl);
        load_b_cols<LD>(Q + (8 * j + 2 * t) * LD + 8 * nd + g, bh, bl);
        mma3(adk + 4 * nd, sh, sl, bh, bl);
      }
    }
    __syncthreads();  // stage b is free for q-tile tt + 2
  }
  tc::cp_async_wait<0>();

  store_acc<DP>(dk + koff, adk, sm_scale, k0 + kr, sk, d, t);
  store_acc<DP>(dv + koff, adv, 1.f, k0 + kr, sk, d, t);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dbs[h] += __shfl_xor_sync(0xffffffffu, dbs[h], 1);
    dbs[h] += __shfl_xor_sync(0xffffffffu, dbs[h], 2);
    const int key = k0 + kr + 8 * h;
    if (db != nullptr && t == 0 && key < sk)
      db[(size_t)bh * sk + key] = dbs[h];
  }
}

// Query rows [q0, q0 + 64) of row bh: dQ. Loops over the k-tiles up to
// the causal diagonal.
template <int DP>
__device__ __forceinline__ void query_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int bh, int q0,
    int sq, int sk, int d, int causal, float sm_scale, float* smem) {
  using SM = Smem<DP>;
  constexpr int LD = SM::LD;
  float* qs = smem;
  float* os = qs + SM::kTile;
  auto ks = [&](int b) { return os + SM::kTile + b * SM::kStage; };
  auto vs = [&](int b) { return ks(b) + SM::kTile; };
  auto kadd = [&](int b) { return vs(b) + SM::kTile; };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl = (tid >> 5) * 16 + g;  // own rows rl, rl + 8 (tile-local)
  const size_t qoff = (size_t)bh * sq * d;
  const size_t koff = (size_t)bh * sk * d;
  float L[2], D[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rl + 8 * h;
    L[h] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
    D[h] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }

  stage_rows<DP>(qs, q + qoff, q0, sq, d, tid);
  stage_rows<DP>(os, dout + qoff, q0, sq, d, tid);
  int nk = (sk + LT - 1) / LT;
  if (causal) nk = min(nk, (q0 + OWN - 1) / LT + 1);  // up to the diagonal
  const float* brow = bias != nullptr ? bias + (size_t)bh * sk : nullptr;
  auto stage = [&](int tt) {
    const int b = tt & 1;
    const int k0 = tt * LT;
    stage_rows<DP>(ks(b), k + koff, k0, sk, d, tid);
    stage_rows<DP>(vs(b), v + koff, k0, sk, d, tid);
    if (tid < LT) stage_vec(kadd(b), brow, k0, sk, tid);
  };
  if (nk > 0) stage(0);
  tc::cp_async_commit();

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int tt = 0; tt < nk; ++tt) {
    const int b = tt & 1;
    const int k0 = tt * LT;
    if (tt + 1 < nk) stage(tt + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();  // k-tile tt (and, at the first, Q and dO) in place
    const float* K = ks(b);
    const float* V = vs(b);
    const float* ka = kadd(b);

    // S = Q.K^T and dP = dO.V^T: own rows x 64 keys
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 8; ++kc) {
      uint32_t qh[4], ql[4], oh[4], ol[4];
      load_a<LD>(qs + rl * LD + 8 * kc + t, qh, ql);
      load_a<LD>(os + rl * LD + 8 * kc + t, oh, ol);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bh[2], bl[2];
        load_b_rows(K + (8 * nt + g) * LD + 8 * kc + t, bh, bl);
        mma3(s + 4 * nt, qh, ql, bh, bl);
        load_b_rows(V + (8 * nt + g) * LD + 8 * kc + t, bh, bl);
        mma3(dp + 4 * nt, oh, ol, bh, bl);
      }
    }
    // dS in place of dP
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int kc = 8 * (i >> 2) + 2 * t + (i & 1);  // tile-local key
      const int row = q0 + rl + 8 * h;
      const int key = k0 + kc;
      const float x = masked_score(s[i], sm_scale, ka[kc], row, key, causal);
      const float p = (row < sq && key < sk)
                          ? tc::exp2_approx((x - L[h]) * tc::kLog2e)
                          : 0.f;
      dp[i] = p * (dp[i] - D[h]);
    }
    // dQ += dS.K over the tile's 64 keys
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t sh[4], sl[4];
      acc_as_a(dp + 4 * j, sh, sl);
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        uint32_t bh[2], bl[2];
        load_b_cols<LD>(K + (8 * j + 2 * t) * LD + 8 * nd + g, bh, bl);
        mma3(acc + 4 * nd, sh, sl, bh, bl);
      }
    }
    __syncthreads();  // stage b is free for k-tile tt + 2
  }
  tc::cp_async_wait<0>();

  store_acc<DP>(dq + qoff, acc, sm_scale, q0 + rl, sq, d, t);
}

}  // namespace tf32
}  // namespace flash
