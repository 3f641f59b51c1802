// Tensor-core bodies of the tiled flash-attention forward (flash_fwd.cu),
// for Hopper (sm_90a). flash_fwd_body.cuh's register-tiled FMA body keeps
// fp32 above DP 64, bf16 above DP 128 and flash_small_fwd's fp32 path.
//
//  * f32_query_block: fp32, padded head dims DP <= 64, on mma.sync.m16n8k8
//    TF32 with every operand split into hi + lo and three products a
//    product (flash_bwd_tc.cuh gives the arithmetic and the fragment
//    layouts; tests/test_torch_flash_fwd_split.py emulates this body). A
//    block is four warps and owns 64 query rows, warp w rows 16w..16w+15;
//    each thread keeps its split Q fragments in registers for the whole
//    walk (read once from device memory, no shared-memory image). K, V and
//    the key bias of each 64-key tile are staged by cp.async with zero
//    fill past sk, double-buffered. S = Q.K^T lands in registers, the
//    online softmax runs there (one pass over 64-key tiles: in fp32 the
//    reference's rounding of p is a no-op), and the score accumulator is
//    the A operand of O += P.V as it stands: slot t carries key 2t, slot
//    t + 4 key 2t + 1, and B reads V's rows 2t and 2t + 1 to match. No P
//    tile goes through shared memory. p = 2^((s - m) log2 e) on the SFU.
//  * bf16_query_block: bf16, DP <= 128, on wgmma (wgmma.cuh), after
//    flash_small_fwd's body: a block of two warpgroups owns 128 query rows
//    (64 a warpgroup), Q in shared memory, 64-key chunks of K and V staged
//    by cp.async, double-buffered, in the core-matrix layout. What differs
//    is the rounding point: the reference steps its running max over
//    blocks of `_pick_blocks` keys (ref_block_keys: 512 at sk 1024, 128
//    where 512 does not divide sk) and rounds each block's unnormalised
//    p = exp(s - m) to bf16 before P.V, while l sums the f32 p (JAX
//    flash_attention.py:106-111). So each reference block is walked twice
//    as 64-key chunks: pass A takes the block's row max on S =
//    Q.K^T (wgmma.m64n64k16), then the accumulator and l are rescaled
//    once; pass B recomputes S, adds p to l in f32, rounds p to bf16 in
//    registers and feeds it as the register A operand of the P.V wgmma
//    against the MN-major V chunk. O = acc / l at the end. Keeping a
//    block's S instead of recomputing it would take 64 x 512 f32 a
//    warpgroup, which neither the registers nor shared memory hold.
//    Causal blocks stop at their last visible chunk.
//
// One owner block for each output element and no atomics: every rerun
// gives the same bits. The grid is (b*n, query tiles) with the last
// (heaviest under the causal mask) query tile first.
#pragma once

#include "flash_bwd_tc.cuh"  // TF32 split, mma.sync, cp.async staging
#include "flash_fwd_body.cuh"  // tiled::ref_block_keys
#include "wgmma.cuh"

namespace flash {
namespace fwd_tc {

// ---------------------------------------------------------------------------
// fp32: split TF32 on mma.sync
// ---------------------------------------------------------------------------

constexpr int kF32Threads = tf32::NT;  // four warps
constexpr int kF32Rows = 64;           // query rows a block owns
constexpr int kF32MaxDP = tf32::kMaxDP;

template <int DP>
struct F32Smem {
  static constexpr int LD = DP + 4;      // row stride, floats
  static constexpr int kTile = 64 * LD;  // floats of a 64-key K or V tile
  // a stage: the K and V tiles and the tile's 64 key adds (bias or 0)
  static constexpr int kStage = 2 * kTile + 64;
  static constexpr size_t kBytes = 2 * (size_t)kStage * 4;
};

// x[row][col] of a row-major (nrows, d) matrix, 0 outside it
__device__ __forceinline__ float load_or_zero(const float* x, int row,
                                              int col, int nrows, int d) {
  return row < nrows && col < d ? __ldg(x + (size_t)row * d + col) : 0.f;
}

// Query rows [q0, q0 + 64) of row bh: O and lse.
template <int DP>
__device__ __forceinline__ void f32_query_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    float* __restrict__ o, float* __restrict__ lse, int bh, int q0, int sq,
    int sk, int d, int causal, float sm_scale, float* smem) {
  using SM = F32Smem<DP>;
  constexpr int LD = SM::LD;
  auto ks = [&](int b) { return smem + b * SM::kStage; };
  auto vs = [&](int b) { return ks(b) + SM::kTile; };
  auto kadd = [&](int b) { return vs(b) + SM::kTile; };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl = (tid >> 5) * 16 + g;  // own rows rl, rl + 8 (tile-local)
  const size_t qoff = (size_t)bh * sq * d;
  const size_t koff = (size_t)bh * sk * d;
  const float* brow = bias != nullptr ? bias + (size_t)bh * sk : nullptr;

  int nk = (sk + 63) / 64;
  if (causal) nk = min(nk, (q0 + kF32Rows - 1) / 64 + 1);  // to the diagonal
  auto stage = [&](int tt) {
    const int b = tt & 1;
    const int k0 = tt * 64;
    tf32::stage_rows<DP>(ks(b), k + koff, k0, sk, d, tid);
    tf32::stage_rows<DP>(vs(b), v + koff, k0, sk, d, tid);
    if (tid < 64) tf32::stage_vec(kadd(b), brow, k0, sk, tid);
  };
  stage(0);
  tc::cp_async_commit();

  // this thread's A fragments of Q (rows rl and rl + 8), split once
  uint32_t qh[DP / 8][4], ql[DP / 8][4];
  {
    const float* qb = q + qoff;
    const int r0 = q0 + rl;
#pragma unroll
    for (int kc = 0; kc < DP / 8; ++kc) {
      const int c = 8 * kc + t;
      tf32::split(load_or_zero(qb, r0, c, sq, d), qh[kc][0], ql[kc][0]);
      tf32::split(load_or_zero(qb, r0 + 8, c, sq, d), qh[kc][1], ql[kc][1]);
      tf32::split(load_or_zero(qb, r0, c + 4, sq, d), qh[kc][2], ql[kc][2]);
      tf32::split(load_or_zero(qb, r0 + 8, c + 4, sq, d), qh[kc][3],
                  ql[kc][3]);
    }
  }

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this thread's part
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int tt = 0; tt < nk; ++tt) {
    const int b = tt & 1;
    const int k0 = tt * 64;
    if (tt + 1 < nk) stage(tt + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();  // k-tile tt in place
    const float* K = ks(b);
    const float* V = vs(b);
    const float* ka = kadd(b);

    // S = Q.K^T: own rows x 64 keys
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 8; ++kc)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bh[2], bl[2];
        tf32::load_b_rows(K + (8 * nt + g) * LD + 8 * kc + t, bh, bl);
        tf32::mma3(s + 4 * nt, qh[kc], ql[kc], bh, bl);
      }

    // masks, then the online softmax of rows rl and rl + 8
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int kc = 8 * (i >> 2) + 2 * t + (i & 1);  // tile-local key
      const int key = k0 + kc;
      s[i] = key < sk ? masked_score(s[i], sm_scale, ka[kc],
                                     q0 + rl + 8 * h, key, causal)
                      : kNeg;
      mx[h] = fmaxf(mx[h], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = tc::exp2_approx((m[h] - mx[h]) * tc::kLog2e);
      l[h] *= alpha[h];
      m[h] = mx[h];
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = tc::exp2_approx((s[i] - m[h]) * tc::kLog2e);
      l[h] += s[i];
    }

    // O += P.V over the tile's 64 keys, P as the A operand in place
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t ph[4], pl[4];
      tf32::acc_as_a(s + 4 * j, ph, pl);
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        uint32_t bh[2], bl[2];
        tf32::load_b_cols<LD>(V + (8 * j + 2 * t) * LD + 8 * nd + g, bh,
                              bl);
        tf32::mma3(acc + 4 * nd, ph, pl, bh, bl);
      }
    }
    __syncthreads();  // stage b is free for k-tile tt + 2
  }
  tc::cp_async_wait<0>();

  // O = acc / l, lse = m + log l (a row with every key masked: l = 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (l[h] == 0.f) l[h] = 1.f;
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] /= l[(i >> 1) & 1];
  tf32::store_acc<DP>(o + qoff, acc, 1.f, q0 + rl, sq, d, t);
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + rl + 8 * h;
      if (row < sq) lse[(size_t)bh * sq + row] = m[h] + logf(l[h]);
    }
}

// ---------------------------------------------------------------------------
// bf16: wgmma, two passes over each reference k-block
// ---------------------------------------------------------------------------

using tc::bf16;

constexpr int kBf16WG = 2;                 // warpgroups a block
constexpr int kBf16Rows = 64 * kBf16WG;    // query rows a block owns
constexpr int kBf16Threads = 128 * kBf16WG;
constexpr int kBf16MaxDP = 128;
constexpr int KC = 64;                     // keys a chunk

template <int DP>
struct Bf16Smem {
  static constexpr int kQ = kBf16Rows * DP * 2;  // bytes of the Q tile
  static constexpr int kC = KC * DP * 2;         // bytes of a K or V chunk
  // Q, two stages of K and of V, then two stages of the chunk's key adds
  static constexpr size_t kBytes = kQ + 4 * kC + 2 * KC * 4;
};

// Query rows [q0, q0 + 128) of row bh: O and lse.
template <int DP>
__device__ __forceinline__ void bf16_query_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias,
    bf16* __restrict__ o, float* __restrict__ lse, int bh, int q0, int sq,
    int sk, int d, int causal, float sm_scale, unsigned char* smem) {
  using SM = Bf16Smem<DP>;
  constexpr int NT = kBf16Threads;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + SM::kQ);  // 2 stages
  bf16* vs = reinterpret_cast<bf16*>(smem + SM::kQ + 2 * SM::kC);
  float* kadd = reinterpret_cast<float*>(smem + SM::kQ + 4 * SM::kC);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // block-local rows of this thread's accumulator elements: rl for those
  // with (i / 2) % 2 == 0, rl + 8 for the others; columns 8 (i / 4) + cq +
  // i % 2 (wgmma.cuh)
  const int rl = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const size_t qoff = (size_t)bh * sq * d;
  const size_t koff = (size_t)bh * sk * d;
  const float* brow = bias != nullptr ? bias + (size_t)bh * sk : nullptr;
  const int n_eff = causal ? min(sk, q0 + kBf16Rows) : sk;  // keys seen
  const int nc = (n_eff + KC - 1) / KC;
  const int gk = (tiled::ref_block_keys(sk) + KC - 1) / KC;  // chunks a block
  const int steps = 2 * nc;  // each chunk in pass A, then in pass B

  // step s -> (chunk, pass B?, first step of its pass, last step of it)
  struct Step {
    int chunk;
    bool pass_b, first, last;
  };
  auto step_of = [&](int s) {
    const int blk = s / (2 * gk);
    const int within = s - blk * 2 * gk;
    const int cnt = min(gk, nc - blk * gk);  // chunks in this block
    const bool pb = within >= cnt;
    const int j = pb ? within - cnt : within;
    return Step{blk * gk + j, pb, j == 0, j == cnt - 1};
  };
  // step s stages its chunk's K, key adds and (in pass B) V into stage s % 2
  auto stage = [&](int s) {
    const int buf = s & 1;
    const Step st = step_of(s);
    const int c0 = st.chunk * KC;
    tc::stage_rows<KC, DP, NT>(ks + buf * KC * DP, k + koff, c0, sk, d, tid);
    if (st.pass_b)
      tc::stage_rows<KC, DP, NT>(vs + buf * KC * DP, v + koff, c0, sk, d,
                                 tid);
    if (tid < KC) tf32::stage_vec(kadd + buf * KC, brow, c0, sk, tid);
    tc::cp_async_commit();
  };
  tc::stage_rows<kBf16Rows, DP, NT>(qs, q + qoff, q0, sq, d, tid);
  stage(0);

  // running max m, this thread's part of l, and the block max mb of pass A
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, mb[2] = {kNeg, kNeg};
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  const uint64_t dq = tc::desc_k<DP>(qs + (tid >> 7) * 64 * DP);

  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) {
      stage(s + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_async_smem();
    __syncthreads();  // stage s is in place

    const Step st = step_of(s);
    const int c0 = st.chunk * KC;
    const float* ka = kadd + buf * KC;
    float x[32];  // the 64 x 64 score tile of this warpgroup
    tc::wgmma_fence();
    tc::ss_tile<64, DP>(x, dq, tc::desc_k<DP>(ks + buf * KC * DP));
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs<32>(x);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kc = (i >> 2) * 8 + cq + (i & 1);  // chunk-local key
      const int col = c0 + kc;
      // alike in both passes, so pass B's x never exceeds the block max
      x[i] = col < sk ? masked_score(x[i], sm_scale, ka[kc],
                                     q0 + rl + ((i >> 1) & 1) * 8, col,
                                     causal)
                      : kNeg;
    }

    if (!st.pass_b) {
      // pass A: the block's row max; at its last chunk, rescale once
      if (st.first) mb[0] = mb[1] = kNeg;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mb[(i >> 1) & 1] = fmaxf(mb[(i >> 1) & 1], x[i]);
      if (st.last) {
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = fmaxf(mb[h], __shfl_xor_sync(0xffffffffu, mb[h], 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          mx = fmaxf(m[h], mx);
          alpha[h] = tc::exp2_approx((m[h] - mx) * tc::kLog2e);
          l[h] *= alpha[h];
          m[h] = mx;
        }
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
    } else {
      // pass B: p = exp(x - m) into l in f32, rounded to bf16 as the A
      // operand of P.V, 16 keys a step
      uint32_t a[4][4];
#pragma unroll
      for (int tk = 0; tk < 4; ++tk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * tk + 2 * e;
          const int h = e & 1;
          const float p0 = tc::exp2_approx((x[i] - m[h]) * tc::kLog2e);
          const float p1 = tc::exp2_approx((x[i + 1] - m[h]) * tc::kLog2e);
          l[h] += p0 + p1;
          a[tk][e] = tc::pack_bf16(p0, p1);
        }
      const uint64_t dv = tc::desc_mn<DP>(vs + buf * KC * DP);
      tc::wgmma_fence();
#pragma unroll
      for (int tk = 0; tk < 4; ++tk)  // 16 keys = two 8-row groups of DP*16 B
        tc::rs_cols<DP>(acc, a[tk], dv + 2 * DP * tk);
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs<DP / 2>(acc);
    }
    __syncthreads();  // stage s is free for step s + 2
  }

  // O = acc / l, lse = m + log l (a row with every key masked: l = 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (l[h] == 0.f) l[h] = 1.f;
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] /= l[(i >> 1) & 1];
  tc::store_acc<DP / 2>(o + qoff, acc, 1.f, q0 + rl, sq, d, cq);
  if ((lane & 3) == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + rl + 8 * h;
      if (row < sq) lse[(size_t)bh * sq + row] = m[h] + logf(l[h]);
    }
}

}  // namespace fwd_tc
}  // namespace flash
