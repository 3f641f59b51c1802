// Block bodies shared by the flash-attention backward kernels
// (flash_bwd_dkv.cu, flash_bwd_dq.cu, flash_small_bwd.cu).
//
// Both bodies recompute the scores of a (query rows, keys) tile from q and k,
// P = exp(S - lse) from the forward's saved row log-sum-exp (no running max:
// lse is known), dP = dO . V^T, and the unscaled dS = P * (dP - delta) with
// delta = rowsum(dO * O) computed before the launch. The scale is applied
// once, when dK and dQ are stored; the per-key bias grad is colsum(dS).
//
//   BwdDkv: a block owns 64 keys of one (b*n) row and loops over q-tiles:
//           dV += P^T . dO, dK += dS^T . Q, db += colsum(dS).
//   BwdDq:  a block owns 64 query rows and loops over k-tiles:
//           dQ += dS . K.
//
// Every output element has one owner block, so there are no atomics and a
// rerun gives the same bits. Accumulators live in registers (4 owned rows x
// DP/16 columns a thread, as in flash_fwd); the looped tile is staged in
// shared memory in f32. Rows past sq and keys past sk get P = 0, so the
// zero-filled padding of the staged tiles never reaches an output.
#pragma once

#include "flash_common.cuh"

namespace flash {

constexpr int kBwdThreads = 256;  // 16 row groups x 16 column groups
constexpr int kBwdOwn = 64;       // rows (keys or queries) a block owns

// Rows of the tile a block loops over: 64, or 32 above DP = 128 so that the
// staged f32 tiles fit in the 227 KB of shared memory a block may use.
template <int DP>
struct BwdLoop {
  static constexpr int ROWS = DP <= 128 ? 64 : 32;
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float x) {
  x = fmaf(a.x, b.x, x);
  x = fmaf(a.y, b.y, x);
  x = fmaf(a.z, b.z, x);
  x = fmaf(a.w, b.w, x);
  return x;
}

// s[r][c] = A[ra + r] . B[cb + 16 c] over the DP columns of two shared
// tiles with row stride DP + 4 (the 4-wide reads of 16 neighbouring B rows
// fall on distinct banks, as in flash_fwd).
template <int R, int C, int DP>
__device__ __forceinline__ void tile_dot(float (&s)[R][C], const float* A,
                                         int ra, const float* B, int cb) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) s[r][c] = 0.f;
#pragma unroll 4
  for (int i = 0; i < DP; i += 4) {
    float4 a[R], b[C];
#pragma unroll
    for (int r = 0; r < R; ++r)
      a[r] = *reinterpret_cast<const float4*>(A + (ra + r) * LD + i);
#pragma unroll
    for (int c = 0; c < C; ++c)
      b[c] = *reinterpret_cast<const float4*>(B + (cb + 16 * c) * LD + i);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) s[r][c] = dot4(a[r], b[c], s[r][c]);
  }
}

// acc[r][:] += w[r] * row[this thread's columns], r = 0..3.
template <int DP>
__device__ __forceinline__ void axpy_rows(float (&acc)[4][OutCols<DP>::CPT],
                                          float4 w, const float* row,
                                          int cg) {
  using OC = OutCols<DP>;
#pragma unroll
  for (int ch = 0; ch < OC::CHUNKS; ++ch) {
    float vv[OC::VEC];
    if constexpr (OC::VEC == 4) {
      const float4 t4 =
          *reinterpret_cast<const float4*>(row + OC::col(ch, cg));
      vv[0] = t4.x; vv[1] = t4.y; vv[2] = t4.z; vv[3] = t4.w;
    } else {
#pragma unroll
      for (int e = 0; e < OC::VEC; ++e) vv[e] = row[OC::col(ch, cg) + e];
    }
#pragma unroll
    for (int e = 0; e < OC::VEC; ++e) {
      const int j = ch * OC::VEC + e;
      acc[0][j] = fmaf(w.x, vv[e], acc[0][j]);
      acc[1][j] = fmaf(w.y, vv[e], acc[1][j]);
      acc[2][j] = fmaf(w.z, vv[e], acc[2][j]);
      acc[3][j] = fmaf(w.w, vv[e], acc[3][j]);
    }
  }
}

template <int DP>
__device__ __forceinline__ void zero_rows(float (&acc)[4][OutCols<DP>::CPT]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < OutCols<DP>::CPT; ++j) acc[r][j] = 0.f;
}

// Rows row0..row0+3 of a row-major (nrows, d) output get acc * scale;
// rows >= nrows and columns >= d are not stored.
template <int DP, typename T>
__device__ __forceinline__ void store_rows(
    T* dst, const float (&acc)[4][OutCols<DP>::CPT], float scale, int row0,
    int nrows, int d, int cg) {
  using OC = OutCols<DP>;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (row0 + r >= nrows) continue;
    T* out = dst + (size_t)(row0 + r) * d;
#pragma unroll
    for (int ch = 0; ch < OC::CHUNKS; ++ch) {
      const int c = OC::col(ch, cg);
      if constexpr (OC::VEC == 4) {
        if (c < d)  // d % 4 == 0: a 4-wide chunk is wholly in or out
          store4(out + c, make_float4(acc[r][ch * 4] * scale,
                                      acc[r][ch * 4 + 1] * scale,
                                      acc[r][ch * 4 + 2] * scale,
                                      acc[r][ch * 4 + 3] * scale));
      } else {
#pragma unroll
        for (int e = 0; e < OC::VEC; ++e)
          if (c + e < d) out[c + e] = (T)(acc[r][ch * OC::VEC + e] * scale);
      }
    }
  }
}

// Keys [k0, k0 + 64) of row bh: dK, dV and (with a bias) db.
template <typename T, int DP>
struct BwdDkv {
  static constexpr int BK = kBwdOwn;
  static constexpr int BQ = BwdLoop<DP>::ROWS;
  static constexpr int RQ = BQ / 16;  // q rows of a thread's score tile
  static constexpr int LD = DP + 4;
  static constexpr int LS = BK + 4;   // row stride of the P and dS tiles
  static constexpr int kSmemFloats = 2 * BK * LD + 2 * BQ * LD + 2 * BQ * LS;

  static __device__ __forceinline__ void run(
      const T* __restrict__ q, const T* __restrict__ k,
      const T* __restrict__ v, const float* __restrict__ bias,
      const T* __restrict__ dout, const float* __restrict__ lse,
      const float* __restrict__ delta, T* __restrict__ dk,
      T* __restrict__ dv, float* __restrict__ db, int bh, int k0, int sq,
      int sk, int d, int causal, float sm_scale, float* smem) {
    float* ks = smem;          // [BK][LD]
    float* vs = ks + BK * LD;  // [BK][LD]
    float* qs = vs + BK * LD;  // [BQ][LD]
    float* os = qs + BQ * LD;  // [BQ][LD]: dO
    float* ps = os + BQ * LD;  // [BQ][LS]: P, query-major
    float* dss = ps + BQ * LS; // [BQ][LS]: dS, query-major

    const int tid = threadIdx.x;
    const int rg = tid >> 4;  // score rows rg*RQ + r; owned keys rg*4 + r
    const int cg = tid & 15;  // score keys cg + 16 c; owned columns OutCols
    const size_t qoff = (size_t)bh * sq * d;
    const size_t koff = (size_t)bh * sk * d;
    const float* brow = bias ? bias + (size_t)bh * sk : nullptr;
    const float* lrow = lse + (size_t)bh * sq;
    const float* drow = delta + (size_t)bh * sq;

    load_rows<BK, DP, kBwdThreads>(ks, k + koff, k0, sk, d, tid);
    load_rows<BK, DP, kBwdThreads>(vs, v + koff, k0, sk, d, tid);

    float bcol[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = k0 + cg + 16 * c;
      bcol[c] = (brow != nullptr && col < sk) ? brow[col] : 0.f;
    }
    float adk[4][OutCols<DP>::CPT], adv[4][OutCols<DP>::CPT];
    zero_rows<DP>(adk);
    zero_rows<DP>(adv);
    float dbs = 0.f;

    // causal: q-tiles wholly above this key tile see none of its keys
    const int nq = (sq + BQ - 1) / BQ;
    for (int t = causal ? k0 / BQ : 0; t < nq; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // the previous tile's Q/dO/P/dS are no longer read
      load_rows<BQ, DP, kBwdThreads>(qs, q + qoff, q0, sq, d, tid);
      load_rows<BQ, DP, kBwdThreads>(os, dout + qoff, q0, sq, d, tid);
      __syncthreads();

      float s[RQ][4], dp[RQ][4];
      tile_dot<RQ, 4, DP>(s, qs, rg * RQ, ks, cg);
      tile_dot<RQ, 4, DP>(dp, os, rg * RQ, vs, cg);
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int lr = rg * RQ + r;
        const int row = q0 + lr;
        const bool rv = row < sq;
        const float L = rv ? lrow[row] : 0.f;
        const float D = rv ? drow[row] : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = k0 + cg + 16 * c;
          float x = s[r][c] * sm_scale + bcol[c];
          if (causal && row < col) x = kNeg;
          const float p = (rv && col < sk) ? expf(x - L) : 0.f;
          ps[lr * LS + cg + 16 * c] = p;
          dss[lr * LS + cg + 16 * c] = p * (dp[r][c] - D);
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + r * LS + rg * 4);
        const float4 s4 =
            *reinterpret_cast<const float4*>(dss + r * LS + rg * 4);
        axpy_rows<DP>(adv, p4, os + r * LD, cg);
        axpy_rows<DP>(adk, s4, qs + r * LD, cg);
      }
      if (brow != nullptr && tid < BK) {
        float cs = 0.f;
        for (int r = 0; r < BQ; ++r) cs += dss[r * LS + tid];
        dbs += cs;
      }
    }

    store_rows<DP>(dk + koff, adk, sm_scale, k0 + rg * 4, sk, d, cg);
    store_rows<DP>(dv + koff, adv, 1.f, k0 + rg * 4, sk, d, cg);
    if (brow != nullptr && tid < BK && k0 + tid < sk)
      db[(size_t)bh * sk + k0 + tid] = dbs;
  }
};

// Query rows [q0, q0 + 64) of row bh: dQ.
template <typename T, int DP>
struct BwdDq {
  static constexpr int BQ = kBwdOwn;
  static constexpr int BK = BwdLoop<DP>::ROWS;
  static constexpr int CK = BK / 16;  // keys of a thread's score tile
  static constexpr int LD = DP + 4;
  static constexpr int LT = BQ + 4;   // row stride of the dS^T tile
  static constexpr int kSmemFloats = 2 * BQ * LD + 2 * BK * LD + BK * LT;

  static __device__ __forceinline__ void run(
      const T* __restrict__ q, const T* __restrict__ k,
      const T* __restrict__ v, const float* __restrict__ bias,
      const T* __restrict__ dout, const float* __restrict__ lse,
      const float* __restrict__ delta, T* __restrict__ dq, int bh, int q0,
      int sq, int sk, int d, int causal, float sm_scale, float* smem) {
    float* qs = smem;           // [BQ][LD]
    float* os = qs + BQ * LD;   // [BQ][LD]: dO
    float* ks = os + BQ * LD;   // [BK][LD]
    float* vs = ks + BK * LD;   // [BK][LD]
    float* dst = vs + BK * LD;  // [BK][LT]: dS transposed, key-major

    const int tid = threadIdx.x;
    const int rg = tid >> 4;  // rows q0 + rg*4 + r (scores and dQ)
    const int cg = tid & 15;  // score keys cg + 16 c; dQ columns OutCols
    const size_t qoff = (size_t)bh * sq * d;
    const size_t koff = (size_t)bh * sk * d;
    const float* brow = bias ? bias + (size_t)bh * sk : nullptr;

    load_rows<BQ, DP, kBwdThreads>(qs, q + qoff, q0, sq, d, tid);
    load_rows<BQ, DP, kBwdThreads>(os, dout + qoff, q0, sq, d, tid);

    float L[4], D[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + rg * 4 + r;
      L[r] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
      D[r] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
    }
    float acc[4][OutCols<DP>::CPT];
    zero_rows<DP>(acc);

    int nk = (sk + BK - 1) / BK;
    if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);  // up to the diagonal
    for (int t = 0; t < nk; ++t) {
      const int k0 = t * BK;
      __syncthreads();  // the previous tile's K/V/dS are no longer read
      load_rows<BK, DP, kBwdThreads>(ks, k + koff, k0, sk, d, tid);
      load_rows<BK, DP, kBwdThreads>(vs, v + koff, k0, sk, d, tid);
      __syncthreads();

      float s[4][CK], dp[4][CK];
      tile_dot<4, CK, DP>(s, qs, rg * 4, ks, cg);
      tile_dot<4, CK, DP>(dp, os, rg * 4, vs, cg);
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int col = k0 + cg + 16 * c;
        const float b = (brow != nullptr && col < sk) ? brow[col] : 0.f;
        float ds[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = q0 + rg * 4 + r;
          float x = s[r][c] * sm_scale + b;
          if (causal && row < col) x = kNeg;
          const float p = (row < sq && col < sk) ? expf(x - L[r]) : 0.f;
          ds[r] = p * (dp[r][c] - D[r]);
        }
        *reinterpret_cast<float4*>(dst + (cg + 16 * c) * LT + rg * 4) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();

#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float4 w = *reinterpret_cast<const float4*>(dst + j * LT + rg * 4);
        axpy_rows<DP>(acc, w, ks + j * LD, cg);
      }
    }

    store_rows<DP>(dq + qoff, acc, sm_scale, q0 + rg * 4, sq, d, cg);
  }
};

}  // namespace flash
