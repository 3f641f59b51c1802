// The register-tiled online-softmax attention forward body, shared by
// flash_fwd.cu (all its launches) and flash_small_fwd.cu (its fp32 path):
// one block of 256 threads owns 64 query rows of one (b*n) row and walks
// the k-tiles of 64 keys, staging each K and V tile in shared memory in
// f32; m, l and the 64 x DP accumulator stay in registers (each thread: 4
// rows x DP/16 columns, a 4 x 4 score micro-tile per k-tile, P transposed
// through shared memory for P.V). Causal runs stop at the last tile that
// touches the diagonal. flash_fwd.cu's note gives the bound and design.
//
// bf16 follows the reference's rounding point: `_fwd_kernel` steps its
// running max over k-blocks of `_pick_blocks` keys and rounds each block's
// unnormalised p = exp(s - m) to bf16 before P.V, summing l from the f32 p
// (JAX flash_attention.py:106-111). So in bf16 each such block is walked
// twice as 64-key tiles: the first pass takes the block's row max, the
// second recomputes S, adds p to l, rounds it and multiplies by V (6 FLOP
// a pair and column instead of 4). fp32, where the rounding is a no-op,
// keeps the one-pass online softmax over 64-key tiles.
#pragma once

#include <type_traits>

#include "flash_common.cuh"

namespace flash {
namespace tiled {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per k-tile
constexpr int NT = 256;  // 16 row groups (4 rows) x 16 column groups

// Keys of one step of the reference's running max (`_pick_blocks`, JAX
// :420-423): all of sk up to 512, else 512 where it divides sk, else 128.
__device__ __forceinline__ int ref_block_keys(int sk) {
  return sk <= 512 ? sk : (sk % 512 == 0 ? 512 : 128);
}

// s[r][c] = q row (rg*4 + r) . k row (cg + 16 c) over DP columns of the
// staged tiles (row stride DP + 4).
template <int DP>
__device__ __forceinline__ void score_tile(float (&s)[4][4], const float* qs,
                                           const float* ks, int rg, int cg) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
  for (int i = 0; i < DP; i += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = *reinterpret_cast<const float4*>(qs + (rg * 4 + r) * LD + i);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      b[c] = *reinterpret_cast<const float4*>(ks + (cg + 16 * c) * LD + i);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[r][c];
        x = fmaf(a[r].x, b[c].x, x);
        x = fmaf(a[r].y, b[c].y, x);
        x = fmaf(a[r].z, b[c].z, x);
        x = fmaf(a[r].w, b[c].w, x);
        s[r][c] = x;
      }
  }
}

// The masked scores of the bf16 two-pass walk: scale, per-key bias, kv
// length and causal masks, with no contraction into an FMA, so that both
// passes over a tile compute the same values.
__device__ __forceinline__ void mask_tile(float (&s)[4][4],
                                          const float* brow, int q0, int k0,
                                          int rg, int cg, int sk, int causal,
                                          float sm_scale) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = k0 + cg + 16 * c;
      const float b = (brow != nullptr && col < sk) ? brow[col] : 0.f;
      s[r][c] = col < sk ? masked_score(s[r][c], sm_scale, b, q0 + rg * 4 + r,
                                        col, causal)
                         : kNeg;
    }
}

// The body of a __global__ kernel of NT threads. Each library that runs it
// wraps it in a kernel of its own name (flash_fwd_kernel,
// flash_small_fwd_kernel), so a trace tells the two apart.
template <typename T, int DP>
__device__ __forceinline__ void fwd_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ o,
    float* __restrict__ lse, int sq, int sk, int d, int causal,
    float sm_scale) {
  using OC = OutCols<DP>;
  constexpr int LD = DP + 4;  // row stride of the q/k/v tiles in shared memory
  constexpr int LP = BQ + 4;  // row stride of the transposed P tile
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;           // [BQ][LD]
  float* ks = qs + BQ * LD;   // [BK][LD]
  float* vs = ks + BK * LD;   // [BK][LD]
  float* ps = vs + BK * LD;   // [BK][LP]: P transposed, key-major

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // this thread's rows: q0 + rg*4 + {0..3}
  const int cg = tid & 15;  // its score columns: k0 + cg + 16*{0..3}
  const size_t qoff = (size_t)bh * sq * d;
  const size_t koff = (size_t)bh * sk * d;
  const float* brow = bias ? bias + (size_t)bh * sk : nullptr;

  load_rows<BQ, DP, NT>(qs, q + qoff, q0, sq, d, tid);

  float m[4], l[4], acc[4][OC::CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < OC::CPT; ++j) acc[r][j] = 0.f;
  }

  int nk = (sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);  // skip tiles above the diagonal

  // acc += P . V over the keys of the staged V tile, P transposed in ps
  auto accumulate_pv = [&]() {
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(ps + j * LP + rg * 4);
      const float* vrow = vs + j * LD;
#pragma unroll
      for (int ch = 0; ch < OC::CHUNKS; ++ch) {
        float vv[OC::VEC];
        if constexpr (OC::VEC == 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(vrow + OC::col(ch, cg));
          vv[0] = t4.x; vv[1] = t4.y; vv[2] = t4.z; vv[3] = t4.w;
        } else {
#pragma unroll
          for (int e = 0; e < OC::VEC; ++e) vv[e] = vrow[OC::col(ch, cg) + e];
        }
#pragma unroll
        for (int e = 0; e < OC::VEC; ++e) {
          const int j2 = ch * OC::VEC + e;
          acc[0][j2] = fmaf(p.x, vv[e], acc[0][j2]);
          acc[1][j2] = fmaf(p.y, vv[e], acc[1][j2]);
          acc[2][j2] = fmaf(p.z, vv[e], acc[2][j2]);
          acc[3][j2] = fmaf(p.w, vv[e], acc[3][j2]);
        }
      }
    }
  };

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // two passes over each reference k-block of gk 64-key tiles
    const int gk = (ref_block_keys(sk) + BK - 1) / BK;
    for (int g0 = 0; g0 < nk; g0 += gk) {
      const int g1 = min(g0 + gk, nk);
      float mb[4] = {kNeg, kNeg, kNeg, kNeg};
      for (int t = g0; t < g1; ++t) {
        const int k0 = t * BK;
        __syncthreads();  // the previous tile's K/V/P are no longer read
        load_rows<BK, DP, NT>(ks, k + koff, k0, sk, d, tid);
        __syncthreads();
        float s[4][4];
        score_tile<DP>(s, qs, ks, rg, cg);
        mask_tile(s, brow, q0, k0, rg, cg, sk, causal, sm_scale);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) mb[r] = fmaxf(mb[r], s[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float m_new = fmaxf(m[r], max16(mb[r]));
        const float alpha = expf(m[r] - m_new);
        l[r] *= alpha;
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < OC::CPT; ++j) acc[r][j] *= alpha;
      }
      for (int t = g0; t < g1; ++t) {
        const int k0 = t * BK;
        __syncthreads();
        load_rows<BK, DP, NT>(ks, k + koff, k0, sk, d, tid);
        load_rows<BK, DP, NT>(vs, v + koff, k0, sk, d, tid);
        __syncthreads();
        float s[4][4];
        score_tile<DP>(s, qs, ks, rg, cg);
        mask_tile(s, brow, q0, k0, rg, cg, sk, causal, sm_scale);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float rs = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float p = expf(s[r][c] - m[r]);
            rs += p;  // l sums the f32 p
            s[r][c] = __bfloat162float(__float2bfloat16_rn(p));
          }
          l[r] += sum16(rs);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
          *reinterpret_cast<float4*>(ps + (cg + 16 * c) * LP + rg * 4) =
              make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
        __syncthreads();
        accumulate_pv();
      }
    }
  } else {
    // fp32: one pass, online softmax over 64-key tiles
    for (int t = 0; t < nk; ++t) {
      const int k0 = t * BK;
      __syncthreads();  // the previous tile's K/V/P are no longer read
      load_rows<BK, DP, NT>(ks, k + koff, k0, sk, d, tid);
      load_rows<BK, DP, NT>(vs, v + koff, k0, sk, d, tid);
      __syncthreads();

      // S = q . k^T for 4 rows x 4 columns
      float s[4][4];
      score_tile<DP>(s, qs, ks, rg, cg);

      // scale, bias, masks, then the online-softmax update of each row
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = q0 + rg * 4 + r;
        float mx = kNeg;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = k0 + cg + 16 * c;
          float x = s[r][c] * sm_scale;
          if (brow != nullptr && col < sk) x += brow[col];
          if (col >= sk) x = kNeg;
          if (causal && row < col) x = kNeg;
          s[r][c] = x;
          mx = fmaxf(mx, x);
        }
        mx = max16(mx);
        const float m_new = fmaxf(m[r], mx);
        const float alpha = expf(m[r] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = expf(s[r][c] - m_new);
          rs += s[r][c];
        }
        rs = sum16(rs);
        l[r] = l[r] * alpha + rs;
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < OC::CPT; ++j) acc[r][j] *= alpha;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(ps + (cg + 16 * c) * LP + rg * 4) =
            make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      __syncthreads();

      accumulate_pv();
    }
  }

  // O = acc / l, lse = m + log(l)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + rg * 4 + r;
    if (row >= sq) continue;
    const float ls = l[r] == 0.f ? 1.f : l[r];  // fully-masked rows
    T* orow = o + qoff + (size_t)row * d;
#pragma unroll
    for (int ch = 0; ch < OC::CHUNKS; ++ch) {
      const int c = OC::col(ch, cg);
      if constexpr (OC::VEC == 4) {
        if (c < d)  // d % 4 == 0: a 4-wide chunk is wholly in or out
          store4(orow + c,
                 make_float4(acc[r][ch * 4] / ls, acc[r][ch * 4 + 1] / ls,
                             acc[r][ch * 4 + 2] / ls, acc[r][ch * 4 + 3] / ls));
      } else {
#pragma unroll
        for (int e = 0; e < OC::VEC; ++e)
          if (c + e < d) orow[c + e] = (T)(acc[r][ch * OC::VEC + e] / ls);
      }
    }
    if (cg == 0) lse[(size_t)bh * sq + row] = m[r] + logf(ls);
  }
}

// Dynamic shared memory of fwd_body<T, DP>: the q, k and v tiles and the
// transposed P tile, in f32.
template <int DP>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * (DP + 4) + 2 * BK * (DP + 4) + BK * (BQ + 4)) *
         sizeof(float);
}

// Launches `kern`, a __global__ wrapper of fwd_body<T, DP>.
template <typename T, int DP, typename Kernel>
inline int launch_fwd(Kernel kern, const void* q, const void* k,
                      const void* v, const void* bias, void* o, void* lse,
                      int bn, int sq, int sk, int d, int causal,
                      float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, bn);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), static_cast<float*>(lse), sq, sk, d, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace tiled
}  // namespace flash
