// flash_fwd: tiled online-softmax attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of paddle_tpu/ops/flash_attention.py
// (launched by `_flash_call`). Same function: for each (b*n) row and query
// row, O = softmax(scale * q.K^T + bias, causal/kv_len masks) . V and the
// row log-sum-exp, with scores, running max/sum and the accumulator in f32.
//
// Layout: q (bn, sq, d), k/v (bn, sk, d), row-major, fp32 or bf16; bias
// (bn, sk) f32 per-key additive, or null; O (bn, sq, d) in the input type;
// lse (bn, sq) f32 (the TPU kernel's 128-lane padding was a Mosaic tiling
// artifact and is gone). Any head dim d with d % 4 == 0 up to 256 runs: the
// kernel is instantiated for d rounded up to a multiple of 16 (DP) and
// zero-fills the padded columns in shared memory.
//
// Translation. On the TPU the k-tiles of one query tile run in order on one
// core and carry m, l and the accumulator in VMEM scratch from one grid step
// to the next. Blocks on Hopper run in parallel and in no order, so the
// sequential k dimension becomes a loop inside the block: one block of 256
// threads owns 64 query rows of one (b*n) row and walks the k-tiles of 64
// keys, staging each K and V tile in shared memory; m, l and the 64 x DP
// accumulator stay in registers (each thread: 4 rows x DP/16 columns).
// Causal runs stop at the last tile that touches the diagonal.
//
// Bound on this card. FLOPs 4*bn*sq*sk*d (about half when causal) against
// the bytes of q, k, v and o, 16*bn*s*d in fp32 at sq = sk = s: s/4 FLOP
// per byte (s/8 causal), 128 at GPT-2's s = 1024, far above the H100's
// 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte, so it is bound by operations.
// This version uses plain f32 FMAs (no TF32 tensor cores: the reference
// runs at "highest" precision), so its ceiling is the 67 TFLOP/s
// non-tensor fp32 rate. What the design does about it:
// register tiling (a 4 x 4 score micro-tile per thread, 4-wide shared loads
// laid out bank-conflict free) so that shared memory feeds the FMA units,
// and the causal tile skip halves the work. wgmma/TMA come in a later
// change.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per k-tile
constexpr int NT = 256;  // 16 row groups (4 rows) x 16 column groups

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ o, float* __restrict__ lse, int sq, int sk,
                 int d, int causal, float sm_scale) {
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

  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K/V/P are no longer read
    load_rows<BK, DP, NT>(ks, k + koff, k0, sk, d, tid);
    load_rows<BK, DP, NT>(vs, v + koff, k0, sk, d, tid);
    __syncthreads();

    // S = q . k^T for 4 rows x 4 columns
    float s[4][4];
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

    // acc += P . V
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

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* o, void* lse, int bn, int sq, int sk, int d, int causal,
           float sm_scale, cudaStream_t stream) {
  constexpr int LD = DP + 4;
  const size_t smem =
      (size_t)(BQ * LD + 2 * BK * LD + BK * (BQ + 4)) * sizeof(float);
  auto kern = flash_fwd_kernel<T, DP>;
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

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* bias, void* o, void* lse, int bn,
                                int sq, int sk, int d, int is_bf16,
                                int causal, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 4 != 0 || d > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
#define FLASH_FWD_CASE(DD)                                                  \
  case DD:                                                                  \
    return is_bf16 ? launch<__nv_bfloat16, DD>(q, k, v, bias, o, lse, bn,   \
                                               sq, sk, d, causal, sm_scale, \
                                               st)                          \
                   : launch<float, DD>(q, k, v, bias, o, lse, bn, sq, sk,   \
                                       d, causal, sm_scale, st);
  switch ((d + 15) / 16 * 16) {
    FLASH_FOR_EACH_DP(FLASH_FWD_CASE)
  }
#undef FLASH_FWD_CASE
  return (int)cudaErrorInvalidValue;
}
