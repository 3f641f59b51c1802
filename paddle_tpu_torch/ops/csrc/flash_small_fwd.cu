// flash_small_fwd: single-pass exact-softmax attention forward for short
// sequences, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_small_fwd_kernel` of
// paddle_tpu/ops/flash_attention.py (launched by `_small_call`), which the
// dispatch picks when sq, sk <= 512 (`_small_ok`). Same function as
// flash_fwd — O = softmax(scale * q.K^T + bias, causal mask) . V and the row
// lse — but with the exact softmax over whole score rows instead of the
// online rescaling: row max first, then exp and sum, then P.V.
//
// Layout: q (bn, sq, d), k/v (bn, sk, d), fp32 or bf16; bias (bn, sk) f32
// or null; O (bn, sq, d) in the input type; lse (bn, sq) f32. Head dims as
// in flash_fwd: d % 4 == 0 up to 256, padded to DP, a multiple of 16.
//
// Translation. The TPU kernel holds a (B, sq, sk) f32 score tile for B rows
// of b*n in VMEM (`_small_batch`, a 1.5 MB budget). A Hopper block has at
// most 227 KB of shared memory, so here one block of 256 threads owns the
// full score rows of 16 query rows (16 x sk x 4 B: 32 KB at sk = 512) and
// streams K, then V, through shared memory in chunks of 64 keys. Blocks of
// all (b*n) rows and query-row groups run in parallel. Causal runs stop at
// the last key any of the block's 16 rows can see; the masked keys past it
// would contribute exact zeros.
//
// Bound on this card: as flash_fwd, bound by operations (s/4 FLOP per byte
// in fp32, 64 at s = 256, against the H100's 20 FLOP/byte balance point),
// with plain f32 FMAs (no TF32). Design against it: 4-wide shared loads,
// the q row held as a broadcast read, and the causal key cut. The score
// rows make P.V read P from shared memory once per key, not from device
// memory.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int R = 16;    // query rows per block
constexpr int KC = 64;   // keys per K/V chunk
constexpr int NT = 256;  // 16 rows x 16 column groups

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_small_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ bias, T* __restrict__ o,
                       float* __restrict__ lse, int sq, int sk, int d,
                       int causal, float sm_scale, int ls_stride) {
  using OC = OutCols<DP>;
  constexpr int LD = DP + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [R][LD]
  float* kvs = qs + R * LD;    // [KC][LD]: the K chunk, then the V chunk
  float* ss = kvs + KC * LD;   // [R][ls_stride]: whole score rows

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int r = tid >> 4;   // this thread's row: q0 + r
  const int cg = tid & 15;  // its columns of a chunk: cg + 16*{0..3}
  const int row = q0 + r;
  const size_t qoff = (size_t)bh * sq * d;
  const size_t koff = (size_t)bh * sk * d;
  const float* brow = bias ? bias + (size_t)bh * sk : nullptr;
  float* srow = ss + r * ls_stride;

  // keys any row of this block can see, rounded up to whole chunks
  const int n_eff = causal ? min(sk, q0 + R) : sk;
  const int n_pad = (n_eff + KC - 1) / KC * KC;

  load_rows<R, DP, NT>(qs, q + qoff, q0, sq, d, tid);

  // pass 1: scores of the 16 rows against every key
  for (int c0 = 0; c0 < n_pad; c0 += KC) {
    __syncthreads();
    load_rows<KC, DP, NT>(kvs, k + koff, c0, sk, d, tid);
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int i = 0; i < DP; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(qs + r * LD + i);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 b =
            *reinterpret_cast<const float4*>(kvs + (cg + 16 * c) * LD + i);
        float x = s[c];
        x = fmaf(a.x, b.x, x);
        x = fmaf(a.y, b.y, x);
        x = fmaf(a.z, b.z, x);
        x = fmaf(a.w, b.w, x);
        s[c] = x;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c0 + cg + 16 * c;
      float x = s[c] * sm_scale;
      if (brow != nullptr && col < sk) x += brow[col];
      if (col >= sk) x = kNeg;
      if (causal && row < col) x = kNeg;
      srow[col] = x;
    }
  }
  __syncthreads();

  // pass 2: exact softmax numerator, row max then exp-sum (16 threads a row)
  float mx = kNeg;
  for (int j = cg; j < n_eff; j += 16) mx = fmaxf(mx, srow[j]);
  mx = max16(mx);
  float sum = 0.f;
  for (int j = cg; j < n_pad; j += 16) {
    const float e = j < n_eff ? expf(srow[j] - mx) : 0.f;
    srow[j] = e;
    sum += e;
  }
  sum = sum16(sum);

  // pass 3: O = P . V, V streamed in chunks
  float acc[OC::CPT];
#pragma unroll
  for (int j = 0; j < OC::CPT; ++j) acc[j] = 0.f;
  for (int c0 = 0; c0 < n_pad; c0 += KC) {
    __syncthreads();
    load_rows<KC, DP, NT>(kvs, v + koff, c0, sk, d, tid);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < KC; ++j) {
      const float p = srow[c0 + j];
      const float* vrow = kvs + j * LD;
#pragma unroll
      for (int ch = 0; ch < OC::CHUNKS; ++ch) {
        if constexpr (OC::VEC == 4) {
          const float4 t4 =
              *reinterpret_cast<const float4*>(vrow + OC::col(ch, cg));
          acc[ch * 4 + 0] = fmaf(p, t4.x, acc[ch * 4 + 0]);
          acc[ch * 4 + 1] = fmaf(p, t4.y, acc[ch * 4 + 1]);
          acc[ch * 4 + 2] = fmaf(p, t4.z, acc[ch * 4 + 2]);
          acc[ch * 4 + 3] = fmaf(p, t4.w, acc[ch * 4 + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < OC::VEC; ++e)
            acc[ch * OC::VEC + e] =
                fmaf(p, vrow[OC::col(ch, cg) + e], acc[ch * OC::VEC + e]);
        }
      }
    }
  }

  if (row < sq) {
    const float ls = sum == 0.f ? 1.f : sum;
    T* orow = o + qoff + (size_t)row * d;
#pragma unroll
    for (int ch = 0; ch < OC::CHUNKS; ++ch) {
      const int c = OC::col(ch, cg);
      if constexpr (OC::VEC == 4) {
        if (c < d)  // d % 4 == 0: a 4-wide chunk is wholly in or out
          store4(orow + c,
                 make_float4(acc[ch * 4] / ls, acc[ch * 4 + 1] / ls,
                             acc[ch * 4 + 2] / ls, acc[ch * 4 + 3] / ls));
      } else {
#pragma unroll
        for (int e = 0; e < OC::VEC; ++e)
          if (c + e < d) orow[c + e] = (T)(acc[ch * OC::VEC + e] / ls);
      }
    }
    if (cg == 0) lse[(size_t)bh * sq + row] = mx + logf(ls);
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* o, void* lse, int bn, int sq, int sk, int d, int causal,
           float sm_scale, cudaStream_t stream) {
  constexpr int LD = DP + 4;
  const int ls_stride = (sk + KC - 1) / KC * KC + 4;
  const size_t smem =
      (size_t)(R * LD + KC * LD + R * ls_stride) * sizeof(float);
  auto kern = flash_small_fwd_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + R - 1) / R, bn);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), static_cast<float*>(lse), sq, sk, d, causal,
      sm_scale, ls_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int flash_small_fwd_launch(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* o, void* lse, int bn, int sq,
                                      int sk, int d, int is_bf16, int causal,
                                      float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 4 != 0 || d > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
#define FLASH_SMALL_CASE(DD)                                                \
  case DD:                                                                  \
    return is_bf16 ? launch<__nv_bfloat16, DD>(q, k, v, bias, o, lse, bn,   \
                                               sq, sk, d, causal, sm_scale, \
                                               st)                          \
                   : launch<float, DD>(q, k, v, bias, o, lse, bn, sq, sk,   \
                                       d, causal, sm_scale, st);
  switch ((d + 15) / 16 * 16) {
    FLASH_FOR_EACH_DP(FLASH_SMALL_CASE)
  }
#undef FLASH_SMALL_CASE
  return (int)cudaErrorInvalidValue;
}
