// flash_small_fwd: single-pass exact-softmax attention forward for short
// sequences, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_small_fwd_kernel` of
// paddle_tpu/ops/flash_attention.py (launched by `_small_call`), which the
// dispatch picks when sq, sk <= 512 (`_small_ok`). Same function as
// flash_fwd — O = softmax(scale * q.K^T + bias, causal mask) . V and the row
// lse — but with the exact softmax of the reference: row max m and sum l
// over the whole score row first, then P = p / l rounded to the input type
// (bf16: the reference's `(p / l).astype(v.dtype)`, :272), then P.V in f32.
//
// Layout: q (bn, sq, d), k/v (bn, sk, d), fp32 or bf16; bias (bn, sk) f32
// or null; O (bn, sq, d) in the input type; lse (bn, sq) f32. Head dims as
// in flash_fwd: d % 4 == 0 up to 256, padded to DP, a multiple of 16.
//
// Bound on this card. At BERT-base's shape (bn 192, sq = sk = 512, d 64,
// bf16, per-key bias) the kernel must read 50 MB and do 12.9 GFLOP: 15 us
// of HBM traffic against 13 us of bf16 tensor-core work, so it sits at the
// balance point and any f32 FMA formulation (67 TFLOP/s, 190 us) is bound
// by operations 15-fold over. GPT's fp32 shape (48, 512, 64, causal) does
// 1.6 GFLOP on the FMA units (24 us) against 13 MB.
//
// Two bodies, picked by the launch:
//
//  * bf16: tensor cores. A block of two warpgroups owns 128
//    query rows (64 a warpgroup); Q stays in shared memory and 64-key
//    chunks of K and V are staged by cp.async, double-buffered, in wgmma's
//    core-matrix layout (wgmma.cuh). The exact softmax takes two passes
//    over the keys, because the reference rounds P after normalising:
//    pass A computes S = Q.K^T on wgmma.m64n64k16 (bf16 x bf16 products
//    are exact in f32) and keeps the row max and sum in registers; pass B
//    recomputes S chunk by chunk, forms P = exp(S - m) / l in f32, rounds
//    it to bf16 in registers and feeds it as the register A operand of the
//    P.V wgmma against the V chunk (MN-major, transpose flag); O stays in
//    f32 registers. 6 FLOP per kept pair and column instead of 4, on a unit
//    15x faster. Causal blocks stop at their last visible key. The
//    exponentials are the SFU's ex2 of (x - m) log2 e and the division a
//    multiply by 1 / l: with accurate expf and IEEE division the
//    elementwise work, not the products, bounds a step. A P whose f32
//    value lies near a bf16 rounding tie may then round to the other
//    neighbour than the plain version's; chip_smoke.py reads the kernel's
//    rounded P and holds each such P within its 2^-16 tie allowance.
//    Kernel: flash_small_fwd_kernel_wgmma.
//  * fp32: the register-tiled online-softmax body of flash_fwd
//    (flash_fwd_body.cuh; TF32 stays off), as flash_small_fwd_kernel. In
//    f32 the online and the exact softmax are the same function up to
//    rounding, and P is not rounded.
#include "flash_fwd_body.cuh"
#include "wgmma.cuh"

#include <type_traits>

namespace {

using namespace flash;
using tc::bf16;

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------
namespace tcf {

constexpr int WG = 2;        // consumer warpgroups a block
constexpr int BQ = 64 * WG;  // query rows a block
constexpr int KC = 64;       // keys a chunk
constexpr int NT = 128 * WG;

template <int DP>
struct Smem {
  static constexpr int kQ = BQ * DP * 2;  // bytes of the Q tile
  static constexpr int kC = KC * DP * 2;  // bytes of a K or V chunk
  // Q, two stages of K and of V, then the key add row (bias or 0 for the
  // keys < sk, kNeg past sk) over the chunks the block visits
  static size_t bytes(int n_keys) { return kQ + 4 * kC + (size_t)n_keys * 4; }
};

template <int DP>
__global__ void __launch_bounds__(NT)
flash_small_fwd_kernel_wgmma(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const float* __restrict__ bias,
                             bf16* __restrict__ o, float* __restrict__ lse,
                             int sq, int sk, int d, int causal,
                             float sm_scale) {
  using SM = Smem<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + SM::kQ);           // 2 stages
  bf16* vs = reinterpret_cast<bf16*>(smem + SM::kQ + 2 * SM::kC);
  float* kadd = reinterpret_cast<float*>(smem + SM::kQ + 4 * SM::kC);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // block-local rows of this thread's accumulator elements: rl for those
  // with (i / 2) % 2 == 0, rl + 8 for the others; columns 8 (i / 4) + cq +
  // i % 2 (wgmma.cuh)
  const int rl = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const size_t qoff = (size_t)bh * sq * d;
  const size_t koff = (size_t)bh * sk * d;
  const int n_eff = causal ? min(sk, q0 + BQ) : sk;  // keys the block sees
  const int nc = (n_eff + KC - 1) / KC;
  const int steps = 2 * nc;  // pass A over nc chunks, then pass B

  for (int j = tid; j < nc * KC; j += NT)
    kadd[j] = j < sk ? (bias != nullptr ? bias[(size_t)bh * sk + j] : 0.f)
                     : kNeg;
  tc::stage_rows<BQ, DP, NT>(qs, q + qoff, q0, sq, d, tid);
  // step s stages chunk s % nc's K (and in pass B its V) into stage s % 2
  auto stage = [&](int s) {
    const int buf = s & 1;
    const int c0 = (s < nc ? s : s - nc) * KC;
    tc::stage_rows<KC, DP, NT>(ks + buf * KC * DP, k + koff, c0, sk, d, tid);
    if (s >= nc)
      tc::stage_rows<KC, DP, NT>(vs + buf * KC * DP, v + koff, c0, sk, d,
                                 tid);
    tc::cp_async_commit();
  };
  stage(0);

  // row max m, sum l (and 1 / l) of this thread's two rows
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, inv_l[2] = {1.f, 1.f};
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
    __syncthreads();  // stage s and the key add row are in place

    const bool pass_b = s >= nc;
    const int c0 = (pass_b ? s - nc : s) * KC;
    float x[32];  // the 64 x 64 score tile of this warpgroup
    tc::wgmma_fence();
    tc::ss_tile<64, DP>(x, dq, tc::desc_k<DP>(ks + buf * KC * DP));
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs<32>(x);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = c0 + (i >> 2) * 8 + cq + (i & 1);
      // alike in both passes, so pass B's x never exceeds pass A's max
      x[i] = masked_score(x[i], sm_scale, kadd[col],
                          q0 + rl + ((i >> 1) & 1) * 8, col, causal);
    }

    if (!pass_b) {
      // pass A: running row max and (per-thread partial) sum
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x[i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        l[h] *= tc::exp2_approx((m[h] - mx[h]) * tc::kLog2e);
        m[h] = mx[h];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        l[h] += tc::exp2_approx((x[i] - m[h]) * tc::kLog2e);
      }
      if (s == nc - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
          if (l[h] == 0.f) l[h] = 1.f;  // a row with every key masked
          inv_l[h] = 1.f / l[h];
        }
      }
    } else {
      // pass B: P = p / l in bf16 as the A operand of P.V, 16 keys a step
      uint32_t a[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * t + 2 * e;
          const int h = e & 1;
          a[t][e] = tc::pack_bf16(
              tc::exp2_approx((x[i] - m[h]) * tc::kLog2e) * inv_l[h],
              tc::exp2_approx((x[i + 1] - m[h]) * tc::kLog2e) * inv_l[h]);
        }
      const uint64_t dv = tc::desc_mn<DP>(vs + buf * KC * DP);
      tc::wgmma_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t)  // 16 keys = two 8-row groups of DP*16 B
        tc::rs_cols<DP>(acc, a[t], dv + 2 * DP * t);
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs<DP / 2>(acc);
    }
    __syncthreads();  // stage s is free for step s + 2
  }

  tc::store_acc<DP / 2>(o + qoff, acc, 1.f, q0 + rl, sq, d, cq);
  if ((lane & 3) == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + rl + 8 * h;
      if (row < sq) lse[(size_t)bh * sq + row] = m[h] + logf(l[h]);
    }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* o, void* lse, int bn, int sq, int sk, int d, int causal,
           float sm_scale, cudaStream_t stream) {
  const size_t smem = Smem<DP>::bytes((sk + KC - 1) / KC * KC);
  auto kern = flash_small_fwd_kernel_wgmma<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, bn);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(o), static_cast<float*>(lse), sq, sk, d, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace tcf

// ---------------------------------------------------------------------------
// fp32: flash_fwd's register-tiled body
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(tiled::NT)
flash_small_fwd_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ bias, float* __restrict__ o,
                       float* __restrict__ lse, int sq, int sk, int d,
                       int causal, float sm_scale) {
  tiled::fwd_body<float, DP>(q, k, v, bias, o, lse, sq, sk, d, causal,
                             sm_scale);
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* o, void* lse, int bn, int sq, int sk, int d, int causal,
           float sm_scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return tiled::launch_fwd<float, DP>(flash_small_fwd_kernel<DP>, q, k, v,
                                        bias, o, lse, bn, sq, sk, d, causal,
                                        sm_scale, stream);
  else
    return tcf::launch<DP>(q, k, v, bias, o, lse, bn, sq, sk, d, causal,
                           sm_scale, stream);
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
    return is_bf16 ? launch<bf16, DD>(q, k, v, bias, o, lse, bn, sq, sk, d, \
                                      causal, sm_scale, st)                 \
                   : launch<float, DD>(q, k, v, bias, o, lse, bn, sq, sk,   \
                                       d, causal, sm_scale, st);
  switch ((d + 15) / 16 * 16) {
    FLASH_FOR_EACH_DP(FLASH_SMALL_CASE)
  }
#undef FLASH_SMALL_CASE
  return (int)cudaErrorInvalidValue;
}
