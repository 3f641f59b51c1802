// flash_small_bwd: short-sequence flash-attention backward in one launch,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_small_bwd_kernel` of
// paddle_tpu/ops/flash_attention.py (launched by `_small_bwd_call`), which
// the dispatch picks when sq, sk <= 512 (`_small_ok`). Same function as
// the tiled pair flash_bwd_dkv + flash_bwd_dq: dQ, dK, dV and the per-key
// bias grad from the saved lse, in one launch.
//
// Layout: q, dO (bn, sq, d), k/v (bn, sk, d), fp32 or bf16; bias (bn, sk)
// f32 or null; lse, delta (bn, sq) f32; dQ, dK, dV in the input type, db
// (bn, sk) f32.
//
// Translation. The TPU kernel holds B whole (sq, sk) f32 score tiles in VMEM
// and reads dQ, dK and dV off them in one pass. A Hopper block has at most
// 227 KB of shared memory, less than one (b*n) row's K and V at sk = 512,
// d = 64 in f32 (256 KB), so one row is split over several blocks of one
// grid: the first ceil(sk/64) blocks of a row each own 64 keys (dK, dV, db)
// and the rest each own 64 query rows (dQ). Every output element has one
// owner block, so there are no float atomics and a rerun gives the same
// bits. The price: both kinds of block recompute S and dP for their tile,
// 14 FLOP per kept pair and column against the single pass's 10.
//
// Bound on this card: 10 FLOP per kept pair and column against reading q,
// k, v, dO once. At BERT-base's shape (bn 192, s 512, d 64, bf16, bias)
// that is 32.2 GFLOP, 33 us on the bf16 tensor cores against 15 us of HBM
// traffic: bound by operations. fp32 (no TF32) is bound by the 67 TFLOP/s
// FMA rate.
//
// Two bodies, picked by the launch:
//
//  * bf16, DP <= 128: tensor cores, one warpgroup a block. A key block
//    holds its K and V tiles in shared memory and loops over 64-row q-tiles
//    (Q, dO, lse and delta staged by cp.async, double-buffered, in wgmma's
//    core-matrix layout, wgmma.cuh): S^T = K.Q^T and dP^T = V.dO^T on
//    wgmma.m64nNk16 from shared memory, then P^T = exp(S^T - lse) and
//    dS^T = P^T (dP^T - delta) in f32 registers, dV += P^T.dO and dK +=
//    dS^T.Q as register-A wgmmas against the staged tiles read MN-major,
//    and db += the row sums of dS^T in a fixed order. A query block holds
//    Q and dO and loops over 64-key tiles: S, dP, then dQ += dS.K. The
//    reference multiplies P and dS in f32 (JAX :291-297), and one bf16
//    rounding of dS would spoil dQ = sum dS.K, whose terms nearly cancel:
//    so P and dS enter each product as hi = bf16(x) and lo = bf16(x - hi),
//    two wgmmas against the exact bf16 Q, K or dO, which keeps about 16
//    bits of them. S and dP need no split: their operands are bf16.
//    P = exp(S - lse) is the SFU's ex2 of (S - lse) log2 e. Kernel:
//    flash_small_bwd_kernel_wgmma.
//  * fp32, and bf16 with DP > 128: flash_bwd_common.cuh's register-tiled
//    f32 FMA bodies BwdDkv and BwdDq (a DP > 128 f32 accumulator pair does
//    not fit beside the score tiles in registers), as
//    flash_small_bwd_kernel.
#include "flash_bwd_common.cuh"
#include "wgmma.cuh"

#include <type_traits>

namespace {

using namespace flash;
using tc::bf16;

// ---------------------------------------------------------------------------
// bf16, DP <= 128: wgmma
// ---------------------------------------------------------------------------
namespace tcb {

constexpr int NT = 128;       // one warpgroup a block
constexpr int OWN = kBwdOwn;  // keys or query rows a block owns (64)
constexpr int LT = 64;        // rows of a looped tile

template <int DP>
struct Smem {
  static constexpr int kT = 64 * DP * 2;  // bytes of a 64-row bf16 tile
  // the block's two own tiles, two stages of two looped tiles, and two
  // stages of 2 x 64 floats (lse and delta of a q-tile, or a k-tile's key
  // add)
  static constexpr int kStage = 2 * kT + 2 * LT * 4;
  static constexpr size_t kBytes = 2 * kT + 2 * (size_t)kStage;
};

// Query columns of a key block's score sub-tile: 64 when the dK and dV
// accumulators leave room (DP <= 64), else 32.
template <int DP>
struct KeyTile {
  static constexpr int QN = DP <= 64 ? 64 : 32;
};

// Keys [k0, k0 + 64) of row bh: dK, dV and (with a bias) db.
template <int DP>
__device__ __forceinline__ void key_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float* __restrict__ db, int bh, int k0, int sq,
    int sk, int d, int causal, float sm_scale, unsigned char* smem) {
  using SM = Smem<DP>;
  constexpr int QN = KeyTile<DP>::QN;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = reinterpret_cast<bf16*>(smem + SM::kT);
  unsigned char* stages = smem + 2 * SM::kT;
  auto qs = [&](int b) {
    return reinterpret_cast<bf16*>(stages + b * SM::kStage);
  };
  auto os = [&](int b) {
    return reinterpret_cast<bf16*>(stages + b * SM::kStage + SM::kT);
  };
  auto lds = [&](int b) {  // lse[64], then delta[64]
    return reinterpret_cast<float*>(stages + b * SM::kStage + 2 * SM::kT);
  };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int kr = ((tid >> 5) & 3) * 16 + (lane >> 2);  // own keys kr, kr + 8
  const int cq = 2 * (lane & 3);
  const size_t qoff = (size_t)bh * sq * d;
  const size_t koff = (size_t)bh * sk * d;
  float kadd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + kr + 8 * h;
    kadd[h] = (bias != nullptr && key < sk) ? bias[(size_t)bh * sk + key]
                                            : 0.f;
  }

  tc::stage_rows<OWN, DP, NT>(ks, k + koff, k0, sk, d, tid);
  tc::stage_rows<OWN, DP, NT>(vs, v + koff, k0, sk, d, tid);
  // causal: q-tiles wholly above this key tile see none of its keys
  const int t0 = causal ? k0 / LT : 0;
  const int nq = (sq + LT - 1) / LT;
  auto stage = [&](int t) {
    const int b = t & 1;
    const int q0 = t * LT;
    tc::stage_rows<LT, DP, NT>(qs(b), q + qoff, q0, sq, d, tid);
    tc::stage_rows<LT, DP, NT>(os(b), dout + qoff, q0, sq, d, tid);
    tc::cp_async_commit();
    if (tid < LT) {
      const int row = q0 + tid;
      lds(b)[tid] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
      lds(b)[LT + tid] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
    }
  };
  if (t0 < nq) stage(t0);  // else the loop is empty and dK = dV = db = 0

  float adk[DP / 2], adv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) adk[i] = adv[i] = 0.f;
  float dbs[2] = {0.f, 0.f};
  const uint64_t dks = tc::desc_k<DP>(ks);
  const uint64_t dvs = tc::desc_k<DP>(vs);

  for (int t = t0; t < nq; ++t) {
    const int b = t & 1;
    const int q0 = t * LT;
    if (t + 1 < nq) {
      stage(t + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_async_smem();
    __syncthreads();  // q-tile t (and, at the first, the own tiles) in place

    const float* L = lds(b);
    const float* D = L + LT;
#pragma unroll
    for (int h0 = 0; h0 < LT; h0 += QN) {
      float p[QN / 2], ds[QN / 2];  // P^T and dS^T: own keys x QN queries
      tc::wgmma_fence();
      tc::ss_tile<QN, DP>(p, dks, tc::desc_k<DP>(qs(b) + h0 * DP));
      tc::ss_tile<QN, DP>(ds, dvs, tc::desc_k<DP>(os(b) + h0 * DP));
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs<QN / 2>(p);
      tc::fence_regs<QN / 2>(ds);
#pragma unroll
      for (int i = 0; i < QN / 2; ++i) {
        const int h = (i >> 1) & 1;
        const int qc = h0 + (i >> 2) * 8 + cq + (i & 1);  // tile-local query
        const int row = q0 + qc;
        const int key = k0 + kr + 8 * h;
        const float x =
            masked_score(p[i], sm_scale, kadd[h], row, key, causal);
        const float pv = (row < sq && key < sk)
                             ? tc::exp2_approx((x - L[qc]) * tc::kLog2e)
                             : 0.f;
        p[i] = pv;
        ds[i] = pv * (ds[i] - D[qc]);
        dbs[h] += ds[i];
      }
      uint32_t ph[QN / 16][4], pl[QN / 16][4], sh[QN / 16][4],
          sl[QN / 16][4];
#pragma unroll
      for (int j = 0; j < QN / 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * j + 2 * e;
          tc::split_bf16(p[i], p[i + 1], ph[j][e], pl[j][e]);
          tc::split_bf16(ds[i], ds[i + 1], sh[j][e], sl[j][e]);
        }
      // 16 queries = two 8-row groups of DP * 16 bytes along K
      const uint64_t ddo = tc::desc_mn<DP>(os(b)) + (h0 / 8) * DP;
      const uint64_t dq = tc::desc_mn<DP>(qs(b)) + (h0 / 8) * DP;
      tc::wgmma_fence();
#pragma unroll
      for (int j = 0; j < QN / 16; ++j) {
        tc::rs_cols<DP>(adv, ph[j], ddo + 2 * DP * j);
        tc::rs_cols<DP>(adv, pl[j], ddo + 2 * DP * j);
        tc::rs_cols<DP>(adk, sh[j], dq + 2 * DP * j);
        tc::rs_cols<DP>(adk, sl[j], dq + 2 * DP * j);
      }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs<DP / 2>(adv);
      tc::fence_regs<DP / 2>(adk);
    }
    __syncthreads();  // stage b is free for q-tile t + 2
  }
  tc::cp_async_commit();  // the own tiles, when no q-tile was visited
  tc::cp_async_wait<0>();

  tc::store_acc<DP / 2>(dk + koff, adk, sm_scale, k0 + kr, sk, d, cq);
  tc::store_acc<DP / 2>(dv + koff, adv, 1.f, k0 + kr, sk, d, cq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dbs[h] += __shfl_xor_sync(0xffffffffu, dbs[h], 1);
    dbs[h] += __shfl_xor_sync(0xffffffffu, dbs[h], 2);
    const int key = k0 + kr + 8 * h;
    if (db != nullptr && (lane & 3) == 0 && key < sk)
      db[(size_t)bh * sk + key] = dbs[h];
  }
}

// Query rows [q0, q0 + 64) of row bh: dQ.
template <int DP>
__device__ __forceinline__ void query_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int bh, int q0,
    int sq, int sk, int d, int causal, float sm_scale, unsigned char* smem) {
  using SM = Smem<DP>;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* os = reinterpret_cast<bf16*>(smem + SM::kT);
  unsigned char* stages = smem + 2 * SM::kT;
  auto ks = [&](int b) {
    return reinterpret_cast<bf16*>(stages + b * SM::kStage);
  };
  auto vs = [&](int b) {
    return reinterpret_cast<bf16*>(stages + b * SM::kStage + SM::kT);
  };
  auto kadd = [&](int b) {
    return reinterpret_cast<float*>(stages + b * SM::kStage + 2 * SM::kT);
  };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rl = ((tid >> 5) & 3) * 16 + (lane >> 2);  // own rows rl, rl + 8
  const int cq = 2 * (lane & 3);
  const size_t qoff = (size_t)bh * sq * d;
  const size_t koff = (size_t)bh * sk * d;
  float L[2], D[2];  // lse and delta of the two own rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rl + 8 * h;
    L[h] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
    D[h] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }

  tc::stage_rows<OWN, DP, NT>(qs, q + qoff, q0, sq, d, tid);
  tc::stage_rows<OWN, DP, NT>(os, dout + qoff, q0, sq, d, tid);
  int nk = (sk + LT - 1) / LT;
  if (causal) nk = min(nk, (q0 + OWN - 1) / LT + 1);  // up to the diagonal
  auto stage = [&](int t) {
    const int b = t & 1;
    const int k0 = t * LT;
    tc::stage_rows<LT, DP, NT>(ks(b), k + koff, k0, sk, d, tid);
    tc::stage_rows<LT, DP, NT>(vs(b), v + koff, k0, sk, d, tid);
    tc::cp_async_commit();
    if (tid < LT) {
      const int key = k0 + tid;
      kadd(b)[tid] = (bias != nullptr && key < sk)
                         ? bias[(size_t)bh * sk + key]
                         : 0.f;
    }
  };
  stage(0);

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  const uint64_t dqs = tc::desc_k<DP>(qs);
  const uint64_t dos = tc::desc_k<DP>(os);

  for (int t = 0; t < nk; ++t) {
    const int b = t & 1;
    const int k0 = t * LT;
    if (t + 1 < nk) {
      stage(t + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_async_smem();
    __syncthreads();

    float p[32], ds[32];  // P and dS: own rows x 64 keys
    tc::wgmma_fence();
    tc::ss_tile<64, DP>(p, dqs, tc::desc_k<DP>(ks(b)));
    tc::ss_tile<64, DP>(ds, dos, tc::desc_k<DP>(vs(b)));
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs<32>(p);
    tc::fence_regs<32>(ds);
    const float* ka = kadd(b);
    uint32_t sh[4][4], sl[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int kc = (i >> 2) * 8 + cq + (i & 1);  // tile-local key
      const int row = q0 + rl + 8 * h;
      const int key = k0 + kc;
      const float x =
          masked_score(p[i], sm_scale, ka[kc], row, key, causal);
      const float pv = (row < sq && key < sk)
                           ? tc::exp2_approx((x - L[h]) * tc::kLog2e)
                           : 0.f;
      ds[i] = pv * (ds[i] - D[h]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tc::split_bf16(ds[8 * j + 2 * e], ds[8 * j + 2 * e + 1], sh[j][e],
                       sl[j][e]);
    const uint64_t dk = tc::desc_mn<DP>(ks(b));
    tc::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // 16 keys = two 8-row groups along K
      tc::rs_cols<DP>(acc, sh[j], dk + 2 * DP * j);
      tc::rs_cols<DP>(acc, sl[j], dk + 2 * DP * j);
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs<DP / 2>(acc);
    __syncthreads();  // stage b is free for k-tile t + 2
  }

  tc::store_acc<DP / 2>(dq + qoff, acc, sm_scale, q0 + rl, sq, d, cq);
}

template <int DP>
__global__ void __launch_bounds__(NT) flash_small_bwd_kernel_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq,
    bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ db,
    int sq, int sk, int d, int causal, float sm_scale, int n_key_blocks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bx = blockIdx.x;
  if (bx < n_key_blocks)
    key_block<DP>(q, k, v, bias, dout, lse, delta, dk, dv, db, blockIdx.y,
                  bx * OWN, sq, sk, d, causal, sm_scale, smem);
  else
    query_block<DP>(q, k, v, bias, dout, lse, delta, dq, blockIdx.y,
                    (bx - n_key_blocks) * OWN, sq, sk, d, causal, sm_scale,
                    smem);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* dout, const void* lse, const void* delta, void* dq,
           void* dk, void* dv, void* db, int bn, int sq, int sk, int d,
           int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = Smem<DP>::kBytes;
  auto kern = flash_small_bwd_kernel_wgmma<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_key_blocks = (sk + OWN - 1) / OWN;
  dim3 grid(n_key_blocks + (sq + OWN - 1) / OWN, bn);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(db),
      sq, sk, d, causal, sm_scale, n_key_blocks);
  return (int)cudaGetLastError();
}

}  // namespace tcb

// ---------------------------------------------------------------------------
// fp32, and bf16 with DP > 128: the f32 FMA bodies
// ---------------------------------------------------------------------------
namespace fmab {

template <typename T, int DP>
__global__ void __launch_bounds__(kBwdThreads) flash_small_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ bias,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, float* __restrict__ db, int sq, int sk, int d,
    int causal, float sm_scale, int n_key_blocks) {
  extern __shared__ __align__(16) float smem[];
  const int bx = blockIdx.x;
  if (bx < n_key_blocks)
    BwdDkv<T, DP>::run(q, k, v, bias, dout, lse, delta, dk, dv, db,
                       blockIdx.y, bx * kBwdOwn, sq, sk, d, causal, sm_scale,
                       smem);
  else
    BwdDq<T, DP>::run(q, k, v, bias, dout, lse, delta, dq, blockIdx.y,
                      (bx - n_key_blocks) * kBwdOwn, sq, sk, d, causal,
                      sm_scale, smem);
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* dout, const void* lse, const void* delta, void* dq,
           void* dk, void* dv, void* db, int bn, int sq, int sk, int d,
           int causal, float sm_scale, cudaStream_t stream) {
  constexpr int kFloats = BwdDkv<T, DP>::kSmemFloats > BwdDq<T, DP>::kSmemFloats
                              ? BwdDkv<T, DP>::kSmemFloats
                              : BwdDq<T, DP>::kSmemFloats;
  const size_t smem = (size_t)kFloats * sizeof(float);
  auto kern = flash_small_bwd_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_key_blocks = (sk + kBwdOwn - 1) / kBwdOwn;
  dim3 grid(n_key_blocks + (sq + kBwdOwn - 1) / kBwdOwn, bn);
  kern<<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(db), sq,
      sk, d, causal, sm_scale, n_key_blocks);
  return (int)cudaGetLastError();
}

}  // namespace fmab

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* dout, const void* lse, const void* delta, void* dq,
           void* dk, void* dv, void* db, int bn, int sq, int sk, int d,
           int causal, float sm_scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value && DP <= 128)
    return tcb::launch<DP>(q, k, v, bias, dout, lse, delta, dq, dk, dv, db,
                           bn, sq, sk, d, causal, sm_scale, stream);
  else
    return fmab::launch<T, DP>(q, k, v, bias, dout, lse, delta, dq, dk, dv,
                               db, bn, sq, sk, d, causal, sm_scale, stream);
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int flash_small_bwd_launch(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dq, void* dk,
                                      void* dv, void* db, int bn, int sq,
                                      int sk, int d, int is_bf16, int causal,
                                      float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 4 != 0 || d > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
#define FLASH_SMALL_BWD_CASE(DD)                                            \
  case DD:                                                                  \
    return is_bf16                                                          \
               ? launch<bf16, DD>(q, k, v, bias, dout, lse, delta, dq, dk,  \
                                  dv, db, bn, sq, sk, d, causal, sm_scale,  \
                                  st)                                       \
               : launch<float, DD>(q, k, v, bias, dout, lse, delta, dq, dk, \
                                   dv, db, bn, sq, sk, d, causal, sm_scale, \
                                   st);
  switch ((d + 15) / 16 * 16) {
    FLASH_FOR_EACH_DP(FLASH_SMALL_BWD_CASE)
  }
#undef FLASH_SMALL_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
