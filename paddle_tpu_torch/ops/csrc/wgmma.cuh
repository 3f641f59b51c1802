// Hopper tensor-core building blocks of the bf16 flash kernels
// (flash_small_fwd.cu, flash_small_bwd.cu): asynchronous staging of bf16
// tiles into shared memory in wgmma's core-matrix layout, shared-memory
// matrix descriptors, and the warpgroup matrix multiplies (wgmma) the
// kernels issue, as raw PTX so that a build takes seconds (no CuTe).
//
// Layout. A row-major (rows, DP) bf16 tile is held as 8 x 8 "core
// matrices": the 16-byte piece (r, c) — columns 8c..8c+7 of row r — lies
// at byte ((r / 8) * (DP / 8) + c) * 128 + (r % 8) * 16, with no swizzle.
// The same image serves as a K-major operand (rows are M or N, columns the
// reduction dim: LBO = 128 B between core matrices along K, SBO = DP * 16 B
// between 8-row groups) and as an MN-major one (rows are the reduction
// dim, columns N, read with the transpose flag: LBO = DP * 16 B between
// 8-row groups along K, SBO = 128 B between 8-column groups along N).
// So a tile staged once feeds both S = Q.K^T and dK += dS^T.Q.
//
// Register layout of an m64nN f32 accumulator (thread t of the warpgroup,
// warp w = t / 32, lane = t % 32): element i sits at row
// 16 w + lane / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (lane % 4) +
// i % 2. For 16-bit types the register A operand of an m64nNk16 wgmma
// has the same layout over its 64 x 16 tile, so the accumulator of a
// 64 x 64 score tile becomes the A operand of the next product with no
// data movement: k-step j (columns 16 j..16 j+15) takes elements
// 8 j..8 j+7, packed in pairs.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {
namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory matrix descriptor, no swizzle: start address, leading and
// stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// Descriptors of a core-matrix tile as a K-major and as an MN-major
// operand. Advancing the start address by B bytes adds B / 16.
template <int DP>
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return make_desc(p, 128, DP * 16);
}
template <int DP>
__device__ __forceinline__ uint64_t desc_mn(const void* p) {
  return make_desc(p, DP * 16, 128);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to wgmma's reads, which go through the async proxy; a barrier
// follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy rows [row0, row0 + ROWS) of a row-major (nrows, d) bf16 matrix into
// the core-matrix layout at dst, asynchronously (one cp.async group is
// committed by the caller). Rows past nrows and columns past d are
// zero-filled. d % 8 == 0 moves 16-byte pieces; otherwise (d % 4 == 0)
// 8-byte halves, as the rows are then only 8-byte aligned.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int row0, int nrows, int d,
                                           int tid) {
  constexpr int CH = DP / 8;  // 16-byte pieces a row
  const uint32_t base = smem_addr(dst);
  for (int idx = tid; idx < ROWS * CH; idx += NT) {
    // idx * 16 == ((r / 8) * CH + c) * 128 + (r % 8) * 16
    const int r = (idx / (8 * CH)) * 8 + (idx & 7);
    const int c = (idx >> 3) % CH;
    const int row = row0 + r;
    const uint32_t to = base + idx * 16;
    const bool in_row = row < nrows;
    if (d % 8 == 0) {
      const bool ok = in_row && 8 * c < d;
      const bf16* from = ok ? src + (size_t)row * d + 8 * c : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to),
                   "l"(from), "r"(ok ? 16 : 0)
                   : "memory");
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 8 * c + 4 * h;
        const bool ok = in_row && col < d;
        const bf16* from = ok ? src + (size_t)row * d + col : src;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                         to + 8 * h),
                     "l"(from), "r"(ok ? 8 : 0)
                     : "memory");
      }
    }
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Ties later reads of accumulator registers to a point after the wait:
// the wgmma writes them asynchronously, which the compiler cannot see.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) (+)= A (64 x 16, bf16, shared, K-major) . B^T (N x 16,
// bf16, shared, K-major); accumulate = 0 overwrites d.
template <int N>
struct SS;
// d (64 x N, f32) += a (64 x 16, bf16 pairs in registers) . B (16 x N,
// bf16, shared, MN-major: the transpose flag is set).
template <int N>
struct RS;

template <>
struct SS<32> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct SS<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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
};

template <>
struct RS<16> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct RS<32> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct RS<64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// d[0 .. DP/2) += a . B over all DP columns of an MN-major B: one wgmma of
// width 64, 32 or 16 per column block (DP is a multiple of 16). Column
// block n0 starts n0 / 8 core matrices (n0 * 16 bytes) into B, and its
// accumulator elements are d[n0/2 ..] (the layout above is uniform in
// 8-column blocks).
template <int DP, int N0 = 0>
__device__ __forceinline__ void rs_cols(float* d, const uint32_t* a,
                                        uint64_t db) {
  if constexpr (N0 < DP) {
    constexpr int NS = DP - N0 >= 64 ? 64 : (DP - N0 >= 32 ? 32 : 16);
    RS<NS>::mma(d + N0 / 2, a, db + N0);
    rs_cols<DP, N0 + NS>(d, a, db);
  }
}

// d (64 x N) = A . B^T over a reduction dim of DP (K-major A and B, both
// DP columns wide): DP / 16 wgmmas, each advancing two core matrices
// (256 bytes) along K.
template <int N, int DP>
__device__ __forceinline__ void ss_tile(float* d, uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    SS<N>::mma(d, da + 16 * kk, db + 16 * kk, kk > 0);
}

// e^x as 2^(x log2 e) on the SFU: exp2_approx((x - m) * kLog2e) is
// e^(x - m) within about |x - m| * 2^-24 relative (the rounding of the
// exponent) of the correctly rounded value. (Folding -m log2 e into an FMA
// would save an add but err by |m| * 2^-24: 1e-3 for a row whose keys the
// -1e4 bias masks, and 1e23 for m = -1e30.)
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo to about 16 significant bits: hi = bf16(x), lo =
// bf16(x - hi); two products against an exact bf16 operand then keep the
// f32 operand's precision to ~2^-17.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// An m64nN accumulator (N / 2 elements a thread, the layout above), times
// scale, to bf16 rows row0.. (this thread's rows row0 and row0 + 8) of a
// row-major (nrows, d) output; rows past nrows and columns past d are not
// stored.
template <int N>
__device__ __forceinline__ void store_acc(bf16* dst, const float* acc,
                                          float scale, int row0, int nrows,
                                          int d, int cq) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const int row = row0 + ((i >> 1) & 1) * 8;
    const int col = (i >> 2) * 8 + cq;
    if (row < nrows && col < d)  // d is even: the pair is wholly in or out
      *reinterpret_cast<uint32_t*>(dst + (size_t)row * d + col) =
          pack_bf16(acc[i] * scale, acc[i + 1] * scale);
  }
}

}  // namespace tc
}  // namespace flash
