// headslice_gram: the Gram matrix mat @ mat^T of one head's (s, d) slice of
// x (b, s, n, d), read in place through x's strides, for Hopper (sm_90a).
//
// Replaces the TPU kernel `kern` of tools/mosaic_repro_headslice.py (its
// pallas_call). That repro asks whether a kernel can take attention tensors
// in their native (batch, seq, heads, head_dim) layout, cutting a
// (1, s, 1, d) block out of the middle `heads` dim and using it as an (s, d)
// matrix; Mosaic could not lower that squeeze, so the JAX flash kernels copy
// q, k and v to (b * heads, s, d) first. Here the slice is only strides: the
// kernel reads x[b, i, head, k] at b * sb + i * ss + head * sn + k * sd and
// never copies it.
//
// Which head. The TPU grid runs a (b, head) program for every head, and its
// output block map ignores the head index, so on the sequential grid each
// head overwrites the last one's (b, s, s) block and the last head's Gram
// matrix is what remains. Here only that head writes: the caller passes
// head = n - 1 and no program is launched for the heads whose results the
// TPU discards, so the result is the same (b, s, s) f32 on every run.
//
// Design: a block computes a 32 x 32 tile of one batch's output, staging 32
// rows of each operand, 32 columns of d at a time, in shared memory; each of
// its 256 threads sums 4 outputs over d in order, in f32.
//
// Bound on this card: at the repro's (4, 128, 12, 64) f32, operations: 2 * b
// * s^2 * d = 8.4 MFLOP, 0.125 us at the 67 TFLOP/s fp32 peak, against
// b*s*d*4 + b*s*s*4 = 393 kB, 0.117 us at 3.35 TB/s. A launch costs more.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
headslice_gram_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int S, int D, long long sb, long long ss,
                      long long sd, long long head_offset) {
  __shared__ float qi[kTile][kTile + 1];
  __shared__ float kj[kTile][kTile + 1];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const float* xb = x + (long long)blockIdx.z * sb + head_offset;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d0 = 0; d0 < D; d0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile;
      const int gd = d0 + c;
      qi[r][c] = (i0 + r < S && gd < D) ? xb[(i0 + r) * ss + gd * sd] : 0.f;
      kj[r][c] = (j0 + r < S && gd < D) ? xb[(j0 + r) * ss + gd * sd] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kTile; ++c) {
      const float kv = kj[tx][c];
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[m] = fmaf(qi[ty + 8 * m][c], kv, acc[m]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + ty + 8 * m, j = j0 + tx;
    if (i < S && j < S) out[((long long)blockIdx.z * S + i) * S + j] = acc[m];
  }
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted. Strides are in
// elements; `head` selects the slice x[:, :, head, :] (the caller passes
// n - 1); out is (B, S, S) f32, contiguous.
extern "C" int headslice_gram_launch(const void* x, void* out, int B, int S,
                                     int N, int D, long long sb,
                                     long long ss, long long sn,
                                     long long sd, int head, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || N <= 0 || D <= 0 || head < 0 || head >= N)
    return (int)cudaErrorInvalidValue;
  dim3 grid((S + kTile - 1) / kTile, (S + kTile - 1) / kTile, B);
  headslice_gram_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(out), S, D, sb, ss,
      sd, (long long)head * sn);
  return (int)cudaGetLastError();
}
