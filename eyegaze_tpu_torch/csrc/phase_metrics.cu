// Pairwise phase metrics (K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel eyegaze_tpu/ops/pallas_kernels.py
// (pairwise_phase_metrics_pallas / _kernel).  For every batch element n and
// channel pair (i, j), with dphi(t) = ph1[n, i, t] - ph2[n, j, t]:
//
//   mean_sgn[n, i, j] = (1/T) sum_t sign(dphi)            sign(0) = 0
//   wnum[n, i, j]     =       sum_t sign(dphi) * (pw1[n, i, t] + pw2[n, j, t]) / 2
//   pdiff[n, i, j]    = (1/T) sum_t |dphi|
//
// What bounds it: it reads 4 * N * C * T floats once (403 MB at N = 768,
// C = 32, T = 1024: six bands of a 128-window serving bucket) and does about N * C^2 * T compare/abs/add/FMA steps on
// the CUDA cores; none of it is a matrix product, so the tensor cores are idle.
//
// Design.  The TPU kernel keeps player 2's (C, T) phase and power blocks
// resident in VMEM; at C = 32, T = 1024 those take 256 KB, more than the
// 227 KB a Hopper block may use.  Here a block owns one n and a 32 x 32 tile
// of (i, j) pairs and walks T in chunks of 64 samples: each chunk of the four
// (32, 64) row slices is staged in shared memory (33 KB, rows padded by one
// float so column reads hit 32 distinct banks), and each of the 256 threads
// keeps the three sums of its 2 x 2 pairs in registers.  Every output is
// written once.  Blocks share no state.  Ragged C and T are masked: rows and
// samples past the edge are staged as zeros, which give dphi = 0 and add
// nothing to any sum, and outputs past the edge are not written.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 32;              // channel pairs per block side
constexpr int kChunk = 64;             // samples staged per pass
constexpr int kPitch = kChunk + 1;     // padded row: conflict-free column reads
constexpr int kThreadsX = 16;
constexpr int kThreadsY = 16;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kPer = kTile / kThreadsX;  // pairs per thread along each side (2)

__device__ __forceinline__ float sign_of(float d) {
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
}

// Copies rows [row0, row0 + kTile) and samples [t0, t0 + kChunk) of one
// (C, T) slice into shared memory, zero past the ragged edges.
__device__ __forceinline__ void stage(float (*dst)[kPitch],
                                      const float* __restrict__ src, int row0,
                                      int c, int t, int t0, int tid) {
  for (int k = tid; k < kTile * kChunk; k += kThreads) {
    const int r = k / kChunk;
    const int col = k % kChunk;
    const int row = row0 + r;
    const int tt = t0 + col;
    dst[r][col] = (row < c && tt < t) ? src[(size_t)row * t + tt] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
phase_metrics_kernel(const float* __restrict__ ph1, const float* __restrict__ ph2,
                     const float* __restrict__ pw1, const float* __restrict__ pw2,
                     float* __restrict__ mean_sgn, float* __restrict__ wnum,
                     float* __restrict__ pdiff, int c, int t) {
  __shared__ float s_ph1[kTile][kPitch];
  __shared__ float s_pw1[kTile][kPitch];
  __shared__ float s_ph2[kTile][kPitch];
  __shared__ float s_pw2[kTile][kPitch];

  const int n = blockIdx.x;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.z * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const size_t slice = (size_t)n * c * t;

  // Thread (tx, ty) owns rows i0 + ty + 16 a and columns j0 + tx + 16 b.
  float acc_s[kPer][kPer] = {};
  float acc_w[kPer][kPer] = {};  // sum of sign * (pw1 + pw2); halved at the end
  float acc_a[kPer][kPer] = {};

  for (int t0 = 0; t0 < t; t0 += kChunk) {
    stage(s_ph1, ph1 + slice, i0, c, t, t0, tid);
    stage(s_pw1, pw1 + slice, i0, c, t, t0, tid);
    stage(s_ph2, ph2 + slice, j0, c, t, t0, tid);
    stage(s_pw2, pw2 + slice, j0, c, t, t0, tid);
    __syncthreads();

    // Per-chunk partial sums, added to the totals once per chunk: a two-level
    // sum keeps the rounding error of the long f32 sums small.
    float part_s[kPer][kPer] = {};
    float part_w[kPer][kPer] = {};
    float part_a[kPer][kPer] = {};
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      float a1[kPer], w1[kPer], a2[kPer], w2[kPer];
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        a1[r] = s_ph1[ty + kThreadsY * r][k];
        w1[r] = s_pw1[ty + kThreadsY * r][k];
        a2[r] = s_ph2[tx + kThreadsX * r][k];
        w2[r] = s_pw2[tx + kThreadsX * r][k];
      }
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
#pragma unroll
        for (int b = 0; b < kPer; ++b) {
          const float d = a1[a] - a2[b];
          const float s = sign_of(d);
          part_s[a][b] += s;
          part_a[a][b] += fabsf(d);
          part_w[a][b] += s * (w1[a] + w2[b]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
#pragma unroll
      for (int b = 0; b < kPer; ++b) {
        acc_s[a][b] += part_s[a][b];
        acc_w[a][b] += part_w[a][b];
        acc_a[a][b] += part_a[a][b];
      }
    }
    __syncthreads();
  }

  const float tf = (float)t;  // divide, as the plain mean does
  const size_t out = (size_t)n * c * c;
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int i = i0 + ty + kThreadsY * a;
#pragma unroll
    for (int b = 0; b < kPer; ++b) {
      const int j = j0 + tx + kThreadsX * b;
      if (i < c && j < c) {
        const size_t o = out + (size_t)i * c + j;
        mean_sgn[o] = acc_s[a][b] / tf;
        wnum[o] = acc_w[a][b] * 0.5f;  // exact: scaling by a power of two
        pdiff[o] = acc_a[a][b] / tf;
      }
    }
  }
}

}  // namespace

extern "C" int phase_metrics_launch(const float* ph1, const float* ph2,
                                    const float* pw1, const float* pw2,
                                    float* mean_sgn, float* wnum, float* pdiff,
                                    int n, int c, int t, void* stream) {
  const int tiles = (c + kTile - 1) / kTile;
  const dim3 grid(n, tiles, tiles);
  const dim3 block(kThreadsX, kThreadsY);
  phase_metrics_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      ph1, ph2, pw1, pw2, mean_sgn, wnum, pdiff, c, t);
  return static_cast<int>(cudaGetLastError());
}
