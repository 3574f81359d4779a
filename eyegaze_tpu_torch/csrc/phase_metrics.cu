// Pairwise phase metrics for Hopper, sm_90a: K1 and its widened form K2.
//
// K1 replaces the Pallas TPU kernel eyegaze_tpu/ops/pallas_kernels.py
// (pairwise_phase_metrics_pallas / _kernel).  For every batch element n and
// channel pair (i, j), with dphi(t) = ph1[n, i, t] - ph2[n, j, t]:
//
//   mean_sgn[n, i, j] = (1/T) sum_t sign(dphi)            sign(0) = 0
//   wnum[n, i, j]     =       sum_t sign(dphi) * (pw1[n, i, t] + pw2[n, j, t]) / 2
//   pdiff[n, i, j]    = (1/T) sum_t |dphi|
//
// K2 replaces pairwise_phase_plv_metrics_pallas / _kernel5 of the same file:
// K1's three sums plus the PLV partial means
//
//   plv_re[n, i, j]   = (1/T) sum_t cos(dphi)
//   plv_im[n, i, j]   = (1/T) sum_t sin(dphi)
//
// so that PLV = sqrt(plv_re^2 + plv_im^2).
//
// What bounds them: each reads 4 * N * C * T floats once (403 MB at N = 768,
// C = 32, T = 1024: six bands of a 128-window serving bucket) and does about
// N * C^2 * T compare/abs/add/FMA steps on the CUDA cores (K2 four FMAs more
// per pair and sample); none of it is a matrix product, so the tensor cores
// are idle.
//
// Design.  The TPU kernel keeps player 2's (C, T) phase and power blocks
// resident in VMEM; at C = 32, T = 1024 those take 256 KB, more than the
// 227 KB a Hopper block may use.  Here a block owns one n and a 32 x 32 tile
// of (i, j) pairs and walks T in chunks: each chunk of the (32, chunk) row
// slices is staged in shared memory (rows padded by one float so column
// reads hit 32 distinct banks), and each of the 256 threads keeps the sums of
// its 2 x 2 pairs in registers.  Every output is written once.  Blocks share
// no state.  Ragged C and T are masked: rows and samples past the edge are
// staged as zeros, which give dphi = 0 and add nothing to the sign and |dphi|
// sums, and outputs past the edge are not written.
//
// K2 takes cos and sin of each staged phase once, with the accurate sincosf
// (the build has no --use_fast_math), and forms the pair terms from
//   cos(a - b) = cos a cos b + sin a sin b,  sin(a - b) = sin a cos b - cos a sin b,
// four FMAs per pair and sample in place of a cos and a sin of every
// difference (N * C^2 * T of each, 805 M at N = 768).  The two forms agree
// to a few float32 ulps per term.  Samples past a ragged T stage cos = sin =
// 0, not cos(0) = 1, so they add nothing to plv_re either.  Staging cos and
// sin of both players doubles the staged arrays, so K2 walks T in chunks of
// 32: eight (32, 33) tiles are 33,792 bytes, inside the 48 KB of static
// shared memory, where chunks of 64 would need 66,560.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 32;              // channel pairs per block side
constexpr int kThreadsX = 16;
constexpr int kThreadsY = 16;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kPer = kTile / kThreadsX;  // pairs per thread along each side (2)

// K1 stages four arrays (ph1, pw1, ph2, pw2) in chunks of 64 samples; K2
// four more (cos and sin of both phases) in chunks of 32.
template <bool kPlv>
struct Config {
  static constexpr int kChunk = kPlv ? 32 : 64;  // samples staged per pass
  static constexpr int kPitch = kChunk + 1;      // padded row: conflict-free column reads
  static constexpr int kArrays = kPlv ? 8 : 4;
};

__device__ __forceinline__ float sign_of(float d) {
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
}

// Copies rows [row0, row0 + kTile) and samples [t0, t0 + kChunk) of one
// (C, T) slice into shared memory, zero past the ragged edges.
template <int kPitch>
__device__ __forceinline__ void stage(float (*dst)[kPitch],
                                      const float* __restrict__ src, int row0,
                                      int c, int t, int t0, int tid) {
  constexpr int kChunk = kPitch - 1;
  for (int k = tid; k < kTile * kChunk; k += kThreads) {
    const int r = k / kChunk;
    const int col = k % kChunk;
    const int row = row0 + r;
    const int tt = t0 + col;
    dst[r][col] = (row < c && tt < t) ? src[(size_t)row * t + tt] : 0.f;
  }
}

// As stage, for a phase slice: also writes its cos and sin, all three zero
// past the ragged edges.
template <int kPitch>
__device__ __forceinline__ void stage_phase(float (*ph)[kPitch], float (*cs)[kPitch],
                                            float (*sn)[kPitch],
                                            const float* __restrict__ src, int row0,
                                            int c, int t, int t0, int tid) {
  constexpr int kChunk = kPitch - 1;
  for (int k = tid; k < kTile * kChunk; k += kThreads) {
    const int r = k / kChunk;
    const int col = k % kChunk;
    const int row = row0 + r;
    const int tt = t0 + col;
    float v = 0.f, s = 0.f, co = 0.f;
    if (row < c && tt < t) {
      v = src[(size_t)row * t + tt];
      sincosf(v, &s, &co);
    }
    ph[r][col] = v;
    cs[r][col] = co;
    sn[r][col] = s;
  }
}

template <bool kPlv>
__global__ void __launch_bounds__(kThreads)
phase_metrics_kernel(const float* __restrict__ ph1, const float* __restrict__ ph2,
                     const float* __restrict__ pw1, const float* __restrict__ pw2,
                     float* __restrict__ mean_sgn, float* __restrict__ wnum,
                     float* __restrict__ pdiff, float* __restrict__ plv_re,
                     float* __restrict__ plv_im, int c, int t) {
  constexpr int kChunk = Config<kPlv>::kChunk;
  constexpr int kPitch = Config<kPlv>::kPitch;
  __shared__ float smem[Config<kPlv>::kArrays][kTile][kPitch];
  float (*s_ph1)[kPitch] = smem[0];
  float (*s_pw1)[kPitch] = smem[1];
  float (*s_ph2)[kPitch] = smem[2];
  float (*s_pw2)[kPitch] = smem[3];

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
  float acc_re[kPer][kPer] = {};  // K2 only
  float acc_im[kPer][kPer] = {};

  for (int t0 = 0; t0 < t; t0 += kChunk) {
    if constexpr (kPlv) {
      stage_phase<kPitch>(s_ph1, smem[4], smem[5], ph1 + slice, i0, c, t, t0, tid);
    } else {
      stage<kPitch>(s_ph1, ph1 + slice, i0, c, t, t0, tid);
    }
    stage<kPitch>(s_pw1, pw1 + slice, i0, c, t, t0, tid);
    if constexpr (kPlv) {
      stage_phase<kPitch>(s_ph2, smem[6], smem[7], ph2 + slice, j0, c, t, t0, tid);
    } else {
      stage<kPitch>(s_ph2, ph2 + slice, j0, c, t, t0, tid);
    }
    stage<kPitch>(s_pw2, pw2 + slice, j0, c, t, t0, tid);
    __syncthreads();

    // Per-chunk partial sums, added to the totals once per chunk: a two-level
    // sum keeps the rounding error of the long f32 sums small.
    float part_s[kPer][kPer] = {};
    float part_w[kPer][kPer] = {};
    float part_a[kPer][kPer] = {};
    float part_re[kPer][kPer] = {};
    float part_im[kPer][kPer] = {};
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
      if constexpr (kPlv) {
        float c1[kPer], s1[kPer], c2[kPer], s2[kPer];
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          c1[r] = smem[4][ty + kThreadsY * r][k];
          s1[r] = smem[5][ty + kThreadsY * r][k];
          c2[r] = smem[6][tx + kThreadsX * r][k];
          s2[r] = smem[7][tx + kThreadsX * r][k];
        }
#pragma unroll
        for (int a = 0; a < kPer; ++a) {
#pragma unroll
          for (int b = 0; b < kPer; ++b) {
            part_re[a][b] = fmaf(c1[a], c2[b], fmaf(s1[a], s2[b], part_re[a][b]));
            part_im[a][b] = fmaf(s1[a], c2[b], fmaf(-c1[a], s2[b], part_im[a][b]));
          }
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
        if constexpr (kPlv) {
          acc_re[a][b] += part_re[a][b];
          acc_im[a][b] += part_im[a][b];
        }
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
        if constexpr (kPlv) {
          plv_re[o] = acc_re[a][b] / tf;
          plv_im[o] = acc_im[a][b] / tf;
        }
      }
    }
  }
}

template <bool kPlv>
int launch(const float* ph1, const float* ph2, const float* pw1, const float* pw2,
           float* mean_sgn, float* wnum, float* pdiff, float* plv_re, float* plv_im,
           int n, int c, int t, void* stream) {
  const int tiles = (c + kTile - 1) / kTile;
  const dim3 grid(n, tiles, tiles);
  const dim3 block(kThreadsX, kThreadsY);
  phase_metrics_kernel<kPlv><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      ph1, ph2, pw1, pw2, mean_sgn, wnum, pdiff, plv_re, plv_im, c, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: three (N, C, C) outputs.
extern "C" int phase_metrics_launch(const float* ph1, const float* ph2,
                                    const float* pw1, const float* pw2,
                                    float* mean_sgn, float* wnum, float* pdiff,
                                    int n, int c, int t, void* stream) {
  return launch<false>(ph1, ph2, pw1, pw2, mean_sgn, wnum, pdiff, nullptr, nullptr,
                       n, c, t, stream);
}

// K2: K1's three outputs plus plv_re and plv_im.
extern "C" int phase_plv_metrics_launch(const float* ph1, const float* ph2,
                                        const float* pw1, const float* pw2,
                                        float* mean_sgn, float* wnum, float* pdiff,
                                        float* plv_re, float* plv_im,
                                        int n, int c, int t, void* stream) {
  return launch<true>(ph1, ph2, pw1, pw2, mean_sgn, wnum, pdiff, plv_re, plv_im,
                      n, c, t, stream);
}
