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
// C = 32, T = 1024: six bands of a 128-window serving bucket) and issues 7
// FP32 instructions per pair and sample (K1: the difference, the sign as a
// compare and a sign-bit OR, the sign sum, the |dphi| sum, two FMAs for
// sign * pw1 and sign * pw2) or 11 (K2: four FMAs more), each one lane-cycle
// of the SM's 128 FP32 lanes; none of it is a matrix product, so the tensor
// cores are idle.  At N = 768 the 7 lane-cycles take 0.168 ms on 132 SMs at
// 1.98 GHz and the bytes 0.123 ms, so the read has to overlap the
// arithmetic.
//
// Design.  A block owns one n, a 32 x 32 tile of (i, j) pairs, and a share of
// T.  It walks its share in chunks of 32 samples, each staged in shared
// memory as (32, 36)-float row slices of ph1, pw1, ph2 and pw2 by 16-byte
// cp.async copies into a ring of kStages stages, so the next chunk loads
// while this one computes (the src-size-0 form zero-fills rows and samples
// past the ragged edge).  Where a row is not 16-byte aligned (T % 4 != 0 or
// an input pointer off 16 bytes) the same kernel stages element by element.
// The row pitch of 36 floats puts the 8 rows a quarter-warp reads with one
// 16-byte load on 8 distinct groups of 4 banks.
//
// Two groups of 128 threads split each chunk's samples.  In a group each
// thread owns 4 x 2 pairs and reads each staged row as a float4 of four
// samples, so a 16-byte load feeds 2 or 4 pairs for four samples: 0.375
// loads per pair and sample in K1, 0.75 in K2 (cos and sin staged too).
// |dphi| sums go through a per-chunk partial (a two-level sum keeps the
// 1,024-term f32 sums within 1e-5 of the plain version); the sign sums are
// exact.  On the card a 4 x 4 tile (128 threads, 0.25 loads) was slower in
// both: K1 needed 160 registers (capped at 128 it spilled its accumulators),
// K2 252, and the lower occupancy cost more than the loads saved.
//
// Where N x (C / 32)^2 blocks would leave SMs idle (N = 48, the one-trial
// request), the launch splits T over S <= 8 blocks of one thread-block
// cluster (phase_metrics_split reports S).  Each block sums its share into
// shared memory; then every block of the cluster sums a slice of the tile
// over the cluster's blocks through distributed shared memory, always in
// rank order, and writes that slice.  No atomics: every launch of one shape
// gives the same bits.
//
// K2 takes cos and sin of each staged phase once, with the accurate sincosf
// (the build has no --use_fast_math), in a shared-to-shared pass after the
// chunk arrives, and forms the pair terms from
//   cos(a - b) = cos a cos b + sin a sin b,  sin(a - b) = sin a cos b - cos a sin b,
// four FMAs per pair and sample in place of a cos and a sin of every
// difference.  The two forms agree to a few float32 ulps per term.  Samples
// past a ragged T get cos = sin = 0, not cos(0) = 1, so they add nothing to
// plv_re either.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or the launch's own error) so the caller can
// raise on a refused launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;             // channel pairs per block side
constexpr int kChunk = 32;            // samples per stage
constexpr int kPitch = kChunk + 4;    // floats per staged row (see the header)
constexpr int kTileFloats = kTile * kPitch;
constexpr int kVecsPerRow = kChunk / 4;
constexpr int kGroups = 2;            // thread groups splitting each chunk's samples
constexpr int kGroupSamples = kChunk / kGroups;
constexpr int kStages = 2;
constexpr int kSplitMax = 8;          // the portable cluster size

template <bool kPlv>
struct Shape {
  static constexpr int kRows = 4;  // pairs per thread along i
  static constexpr int kCols = 2;  // pairs per thread along j
  static constexpr int kThreadsX = kTile / kCols;
  static constexpr int kThreadsY = kTile / kRows;
  static constexpr int kGroupThreads = kThreadsX * kThreadsY;
  static constexpr int kThreads = kGroups * kGroupThreads;  // 256
  static constexpr int kMinBlocks = 2;                      // at most 128 registers
  static constexpr int kFillThreads = 512;  // threads per SM the T split aims for
  static constexpr int kOuts = kPlv ? 5 : 3;
  static constexpr int kStageFloats = 4 * kTileFloats;      // ph1, pw1, ph2, pw2
  static constexpr int kTrigFloats = kPlv ? 4 * kTileFloats : 0;  // cos, sin of both
  static constexpr int kLoopFloats = kStages * kStageFloats + kTrigFloats;
  static constexpr int kReduceFloats = kOuts * kTile * kTile;
  static constexpr int kSmemBytes =
      4 * (kLoopFloats > kReduceFloats ? kLoopFloats : kReduceFloats);
  static_assert(kTile * kVecsPerRow % kThreads == 0, "staging");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows row0 .. row0 + 31 and samples t0 .. t0 + kChunk - 1 of one (C, T)
// slice into a staged tile, zero past the ragged edges.  With `vec` (T % 4 ==
// 0 and the slice 16-byte aligned) by 16-byte cp.async copies, else element
// by element and synchronously.
template <int kThreads>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int row0, int c,
                                      int t, int t0, int tid, bool vec) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < kTile * kVecsPerRow / kThreads; ++k) {
      const int e = tid + k * kThreads;
      const int r = e / kVecsPerRow;
      const int v = e % kVecsPerRow;
      const int row = row0 + r;
      const int tt = t0 + 4 * v;
      const bool valid = row < c && tt < t;
      cp_async16(dst + r * kPitch + 4 * v, valid ? src + (size_t)row * t + tt : src, valid);
    }
  } else {
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk;
      const int col = e % kChunk;
      const int row = row0 + r;
      const int tt = t0 + col;
      dst[r * kPitch + col] = (row < c && tt < t) ? src[(size_t)row * t + tt] : 0.f;
    }
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float part(const float4& v, int e) {  // e is a constant once unrolled
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// sign(d) in two instructions: 1.0f where d != 0 (PTX set), then d's sign bit.
__device__ __forceinline__ float sign_of(float d) {
  float nz;
  asm("set.neu.f32.f32 %0, %1, 0f00000000;\n" : "=f"(nz) : "f"(d));
  return __int_as_float(__float_as_int(nz) | (__float_as_int(d) & 0x80000000));
}

template <bool kPlv>
__global__ void __launch_bounds__(Shape<kPlv>::kThreads, Shape<kPlv>::kMinBlocks)
phase_metrics_kernel(const float* __restrict__ ph1, const float* __restrict__ ph2,
                     const float* __restrict__ pw1, const float* __restrict__ pw2,
                     float* __restrict__ mean_sgn, float* __restrict__ wnum,
                     float* __restrict__ pdiff, float* __restrict__ plv_re,
                     float* __restrict__ plv_im, int c, int t, int split, bool vec) {
  using S = Shape<kPlv>;
  constexpr int R = S::kRows;
  constexpr int C = S::kCols;
  extern __shared__ __align__(16) float smem[];

  const int rank = blockIdx.x % split;  // the block's rank in its cluster
  const int n = blockIdx.x / split;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.z * kTile;
  const int tid = threadIdx.x;
  const int g = tid / S::kGroupThreads;
  const int tx = tid % S::kGroupThreads % S::kThreadsX;
  const int ty = tid % S::kGroupThreads / S::kThreadsX;
  const size_t slice = (size_t)n * c * t;

  // This block's chunks of T: [k0, k1).
  const int chunks = (t + kChunk - 1) / kChunk;
  const int per = (chunks + split - 1) / split;
  const int k0 = rank * per;
  const int k1 = min(chunks, k0 + per);

  auto load = [&](int chunk, int buf) {
    float* dst = smem + buf * S::kStageFloats;
    const int t0 = chunk * kChunk;
    stage<S::kThreads>(dst, ph1 + slice, i0, c, t, t0, tid, vec);
    stage<S::kThreads>(dst + kTileFloats, pw1 + slice, i0, c, t, t0, tid, vec);
    stage<S::kThreads>(dst + 2 * kTileFloats, ph2 + slice, j0, c, t, t0, tid, vec);
    stage<S::kThreads>(dst + 3 * kTileFloats, pw2 + slice, j0, c, t, t0, tid, vec);
  };

  // Thread (tx, ty) of group g owns rows i0 + ty + kThreadsY a and columns
  // j0 + tx + kThreadsX b, over samples g * 16 .. g * 16 + 15 of each chunk.
  float acc_s[R][C] = {};
  float acc_w[R][C] = {};  // sum of sign * pw1 + sign * pw2; halved at the end
  float acc_a[R][C] = {};
  float acc_re[R][C] = {};  // K2 only
  float acc_im[R][C] = {};

  // A ring of kStages chunks: kStages - 1 in flight while one computes.  One
  // commit group per chunk, empty past the end, so wait_group counts chunks.
  const int count = k1 - k0;
  float* trig = smem + kStages * S::kStageFloats;  // K2: cos1, sin1, cos2, sin2 of the chunk
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < count) load(k0 + s, s);
    cp_async_commit();
  }
  for (int k = 0; k < count; ++k) {
    if (k + kStages - 1 < count) load(k0 + k + kStages - 1, (k + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // chunk k has landed
    __syncthreads();
    const float* st = smem + k % kStages * S::kStageFloats;
    if constexpr (kPlv) {
      const int t0 = (k0 + k) * kChunk;
      for (int e = tid; e < 2 * kTile * kChunk; e += S::kThreads) {
        const int p = e / (kTile * kChunk);  // 0: player 1, 1: player 2
        const int r = e / kChunk % kTile;
        const int col = e % kChunk;
        const int at = r * kPitch + col;
        float sn = 0.f, cs = 0.f;  // zero past the ragged edges
        if ((p ? j0 : i0) + r < c && t0 + col < t) {
          sincosf(st[2 * p * kTileFloats + at], &sn, &cs);
        }
        trig[2 * p * kTileFloats + at] = cs;
        trig[(2 * p + 1) * kTileFloats + at] = sn;
      }
      __syncthreads();
    }

    // Per-chunk partial |dphi| sums, added to the totals once per chunk.
    float part_a[R][C] = {};
#pragma unroll
    for (int q = 0; q < kGroupSamples / 4; ++q) {
      const int col = g * kGroupSamples + 4 * q;
      float4 b_ph[C], b_pw[C], b_c[C], b_s[C];
#pragma unroll
      for (int b = 0; b < C; ++b) {
        const int at = (tx + S::kThreadsX * b) * kPitch + col;
        b_ph[b] = lds4(st + 2 * kTileFloats + at);
        b_pw[b] = lds4(st + 3 * kTileFloats + at);
        if constexpr (kPlv) {
          b_c[b] = lds4(trig + 2 * kTileFloats + at);
          b_s[b] = lds4(trig + 3 * kTileFloats + at);
        }
      }
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int at = (ty + S::kThreadsY * a) * kPitch + col;
        const float4 a_ph = lds4(st + at);
        const float4 a_pw = lds4(st + kTileFloats + at);
        float4 a_c, a_s;
        if constexpr (kPlv) {
          a_c = lds4(trig + at);
          a_s = lds4(trig + kTileFloats + at);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int b = 0; b < C; ++b) {
            const float d = part(a_ph, e) - part(b_ph[b], e);
            const float s = sign_of(d);
            acc_s[a][b] += s;
            part_a[a][b] += fabsf(d);
            acc_w[a][b] = fmaf(s, part(a_pw, e), acc_w[a][b]);
            acc_w[a][b] = fmaf(s, part(b_pw[b], e), acc_w[a][b]);
            if constexpr (kPlv) {
              const float c1 = part(a_c, e), s1 = part(a_s, e);
              const float c2 = part(b_c[b], e), s2 = part(b_s[b], e);
              acc_re[a][b] = fmaf(c1, c2, fmaf(s1, s2, acc_re[a][b]));
              acc_im[a][b] = fmaf(s1, c2, fmaf(-c1, s2, acc_im[a][b]));
            }
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int b = 0; b < C; ++b) acc_a[a][b] += part_a[a][b];
    }
    __syncthreads();  // before a later load overwrites this stage
  }
  cp_async_wait<0>();

  // The groups' sums into one tile of shared memory, [output][i][j]: the last
  // group stores, the others add in turn (the stages are free: every copy
  // has landed and every thread is past the loop).
  float* red = smem;
  constexpr int kPlane = kTile * kTile;
  constexpr int kSums = S::kOuts * kPlane;
  for (int pass = kGroups - 1; pass >= 0; --pass) {
    if (g == pass) {
#pragma unroll
      for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int b = 0; b < C; ++b) {
          float* p = red + (ty + S::kThreadsY * a) * kTile + tx + S::kThreadsX * b;
          const float v[5] = {acc_s[a][b], acc_w[a][b], acc_a[a][b], acc_re[a][b], acc_im[a][b]};
#pragma unroll
          for (int o = 0; o < S::kOuts; ++o) {
            p[o * kPlane] = pass == kGroups - 1 ? v[o] : p[o * kPlane] + v[o];
          }
        }
      }
    }
    __syncthreads();
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1) cluster.sync();  // every block's tile of sums is in its shared memory

  // Rank r of the cluster sums every split-th run of kThreads sums over the
  // ranks, in rank order (the same bits every launch), and writes them.
  const float tf = (float)t;  // divide, as the plain mean does
  const size_t out = (size_t)n * c * c;
  for (int e = rank * S::kThreads + tid; e < kSums; e += split * S::kThreads) {
    float v = red[e];
    if (split > 1) {
      v = *cluster.map_shared_rank(red + e, 0);
      for (int r = 1; r < split; ++r) v += *cluster.map_shared_rank(red + e, r);
    }
    const int o = e / kPlane;
    const int i = i0 + e % kPlane / kTile;
    const int j = j0 + e % kTile;
    if (i < c && j < c) {
      const size_t at = out + (size_t)i * c + j;
      switch (o) {
        case 0: mean_sgn[at] = v / tf; break;
        case 1: wnum[at] = v * 0.5f; break;  // exact: scaling by a power of two
        case 2: pdiff[at] = v / tf; break;
        case 3: plv_re[at] = v / tf; break;
        default: plv_im[at] = v / tf; break;
      }
    }
  }
  if (split > 1) cluster.sync();  // no block leaves while another reads its sums
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Blocks of one cluster that split T: the least S in {1, 2, 4, 8} whose grid
// gives every SM kFillThreads threads, while each block keeps a chunk.  K1
// and K2 have one block shape, so one rule serves both.
int split_for(int n, int c, int t, int sms) {
  using S = Shape<false>;
  static_assert(S::kThreads == Shape<true>::kThreads, "one block shape");
  const long long tiles = (c + kTile - 1) / kTile;
  const long long base = (long long)n * tiles * tiles * S::kThreads;
  const int chunks = (t + kChunk - 1) / kChunk;
  int s = 1;
  while (s < kSplitMax && base * s < (long long)S::kFillThreads * sms && 2 * s <= chunks &&
         (long long)n * 2 * s <= INT_MAX) {
    s *= 2;
  }
  return s;
}

bool aligned16(const float* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

template <bool kPlv>
cudaError_t launch(const float* ph1, const float* ph2, const float* pw1, const float* pw2,
                   float* mean_sgn, float* wnum, float* pdiff, float* plv_re, float* plv_im,
                   int n, int c, int t, cudaStream_t stream) {
  using S = Shape<kPlv>;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  if (S::kSmemBytes > 48 * 1024) {  // above the default: opt in, once per device
    static std::atomic<unsigned long long> opted_in{0};
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !((opted_in.load() >> dev) & 1ull)) {
      err = cudaFuncSetAttribute(phase_metrics_kernel<kPlv>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
      if (err != cudaSuccess) return err;
      if (dev < 64) opted_in.fetch_or(1ull << dev);
    }
  }
  const int split = split_for(n, c, t, sms);
  const bool vec = t % 4 == 0 && aligned16(ph1) && aligned16(ph2) && aligned16(pw1) &&
                   aligned16(pw2);
  const int tiles = (c + kTile - 1) / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * split, tiles, tiles);
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = S::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, phase_metrics_kernel<kPlv>, ph1, ph2, pw1, pw2, mean_sgn, wnum,
                           pdiff, plv_re, plv_im, c, t, split, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// K1: three (N, C, C) outputs.
extern "C" int phase_metrics_launch(const float* ph1, const float* ph2,
                                    const float* pw1, const float* pw2,
                                    float* mean_sgn, float* wnum, float* pdiff,
                                    int n, int c, int t, void* stream) {
  return static_cast<int>(launch<false>(ph1, ph2, pw1, pw2, mean_sgn, wnum, pdiff, nullptr,
                                        nullptr, n, c, t, static_cast<cudaStream_t>(stream)));
}

// K2: K1's three outputs plus plv_re and plv_im.
extern "C" int phase_plv_metrics_launch(const float* ph1, const float* ph2,
                                        const float* pw1, const float* pw2,
                                        float* mean_sgn, float* wnum, float* pdiff,
                                        float* plv_re, float* plv_im,
                                        int n, int c, int t, void* stream) {
  return static_cast<int>(launch<true>(ph1, ph2, pw1, pw2, mean_sgn, wnum, pdiff, plv_re,
                                       plv_im, n, c, t, static_cast<cudaStream_t>(stream)));
}

// Blocks S of one cluster over which a launch of K1 or K2 at this shape
// splits T on the current device, or -1 if the device cannot be read.
extern "C" int phase_metrics_split(int n, int c, int t) {
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  return split_for(n, c, t, sms);
}
