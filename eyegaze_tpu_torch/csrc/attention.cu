// Softmax attention (K3 and K4) for Hopper, sm_90a.
//
// Replaces two TPU kernels that compute the same function in two layouts:
//   K3  eyegaze_tpu/ops/attn_kernels.py (_headpacked_fwd_impl / _mha_kernel),
//       (B, T, H, d) in and out;
//   K4  the stock jax.experimental.pallas.ops.tpu.flash_attention called at
//       eyegaze_tpu/models/transformer.py:232, (B, H, T, d), no bias, no
//       segment ids, not causal.
// For one batch element b and head h, with s = (q . k) * scale:
//
//   o[b, i, h, :] = sum_j softmax_j(s[i, j]) * v[b, j, h, :]
//
// Numerics, the contract of the JAX einsum path: operands f32 or bf16; the
// scores, the softmax and the PV sums in f32; each probability rounded to the
// operand type before it multiplies V (exact for f32); output in the operand
// type.  Both layouts launch the kernel of their type with their own element
// strides of the batch, time and head axes; the head dim must have stride 1.
// The TPU kernel keeps a whole (128, Tk) f32 score tile in VMEM, 512 KB at
// Tk = 1024, more than twice the 227 KB of shared memory a Hopper block may
// use.  Here nothing of size Tk is kept: a block owns 64 query rows (64 R in
// the f32 instance) of one (b, h), walks the keys in tiles staged in shared
// memory, two at a time, and runs an online softmax over them (a running max
// and sum per row; the output sums are rescaled when the max grows), so any
// Tk works.  The exponentials are base
// 2 with log2(e) folded into the scale.  Each probability is rounded before
// the PV product as the plain version rounds it, but unnormalised (divided
// by the row sum at the end), so the two differ by at most one bf16 rounding
// per probability.  Ragged edges: keys past Tk are staged as zeros and weigh
// nothing; query rows past Tq compute on zeros and are not written.
//
// What bounds each instance on an H100, per (B, H, Tq, Tk, d) call: 4 B H Tq
// Tk d matmul operations and B H Tq Tk exponentials against only the bytes
// of Q, K, V and O (at ART's (32, 8, 1024, 16), 17 GFLOP and 268 M
// exponentials against 8 MB in f32), so operations, never device memory.
//
// f32 (attention_kernel_f32<D, R>): the FMAs on the CUDA cores (67 TFLOP/s;
// TF32 tensor cores would change the numerics, and no f32 instance holds a
// tensor-core instruction).  A score costs 2 d FMAs, so the FMA pipe, and the
// issue slots it shares with every other instruction, set the pace: the
// design spends as few non-FMA instructions per score as it can.
//   Rows per thread: a thread owns R query rows (R = 4 at d = 16, 2 at d =
//   32), keeping their q and output sums in registers, so each 16-byte load
//   of a staged key feeds 4 R FMAs (one row fed 4, and the loads took about a
//   fifth of the issue slots).  A block is 64 row groups, 64 R rows.  Above
//   d = 32, R = 1 and a row is split over d / 32 neighbouring threads that
//   add their partial dot products with shuffles (q and the sums of a whole
//   row at d = 128 would take 256 of a thread's 255 registers).  At R > 1 a
//   small grid leaves SMs idle (ART's B = 1 gives 32 blocks at R = 4), so the
//   launch takes R > 1 only where that grid gives each SM a block, else R = 1.
//   Staging: K and V come in tiles of 64 keys (2048 / d above d = 32), staged
//   as f32 by 16-byte cp.async copies into two buffers, so tile j + 1 loads
//   while tile j computes.  When a K or V row is not 16-byte aligned (a
//   pointer or a stride that is not a multiple of 4 floats) the same tiles
//   are staged element by element instead.  Every lane of a warp reads the
//   same staged key (a broadcast); above d = 32 each 32-wide slice of a
//   staged key sits 4 floats from the next, so the slices read at once fall
//   in different banks.
//   Softmax: the keys of a tile go in chunks of 16 (8 at R = 4, for
//   registers): R x chunk raw scores, the chunk max, one rescale of the sums,
//   then per score one FFMA (scale and max folded; a negative scale flips
//   q's sign, as in the bf16 instance) and one ex2.approx on the SFU.  Keys
//   past tk are masked only in the last tile.
//
// bf16 (attention_kernel_bf16<D>): the tensor cores (989 TFLOP/s dense), and
// at d = 16, where a score costs 32 tensor-core operations, the exponentials:
// the SFU returns 16 a clock per SM, about 4.2e12 a second, so 268 M take
// 0.064 ms, 3.7x the 0.017 ms of the operations.  That is this design's
// floor, not the card's: the FMA pipes could compute part of the
// exponentials as a polynomial, as FlashAttention-3 does.  The design is
// FlashAttention-2's: 4 warps own 16 query rows each and keep their Q
// fragments in registers for the whole walk; K and V come in tiles of 64
// keys, staged as bf16 with cp.async (16 bytes a thread) into two buffers,
// so tile j + 1 loads while tile j computes; S = Q K^T and O += P V are
// mma.sync m16n8k16 bf16 products with f32 accumulators, their fragments
// loaded with ldmatrix (V with .trans, so it is read in its (key, d) layout),
// each 16-byte chunk of a staged row XOR-swizzled so that the eight rows an
// ldmatrix phase reads fall in eight different bank groups.  The softmax runs
// in registers: per score one FFMA (scale and max folded) and one ex2, the
// row max and sum reduced over the 4 threads that share a row; P is rounded
// to bf16 in registers and used as the A fragment of the PV product (the
// m16n8k16 accumulator layout is the A layout).  Registers: at d = 128 the
// output sums take 64 a thread, the Q fragments 32, the scores 32.  Shared
// memory: Q plus two stages of K and V, 640 d bytes (80 KB at d = 128, above
// the 48 KB default, so that instance is opted in once per device).  A bf16
// launch wants every row 16-byte aligned: pointers 16-byte aligned and all
// strides multiples of 8 elements (the wrapper checks).
//
// K4's backward, bf16, one C entry (attention_backward_launch) and three
// paths, chosen by shape (backward_path; never as a fallback when a build or
// a launch fails).  All replace the stock Pallas _flash_attention_bwd_dkv
// and _flash_attention_bwd_dq of the installed jax/experimental/pallas/ops/
// tpu/flash_attention.py (:941, :1287, reached from _flash_attention_bwd
// :254), and compute what they compute: S from the bf16 operands in f32
// times the scale, P = exp(S - LSE) in f32 from the forward's row
// log-sum-exp (which the forward writes when asked, base 2), Di = sum_d O dO
// in f32 from the bf16 output, dV = bf16(P)^T dO, dP = dO V^T, dS = (dP - Di)
// P scale, dK = bf16(dS)^T Q, dQ = bf16(dS) K, every sum in f32.  Nothing is
// summed with atomics, so every run gives the same bits, as JAX's backward
// does: each gradient element is written once, by one thread, from sums
// taken in a fixed order.
//
// What bounds it on an H100: the five products, 10 B H Tq Tk d operations on
// the tensor cores (at ART's training shape (16, 8, 1024, 16) and at K4's
// (2, 8, 1024, 128) 2.15e10, 0.022 ms at 989 TFLOP/s) against 35 MB; the B H
// Tq Tk exponentials on the SFU (16 a clock per SM: 0.032 ms at ART's shape
// for one each); and at d = 16, where a score costs 32 tensor-core
// operations, the issue of the per-score work, about ten instructions a
// score and thread (FFMA, ex2, the dS arithmetic, the bf16 packing, the
// products' share).  A pass that computes each score once does that work
// once, but must sum dQ over the key blocks; here a thread-block cluster of
// at most 8 blocks of 128 keys owns a head (so Tk <= 1024) and sums its
// blocks' f32 partial dQ tiles through distributed shared memory, each
// block a C-th of the rows, in rank order: no atomics and no f32 dQ in
// device memory.  That sum moves (C - 1) / C of a 64- or 128-query f32 tile
// into each block per tile, and the SM-to-SM network carries about 7 bytes
// a clock into an SM (PERF.md, Findings): about 4,000 cycles a 64-query
// tile at d = 128, as long as the tile's products and per-score work.
//
// The one-pass path on mma.sync (attention_bwd_one_pass_kernel<16>): d = 16,
// Tk <= 1024 (ART's self- and cross-attention).  Copies, the cluster's
// arrivals and the sums run in their own warps, against mbarriers, so the 8
// consumer warps wait on the cluster only when a block falls 4 tiles behind.
// Its products are mma.sync m16n8k16: wgmma's 64-row tiles would cover the
// 16 keys of a warp 4 times over, and at d = 16 the SFU and the issue of the
// per-score work, not the tensor cores, set the pace.  A copier warp with
// cp.async and two stages keeps up: the consumers wait about 100 cycles of
// a 4,000-cycle tile for data.
//
// The one-pass path on wgmma (attention_bwd_one_pass_wgmma_kernel<64>): d =
// 64, Tk <= 1024.  Two consumer warpgroups of 64 keys run m64nNk16 wgmma
// from shared-memory descriptors, P^T and dS^T from registers; the query
// tiles come by TMA, one thread's copies, where per-thread cp.async of the
// 16-32 KB tiles held the consumers up; two buffers, as the consumers wait
// about 250 cycles of a 3,000-cycle tile for them (and at d = 128 a third
// would not fit); setmaxnreg hands the fourth warpgroup's registers to the
// consumers.  At d = 128 the same
// kernel is correct but slower than the two-kernel path (PERF.md): the
// cluster's dQ sum sets its pace, and the 16 clusters of 8 blocks that the
// 16 heads of K4's shape need do not all run at once.
//
// The two-kernel path (attention_bwd_dq_kernel<D>, attention_bwd_dkv_kernel
// <D>): every other shape, past the cluster's reach (Tk > 1024) and at d =
// 32 and 128, where the one-pass kernels measured slower (PERF.md,
// Findings).  FlashAttention-2's backward as two kernels, like JAX's: the dQ
// kernel owns 64 query rows (Q, dO, LSE in shared memory; Di computed in
// its prologue and written for the other kernel) and walks the keys; the
// dK/dV kernel owns 64 keys (K, V in shared memory, dK and dV summed in f32
// registers) and walks the queries, 32 a tile at d = 128 (64 below) so the
// sums and the tile's scores fit in registers.  With the keys as the rows,
// S^T = K Q^T and dP^T = V dO^T come out in the accumulator layout, which is
// the A layout, so P^T and dS^T feed dV and dK from registers.  Both
// recompute S and dP: 7 products where the bound counts 5, and twice the
// exponentials, but no sum crosses a block.  Staging, ldmatrix and the
// swizzle are the forward's; a negative scale flips Q (dQ kernel) or K
// (dK/dV kernel).  Keys past Tk and queries past Tq get P = 0.
//
// The entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() (or cudaErrorInvalidValue for a head dim or type
// they have no instance for) so the caller can raise.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace cg = cooperative_groups;

// Cycle stamps for python -m eyegaze_tpu_torch.trace_backward: built with
// ATTENTION_TRACE defined, the one-pass kernels record clock64() where they
// say TRACE(when, role, tile, point), in block (0, 0, 0) only, and
// attention_trace_read copies the stamps out.  Otherwise TRACE is nothing.
#ifdef ATTENTION_TRACE
constexpr int kTraceTiles = 64, kTracePoints = 12;
__device__ long long attention_trace[3][kTraceTiles][kTracePoints];
#define TRACE(when, role, j, k)                                                    \
  if ((when) && blockIdx.x + blockIdx.y + blockIdx.z == 0 && (j) < kTraceTiles) \
  attention_trace[role][j][k] = clock64()
extern "C" int attention_trace_read(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, attention_trace, sizeof(attention_trace)));
}
#else
#define TRACE(when, role, j, k)
#endif

namespace {

struct Strides {
  long long b, t, h;  // element strides of the batch, time and head axes
};

// ---- bf16 on the tensor cores ----

namespace tc {

constexpr int kRows = 64;   // query rows per block, 16 per warp
constexpr int kKeys = 64;   // keys per staged tile
constexpr int kThreads = 128;

// A (Rows, D) bf16 tile in shared memory: row r's 16-byte chunk c sits at
// chunk c ^ f(r), where f spreads the eight rows an ldmatrix phase reads (rows
// 8i..8i+7, one chunk each) over the eight 16-byte bank groups of 128 bytes.
template <int D, int Rows = kRows>
struct Tile {
  static constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;
  static constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
  static constexpr int kElems = Rows * D;
  static_assert(kRows == kKeys, "one tile shape for Q, K and V");
  static_assert(D % 16 == 0, "head dim");
  static_assert(Rows * kChunks % kThreads == 0, "whole staging rounds");
  __device__ static __forceinline__ int at(int row, int chunk) {  // element offset
    return row * D + ((chunk ^ ((row / kRowsPerLine) & kMask)) << 3);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared, asynchronous; zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Four 8 x 8 bf16 matrices from the mma accumulator layout into shared
// memory: lanes 8i .. 8i + 7 give the addresses of matrix i's rows.
__device__ __forceinline__ void stmatrix_x4(void* p, const unsigned (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_addr(p)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// d += a b: a (16 x 16, row major) and b (16 x 8, column major) bf16, d f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {  // one SFU op; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two probabilities rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// Rows r0 .. r0 + Rows - 1 of a (rows, D) bf16 matrix with row stride `st`
// into a tile, 16 bytes a thread; rows past `rows` become zeros.
template <int D, int Rows = kRows>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                      long long st, int r0, int rows) {
  using L = Tile<D, Rows>;
#pragma unroll
  for (int i = 0; i < Rows * L::kChunks / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / L::kChunks;
    const int c = e % L::kChunks;
    const bool valid = r0 + r < rows;
    cp_async16(dst + L::at(r, c), src + (valid ? r0 + r : 0) * st + c * 8, valid);
  }
}

// s (16 x 8 NT) += A B^T: A the warp's 16 rows from a_row0 of the staged
// (rows, D) tile a_s, its sign bits xor'd with a_sign; B the 8 NT rows of the
// staged (8 NT, D) tile b_s: Q K^T with both operands staged.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&s)[NT][4], const __nv_bfloat16* a_s,
                                        int a_row0, const __nv_bfloat16* b_s, unsigned a_sign) {
  using L = Tile<D>;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned af[4];
    ldmatrix_x4(af, a_s + L::at(a_row0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                    2 * kk + (lane >> 4)));
#pragma unroll
    for (int i = 0; i < 4; ++i) af[i] ^= a_sign;
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      unsigned bf[4];
      ldmatrix_x4(bf, b_s + L::at(16 * n2 + (lane & 7) + (lane >> 4) * 8,
                                      2 * kk + ((lane >> 3) & 1)));
      mma_bf16(s[2 * n2], af, bf[0], bf[1]);
      mma_bf16(s[2 * n2 + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D) += bf16(p) B: p (16 x 8 NT) in the mma accumulator layout,
// which is the A layout; B the staged (8 NT, D) tile b_s, read with .trans.
template <int D, int NT>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const float (&p)[NT][4],
                                       const __nv_bfloat16* b_s) {
  using L = Tile<D>;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const unsigned pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      unsigned bf[4];
      ldmatrix_x4_trans(bf, b_s + L::at(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                                            2 * nd + (lane >> 4)));
      mma_bf16(acc[2 * nd], pa, bf[0], bf[1]);
      mma_bf16(acc[2 * nd + 1], pa, bf[2], bf[3]);
    }
  }
}

}  // namespace tc

template <int D>
__global__ void __launch_bounds__(tc::kThreads)
attention_kernel_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      Strides sq, Strides sk, Strides sv, Strides so, int tq, int tk,
                      float scale_log2, float* __restrict__ lse) {
  using L = tc::Tile<D>;
  constexpr int kSteps = D / 16;  // k-steps of Q K^T, pairs of 8-wide column tiles of P V
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + L::kElems;      // two stages
  __nv_bfloat16* v_s = k_s + 2 * L::kElems;  // two stages

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int row0 = blockIdx.x * tc::kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  tc::stage<D>(q_s, q + b * sq.b + h * sq.h, sq.t, row0, tq);
  tc::stage<D>(k_s, kb, sk.t, 0, tk);
  tc::stage<D>(v_s, vb, sv.t, 0, tk);
  tc::cp_async_commit();

  // s * scale = (-s) * |scale|: a negative scale flips the sign of Q (exact),
  // so the row max of the raw scores is the max of the scaled ones.
  const float sc = fabsf(scale_log2);
  const unsigned q_sign = scale_log2 < 0.f ? 0x80008000u : 0u;
  unsigned qf[kSteps][4];
  float acc[2 * kSteps][4];  // O: 8-wide column tiles, rows g and g + 8
#pragma unroll
  for (int n = 0; n < 2 * kSteps; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores, rows g, g + 8
  float l[2] = {0.f, 0.f};              // this thread's part of the running sums

  const int tiles = (tk + tc::kKeys - 1) / tc::kKeys;
  for (int j = 0; j < tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < tiles) {  // the next tile loads while this one computes
      const int at = (j + 1) * tc::kKeys;
      tc::stage<D>(k_s + (cur ^ 1) * L::kElems, kb, sk.t, at, tk);
      tc::stage<D>(v_s + (cur ^ 1) * L::kElems, vb, sv.t, at, tk);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        tc::ldmatrix_x4(qf[kk], q_s + L::at(r, 2 * kk + (lane >> 4)));
#pragma unroll
        for (int i = 0; i < 4; ++i) qf[kk][i] ^= q_sign;
      }
    }

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys: 8 column
    // tiles of 8 keys; thread (g, t) holds keys 8n + 2t, 8n + 2t + 1 of rows
    // g = lane / 4 (s[n][0..1]) and g + 8 (s[n][2..3]).
    const __nv_bfloat16* ks = k_s + cur * L::kElems;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        unsigned kf[4];
        tc::ldmatrix_x4(kf, ks + L::at(16 * n2 + (lane & 7) + (lane >> 4) * 8,
                                       2 * kk + ((lane >> 3) & 1)));
        tc::mma_bf16(s[2 * n2], qf[kk], kf[0], kf[1]);
        tc::mma_bf16(s[2 * n2 + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // Online softmax.  Keys past tk (only in the last tile) take no part in
    // the max and get probability 0.
    const int key0 = j * tc::kKeys + 2 * (lane & 3);
    const bool ragged = j * tc::kKeys + tc::kKeys > tk;
    if (ragged) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * n + (e & 1) >= tk) s[n][e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float neg_m[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * sc);  // finite: every tile holds a key
      alpha[r] = tc::ex2(m[r] - m_new);              // 0 on the first tile
      m[r] = m_new;
      neg_m[r] = -m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = tc::ex2(fmaf(s[n][e], sc, neg_m[e >> 1]));
        if (ragged && key0 + 8 * n + (e & 1) >= tk) p = 0.f;  // NaN when sc = 0
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < 2 * kSteps; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A layout of 16 keys per k-step.
    tc::mma_pb<D, 8>(acc, s, v_s + cur * L::kElems);
    __syncthreads();  // this stage is overwritten by the load of tile j + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int i = row0 + warp * 16 + lane / 4 + 8 * r;
    if (i < tq) {
      __nv_bfloat16* orow = o + b * so.b + (long long)i * so.t + h * so.h + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < 2 * kSteps; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(acc[n][2 * r] / l[r], acc[n][2 * r + 1] / l[r]);
      }
      // The row's log-sum-exp for the backward, base 2: log2 sum_j 2^(s_j
      // scale log2(e)) = m + log2(l).
      if (lse != nullptr && (lane & 3) == 0) {
        lse[((long long)b * gridDim.y + h) * tq + i] = m[r] + log2f(l[r]);
      }
    }
  }
}

// ---- bf16 backward (K4's backward) on the tensor cores ----

namespace bw {

constexpr int kKeys = 64;  // keys per dK/dV block and per staged tile of the dQ kernel
constexpr int kRows = 64;  // query rows per dQ block
// Queries per staged tile of the dK/dV kernel: 32 at d = 128, where the dK
// and dV sums alone take 128 registers a thread.
__host__ __device__ constexpr int q_tile(int d) { return d == 128 ? 32 : 64; }

struct Args {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float* lse;  // (B, H, Tq): the forward's row log-sum-exp, base 2
  float* di;         // (B, H, Tq): written by the dQ kernel, read by the dK/dV kernel
  __nv_bfloat16 *dq, *dk, *dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int tq, tk;
  float scale_log2;  // scale * log2(e): P = 2^(s scale_log2 - lse)
  float scale;
};

// A warp's 16 x D f32 sums (rows row0 + g and row0 + g + 8) into rows of a
// bf16 matrix with row stride `st`; rows at or past `rows` are not written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long st, int row0, int rows,
                                           const float (&acc)[D / 8][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + lane / 4 + 8 * r;
    if (i < rows) {
      __nv_bfloat16* row = base + (long long)i * st + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
            __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
  }
}

// Entries r0 .. r0 + N - 1 of an f32 row vector into shared memory, 4 bytes a
// thread, asynchronously; entries past `n` become zeros.
template <int N>
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int r0, int n) {
  static_assert(N <= tc::kThreads, "one entry a thread");
  const int i = r0 + threadIdx.x;
  if (threadIdx.x < N) tc::cp_async4(dst + threadIdx.x, src + (i < n ? i : 0), i < n);
}

}  // namespace bw

// dQ, and Di on the way.  One block per (64 query rows, head, batch), 16 rows
// a warp; Q, dO and the rows' LSE stay in shared memory while K and V tiles
// of 64 keys stream through two stages, as in the forward.  Per tile: S = Q
// K^T and dP = dO V^T (f32 sums), P = 2^(S scale log2(e) - LSE), dS = (dP -
// Di) P scale, dQ += bf16(dS) K.  Keys past tk get P = 0.  Its prologue
// computes Di = sum_d O dO in f32 for its rows and writes it for the dK/dV
// kernel, which runs after it on the same stream.
template <int D>
__global__ void __launch_bounds__(tc::kThreads) attention_bwd_dq_kernel(const bw::Args a) {
  using L = tc::Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* do_s = q_s + L::kElems;
  __nv_bfloat16* k_s = do_s + L::kElems;     // two stages
  __nv_bfloat16* v_s = k_s + 2 * L::kElems;  // two stages
  float* lse_s = reinterpret_cast<float*>(v_s + 2 * L::kElems);
  float* di_s = lse_s + bw::kRows;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int row0 = blockIdx.x * bw::kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long vec0 = ((long long)b * gridDim.y + h) * a.tq;  // this (b, h)'s LSE and Di
  const __nv_bfloat16* kb = a.k + b * a.sk.b + h * a.sk.h;
  const __nv_bfloat16* vb = a.v + b * a.sv.b + h * a.sv.h;

  tc::stage<D>(q_s, a.q + b * a.sq.b + h * a.sq.h, a.sq.t, row0, a.tq);
  tc::stage<D>(do_s, a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.t, row0, a.tq);
  tc::stage<D>(k_s, kb, a.sk.t, 0, a.tk);
  tc::stage<D>(v_s, vb, a.sv.t, 0, a.tk);
  bw::stage_vec<bw::kRows>(lse_s, a.lse + vec0, row0, a.tq);
  tc::cp_async_commit();

  {  // Di, two threads a row, each half its dims in 16-byte loads
    const int r = threadIdx.x / 2;
    const int half = threadIdx.x % 2;
    const int i = row0 + r;
    float sum = 0.f;
    if (i < a.tq) {
      const __nv_bfloat16* orow =
          a.o + b * a.so.b + (long long)i * a.so.t + h * a.so.h + half * (D / 2);
      const __nv_bfloat16* grow =
          a.dout + b * a.sdo.b + (long long)i * a.sdo.t + h * a.sdo.h + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const uint4 gv = *reinterpret_cast<const uint4*>(grow + 8 * c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 gf = __bfloat1622float2(g2[e]);
          sum = fmaf(of.x, gf.x, sum);
          sum = fmaf(of.y, gf.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      di_s[r] = sum;
      if (i < a.tq) a.di[vec0 + i] = sum;
    }
  }

  // s * scale = (-s) * |scale|, as in the forward: a negative scale flips Q.
  const float sc = fabsf(a.scale_log2);
  const unsigned q_sign = a.scale_log2 < 0.f ? 0x80008000u : 0u;
  float acc[D / 8][4];  // dQ: 8-wide column tiles, rows g and g + 8
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float lse_r[2], di_r[2];  // rows g and g + 8

  const int tiles = (a.tk + bw::kKeys - 1) / bw::kKeys;
  for (int j = 0; j < tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < tiles) {  // the next tile loads while this one computes
      const int at = (j + 1) * bw::kKeys;
      tc::stage<D>(k_s + (cur ^ 1) * L::kElems, kb, a.sk.t, at, a.tk);
      tc::stage<D>(v_s + (cur ^ 1) * L::kElems, vb, a.sv.t, at, a.tk);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse_r[r] = lse_s[warp * 16 + lane / 4 + 8 * r];
        di_r[r] = di_s[warp * 16 + lane / 4 + 8 * r];
      }
    }

    const __nv_bfloat16* ks = k_s + cur * L::kElems;
    float s[8][4] = {};
    tc::mma_abt<D, 8>(s, q_s, warp * 16, ks, q_sign);
    float dp[8][4] = {};
    tc::mma_abt<D, 8>(dp, do_s, warp * 16, v_s + cur * L::kElems, 0u);
    const int key0 = j * bw::kKeys + 2 * (lane & 3);
    const bool ragged = j * bw::kKeys + bw::kKeys > a.tk;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = tc::ex2(fmaf(s[n][e], sc, -lse_r[e >> 1]));
        if (ragged && key0 + 8 * n + (e & 1) >= a.tk) p = 0.f;
        s[n][e] = (dp[n][e] - di_r[e >> 1]) * p * a.scale;  // dS
      }
    tc::mma_pb<D, 8>(acc, s, ks);
    __syncthreads();  // this stage is overwritten by the load of tile j + 2
  }
  bw::store_rows<D>(a.dq + b * a.sdq.b + h * a.sdq.h, a.sdq.t, row0 + warp * 16, a.tq, acc);
}

// dK and dV.  One block per (64 keys, head, batch), 16 keys a warp; K and V
// stay in shared memory and the f32 dK and dV sums in registers, while tiles
// of kQ queries (Q, dO, their LSE and Di) stream through two stages.  With
// the keys as the rows, S^T = K Q^T and dP^T = V dO^T come out in the
// accumulator layout, which is the A layout, so P^T and dS^T feed dV +=
// bf16(P^T) dO and dK += bf16(dS^T) Q from registers.  Queries past tq get
// P = 0 and add nothing.
template <int D>
__global__ void __launch_bounds__(tc::kThreads) attention_bwd_dkv_kernel(const bw::Args a) {
  constexpr int kQ = bw::q_tile(D);
  constexpr int kNt = kQ / 8;  // 8-wide query tiles of S^T
  using L = tc::Tile<D>;
  using LQ = tc::Tile<D, kQ>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + L::kElems;
  __nv_bfloat16* q_s = v_s + L::kElems;        // two stages
  __nv_bfloat16* do_s = q_s + 2 * LQ::kElems;  // two stages
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * LQ::kElems);  // two stages
  float* di_s = lse_s + 2 * kQ;                                     // two stages

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int key0 = blockIdx.x * bw::kKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long vec0 = ((long long)b * gridDim.y + h) * a.tq;
  const __nv_bfloat16* qb = a.q + b * a.sq.b + h * a.sq.h;
  const __nv_bfloat16* gb = a.dout + b * a.sdo.b + h * a.sdo.h;

  tc::stage<D>(k_s, a.k + b * a.sk.b + h * a.sk.h, a.sk.t, key0, a.tk);
  tc::stage<D>(v_s, a.v + b * a.sv.b + h * a.sv.h, a.sv.t, key0, a.tk);
  tc::stage<D, kQ>(q_s, qb, a.sq.t, 0, a.tq);
  tc::stage<D, kQ>(do_s, gb, a.sdo.t, 0, a.tq);
  bw::stage_vec<kQ>(lse_s, a.lse + vec0, 0, a.tq);
  bw::stage_vec<kQ>(di_s, a.di + vec0, 0, a.tq);
  tc::cp_async_commit();

  // K as the A operand of S^T: a negative scale flips its sign.
  const float sc = fabsf(a.scale_log2);
  const unsigned k_sign = a.scale_log2 < 0.f ? 0x80008000u : 0u;
  float dk[D / 8][4], dv[D / 8][4];  // keys g and g + 8 of the warp
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int tiles = (a.tq + kQ - 1) / kQ;
  for (int j = 0; j < tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < tiles) {
      const int at = (j + 1) * kQ;
      tc::stage<D, kQ>(q_s + (cur ^ 1) * LQ::kElems, qb, a.sq.t, at, a.tq);
      tc::stage<D, kQ>(do_s + (cur ^ 1) * LQ::kElems, gb, a.sdo.t, at, a.tq);
      bw::stage_vec<kQ>(lse_s + (cur ^ 1) * kQ, a.lse + vec0, at, a.tq);
      bw::stage_vec<kQ>(di_s + (cur ^ 1) * kQ, a.di + vec0, at, a.tq);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* qs = q_s + cur * LQ::kElems;
    const __nv_bfloat16* gs = do_s + cur * LQ::kElems;
    const float* ls = lse_s + cur * kQ;
    const float* ds = di_s + cur * kQ;
    float s[kNt][4] = {};  // S^T: keys g, g + 8 by queries 8n + 2t, 8n + 2t + 1
    tc::mma_abt<D, kNt>(s, k_s, warp * 16, qs, k_sign);
    float dp[kNt][4] = {};
    tc::mma_abt<D, kNt>(dp, v_s, warp * 16, gs, 0u);
    const int c0 = 2 * (lane & 3);
    const bool ragged = j * kQ + kQ > a.tq;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * n + c0);
      const float2 d2 = *reinterpret_cast<const float2*>(ds + 8 * n + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = tc::ex2(fmaf(s[n][e], sc, -(e & 1 ? l2.y : l2.x)));
        if (ragged && j * kQ + 8 * n + c0 + (e & 1) >= a.tq) p = 0.f;
        s[n][e] = p;
        dp[n][e] = (dp[n][e] - (e & 1 ? d2.y : d2.x)) * p * a.scale;  // dS^T
      }
    }
    tc::mma_pb<D, kNt>(dv, s, gs);
    tc::mma_pb<D, kNt>(dk, dp, qs);
    __syncthreads();  // this stage is overwritten by the load of tile j + 2
  }
  bw::store_rows<D>(a.dk + b * a.sdk.b + h * a.sdk.h, a.sdk.t, key0 + warp * 16, a.tk, dk);
  bw::store_rows<D>(a.dv + b * a.sdv.b + h * a.sdv.h, a.sdv.t, key0 + warp * 16, a.tk, dv);
}

// ---- bf16 backward in one pass (K4's backward where one cluster covers Tk) ----

namespace op {

constexpr int kWarps = 8;                       // consumer warps, 16 keys each
constexpr int kKeys = 16 * kWarps;              // keys per block
constexpr int kClusterMax = 8;                  // the portable cluster size
constexpr int kMaxKeys = kKeys * kClusterMax;   // the longest Tk one cluster covers
constexpr int kStages = 2;                      // query tiles in flight
constexpr int kConsumers = 32 * kWarps;
constexpr int kCopiers = 32;                    // a warp copying the query tiles
constexpr int kReducers = 32;                   // a warp summing the cluster's dQ
constexpr int kThreads = kConsumers + kCopiers + kReducers;
constexpr int kConsumerBarrier = 1;             // named barriers of the consumers and
constexpr int kReducerBarrier = 2;              // of the reducers
// Partial dQ tiles in flight: a block writes tile j's into buffer j %
// kParts once every block has summed tile j - kParts from it (`freed`).
constexpr int kParts = 4;
constexpr int kQ = 128;  // queries per tile
__host__ __device__ constexpr int pitch(int d) { return d + 4; }  // floats a row of a partial dQ

template <int D>
struct Smem {  // byte offsets into the block's dynamic shared memory
  using LK = tc::Tile<D, kKeys>;  // K and V: keys x D
  using LQ = tc::Tile<D, kQ>;     // a stage of Q or dO: queries x D
  using LS = tc::Tile<kQ, kKeys>; // dS^T: keys x queries
  static constexpr int kK = 0;
  static constexpr int kV = kK + LK::kElems * 2;
  static constexpr int kQs = kV + LK::kElems * 2;
  static constexpr int kDo = kQs + kStages * LQ::kElems * 2;
  static constexpr int kLse = kDo + kStages * LQ::kElems * 2;
  static constexpr int kDi = kLse + kStages * kQ * 4;
  static constexpr int kDs = kDi + kStages * kQ * 4;  // the dS^T tile, bf16
  static constexpr int kPart = kDs + LS::kElems * 2;  // kParts partial dQ tiles, f32
  static constexpr int kBars = kPart + kParts * kQ * pitch(D) * 4;
  // full[kStages], empty[kStages], pfull[kParts], ready[kParts], freed[kParts]
  static constexpr int kBytes = kBars + (2 * kStages + 3 * kParts) * 8;
};

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc::smem_addr(bar)), "r"(count));
}
// Waits until the barrier completes the phase of this parity (acquire, CTA).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(tc::smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// The same with acquire at cluster scope: the arrivals came from the
// cluster's blocks, and what they wrote before is read next.
__device__ __forceinline__ void mbar_wait_cluster(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(tc::smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tc::smem_addr(bar)) : "memory");
}
// Arrives on the barrier at the same offset in block `rank` of the cluster,
// releasing this thread's writes (and those it observed) at cluster scope.
__device__ __forceinline__ void mbar_arrive_cluster(unsigned long long* bar, unsigned rank) {
  asm volatile(
      "{\n .reg .b32 remote;\n"
      " mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n}\n" ::"r"(
          tc::smem_addr(bar)),
      "r"(rank)
      : "memory");
}
// One arrival on the barrier once this thread's earlier cp.async copies land.
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   tc::smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBarrier), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void reducers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kReducerBarrier), "n"(kReducers) : "memory");
}

// Rows r0 .. r0 + Rows - 1 of a (rows, D) bf16 matrix with row stride `st`
// into a tile, 16 bytes a copy, copies e = first, first + Step, ...; rows
// past `rows` become zeros.  With Step a constant the loop unrolls and each
// copy's offsets, the same for every tile, are computed once.
template <int D, int Rows, int Step>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src, long long st,
                                      int r0, int rows, int first) {
  using L = tc::Tile<D, Rows>;
#pragma unroll
  for (int i = 0; i < (Rows * L::kChunks + Step - 1) / Step; ++i) {
    const int e = first + i * Step;
    const int r = e / L::kChunks;
    const int c = e % L::kChunks;
    const bool valid = r0 + r < rows;
    if (e < Rows * L::kChunks) {
      tc::cp_async16(dst + L::at(r, c), src + (valid ? r0 + r : 0) * st + c * 8, valid);
    }
  }
}

// Rows rank, rank + C, ... of query tile t's dQ: the C partial tiles at
// `parts` (tile t's buffer in each block of the cluster, mapped into this
// block's view of distributed shared memory) summed in rank order, 4 dims
// a thread (threads `first`, `first` + `step`, ...), every block's load
// issued before the sum; rows past Tq are not written.
template <int D, int Q>
__device__ __forceinline__ void sum_partials(const float* const (&parts)[kClusterMax], int t,
                                             int rank, int csize, const bw::Args& a, int b, int h,
                                             int first, int step) {
  const int rows = (Q - rank + csize - 1) / csize;
  for (int it = first; it < rows * (D / 4); it += step) {
    const int i = rank + csize * (it / (D / 4));
    const int c = 4 * (it % (D / 4));
    const int off = i * pitch(D) + c;
    float4 v[kClusterMax];
#pragma unroll
    for (int r = 0; r < kClusterMax; ++r) {
      if (r < csize) v[r] = *reinterpret_cast<const float4*>(parts[r] + off);
    }
    float4 sum = v[0];
#pragma unroll
    for (int r = 1; r < kClusterMax; ++r) {
      if (r < csize) {
        sum.x += v[r].x;
        sum.y += v[r].y;
        sum.z += v[r].z;
        sum.w += v[r].w;
      }
    }
    if (t * Q + i < a.tq) {
      __nv_bfloat16* dst = a.dq + b * a.sdq.b + (long long)(t * Q + i) * a.sdq.t + h * a.sdq.h + c;
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(tc::pack_bf16(sum.x, sum.y), tc::pack_bf16(sum.z, sum.w));
    }
  }
}

}  // namespace op

// dQ, dK and dV in one pass over the scores.  A cluster of C = ceil(Tk /
// 128) blocks owns one (b, h); block r of it owns keys 128 r .. 128 r + 127:
// K and V in shared memory, their A fragments and the f32 dK and dV sums in
// registers, 16 keys to each of 8 consumer warps.  A copier warp streams the
// head's 128-query tiles (Q, dO and their LSE and Di) through a ring of
// kStages stages, with cp.async copies that arrive on the stage's `full`
// mbarrier as they land; the consumers release a stage on its `empty`
// mbarrier.  Per tile and 16 queries, keys as the rows: S^T = K Q^T and dP^T
// = V dO^T, P^T = 2^(S^T scale log2(e) - LSE), dS^T = (dP^T - Di) P^T scale,
// once per score; dV += bf16(P^T) dO and dK += bf16(dS^T) Q from registers
// (the accumulator layout is the A layout); bf16(dS^T) goes to shared
// memory (stmatrix).  After a barrier of the consumer warps, the block's
// partial dQ tile = dS K (dS read back transposed with ldmatrix.trans)
// goes, in f32, to one of kParts buffers; after another, the consumers
// arrive on its `pfull` mbarrier and go on to the next tile.  The copier,
// kStages tiles behind its copies, turns `pfull` into an arrival on the
// `ready` mbarrier of every block of the cluster (a release at cluster
// scope, too slow for a consumer to wait on).  Once all have arrived, the
// reducer warp of block r sums rows i = r, r + C, ... of the C partial
// tiles through distributed shared memory, always in rank order, writes
// them as bf16 dQ, and arrives on every block's `freed` mbarrier of that
// buffer, which a block waits for before it writes the buffer again.  Di =
// sum_d O dO comes first: each block computes its C-th of the head's rows
// into `di`, and a cluster barrier publishes them before the copiers read
// any.
template <int D>
__global__ void __launch_bounds__(op::kThreads, 2)
attention_bwd_one_pass_kernel(const bw::Args a) {
  using S = op::Smem<D>;
  using LK = typename S::LK;
  using LQ = typename S::LQ;
  using LS = typename S::LS;
  constexpr int kQ = op::kQ;
  constexpr int kSteps = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kK);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kV);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kQs);
  __nv_bfloat16* do_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kDo);
  float* lse_s = reinterpret_cast<float*>(smem + S::kLse);
  float* di_s = reinterpret_cast<float*>(smem + S::kDi);
  __nv_bfloat16* ds_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kDs);
  float* part = reinterpret_cast<float*>(smem + S::kPart);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + S::kBars);
  unsigned long long* empty = full + op::kStages;
  unsigned long long* pfull = empty + op::kStages;  // this block's partial tile is whole
  unsigned long long* ready = pfull + op::kParts;   // every block's is
  unsigned long long* freed = ready + op::kParts;   // every block has summed it

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;  // the cluster spans the grid's x axis
  const int csize = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int key0 = rank * op::kKeys;
  const long long vec0 = ((long long)b * gridDim.y + h) * a.tq;  // this (b, h)'s LSE and Di
  const int tiles = (a.tq + kQ - 1) / kQ;

  if (threadIdx.x == 0) {
    for (int s = 0; s < op::kStages; ++s) {
      op::mbar_init(&full[s], op::kCopiers);     // a cp.async arrival a copying thread
      op::mbar_init(&empty[s], op::kConsumers);  // every consumer thread
    }
    for (int t = 0; t < op::kParts; ++t) {
      op::mbar_init(&pfull[t], op::kConsumers);
      op::mbar_init(&ready[t], csize);  // one arrival a block of the cluster
      op::mbar_init(&freed[t], csize);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  op::stage<D, op::kKeys, op::kThreads>(k_s, a.k + b * a.sk.b + h * a.sk.h, a.sk.t, key0,
                                          a.tk, threadIdx.x);
  op::stage<D, op::kKeys, op::kThreads>(v_s, a.v + b * a.sv.b + h * a.sv.h, a.sv.t, key0,
                                          a.tk, threadIdx.x);
  tc::cp_async_commit();
  {  // Di for this block's C-th of the rows, two threads a row
    const int per = (a.tq + csize - 1) / csize;
    const int half = threadIdx.x % 2;
    for (int base = 0; base < per; base += op::kThreads / 2) {
      const int r = base + threadIdx.x / 2;
      const int i = rank * per + r;
      const bool live = r < per && i < a.tq;
      float sum = 0.f;
      if (live) {
        const __nv_bfloat16* orow =
            a.o + b * a.so.b + (long long)i * a.so.t + h * a.so.h + half * (D / 2);
        const __nv_bfloat16* grow =
            a.dout + b * a.sdo.b + (long long)i * a.sdo.t + h * a.sdo.h + half * (D / 2);
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
          const uint4 gv = *reinterpret_cast<const uint4*>(grow + 8 * c);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 gf = __bfloat1622float2(g2[e]);
            sum = fmaf(of.x, gf.x, sum);
            sum = fmaf(of.y, gf.y, sum);
          }
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (live && half == 0) a.di[vec0 + i] = sum;
    }
  }
  tc::cp_async_wait<0>();
  cluster.sync();  // barriers initialised, K and V staged, every Di of the head written

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (warp >= op::kWarps) {
    const int pt = threadIdx.x - op::kConsumers;
    if (pt < op::kCopiers) {
      // The copiers: query tile j into stage j % kStages, once the consumers
      // have released the tile kStages before it.
      constexpr int kCopiers = op::kCopiers;
      const __nv_bfloat16* qb = a.q + b * a.sq.b + h * a.sq.h;
      const __nv_bfloat16* gb = a.dout + b * a.sdo.b + h * a.sdo.h;
      int s = 0;
      unsigned phase = 1;  // the first pass over the ring waits for nothing
      for (int j = 0; j < tiles + op::kStages; ++j) {
        // Partial dQ tile t is whole in this block: tell every block.  A
        // release at cluster scope waits until the writes it covers reach
        // the cluster, so this warp, which has time to spare, gives it and
        // not a consumer, which the next barrier would make the others wait
        // for.
        const int t = j - op::kStages;
        if (t >= 0) {
          op::mbar_wait(&pfull[t % op::kParts], (t / op::kParts) & 1);
          if (pt < csize) op::mbar_arrive_cluster(&ready[t % op::kParts], pt);
        }
        if (j >= tiles) continue;
        TRACE(pt == 0, 1, j, 0);
        op::mbar_wait(&empty[s], phase);
        TRACE(pt == 0, 1, j, 1);
        const int q0 = j * kQ;
        op::stage<D, kQ, kCopiers>(q_s + s * LQ::kElems, qb, a.sq.t, q0, a.tq, pt);
        op::stage<D, kQ, kCopiers>(do_s + s * LQ::kElems, gb, a.sdo.t, q0, a.tq, pt);
#pragma unroll
        for (int e0 = 0; e0 < kQ; e0 += kCopiers) {
          const int e = e0 + pt;
          const int i = q0 + e;
          const bool valid = i < a.tq;
          if (e < kQ) {
            tc::cp_async4(lse_s + s * kQ + e, a.lse + vec0 + (valid ? i : 0), valid);
            tc::cp_async4(di_s + s * kQ + e, a.di + vec0 + (valid ? i : 0), valid);
          }
        }
        op::cp_async_arrive(&full[s]);
        TRACE(pt == 0, 1, j, 2);
        if (++s == op::kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    } else {
      // The reducers: the cluster's sum of partial dQ tile t once every
      // block has written its own.
      const int rt = pt - op::kCopiers;
      const float* parts[op::kClusterMax];  // every block's partial tiles
#pragma unroll
      for (int r = 0; r < op::kClusterMax; ++r) {
        parts[r] = cluster.map_shared_rank(part, r < csize ? r : 0);
      }
      for (int t = 0; t < tiles; ++t) {
        const int u = t % op::kParts;
        const unsigned parity = (t / op::kParts) & 1;
        TRACE(rt == 0, 2, t, 0);
        op::mbar_wait_cluster(&ready[u], parity);  // every block's partial tile t is whole
        TRACE(rt == 0, 2, t, 1);
        const float* bufs[op::kClusterMax];
#pragma unroll
        for (int r = 0; r < op::kClusterMax; ++r) bufs[r] = parts[r] + u * kQ * op::pitch(D);
        op::sum_partials<D, kQ>(bufs, t, rank, csize, a, b, h, rt, op::kReducers);
        TRACE(rt == 0, 2, t, 2);
        op::reducers_sync();  // every reducer's reads of buffer u are done
        if (rt < csize) op::mbar_arrive_cluster(&freed[u], rt);
      }
    }
    cluster.sync();  // no block leaves while another may read its partial tiles
  } else {
    // K as the A operand of S^T: a negative scale flips its sign.
    const float sc = fabsf(a.scale_log2);
    const unsigned k_sign = a.scale_log2 < 0.f ? 0x80008000u : 0u;
    const int row0 = warp * 16;  // this warp's keys in the block
    unsigned kf[kSteps][4], vf[kSteps][4];  // the warp's keys as A fragments, held
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int r = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
      tc::ldmatrix_x4(kf[kk], k_s + LK::at(r, 2 * kk + (lane >> 4)));
      tc::ldmatrix_x4(vf[kk], v_s + LK::at(r, 2 * kk + (lane >> 4)));
#pragma unroll
      for (int i = 0; i < 4; ++i) kf[kk][i] ^= k_sign;
    }
    float dk[D / 8][4], dv[D / 8][4];  // keys g and g + 8 of the warp
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
    const int g = lane / 4;
    const int c0 = 2 * (lane & 3);
    // Keys past Tk (zero rows of K and V) get P = 0.  Queries past Tq need no
    // test: their Q, dO, LSE and Di are staged as zeros, so P = 1 and dS = 0
    // exactly, adding nothing to dK and dV, and their dQ rows are not written.
    const bool drop0 = key0 + row0 + g >= a.tk, drop1 = key0 + row0 + g + 8 >= a.tk;

    // The partial dQ product: warp w sums query rows 16 (w % kQg) .. + 15
    // and dims kDw (w / kQg) .. + kDw - 1 over the block's keys.
    constexpr int kQg = kQ / 16;
    constexpr int kDw = D / (op::kWarps / kQg);
    static_assert(kDw % 16 == 0, "whole 16-wide column pairs of dQ per warp");
    const int qg = warp % kQg;
    const int dw0 = (warp / kQg) * kDw;
    int s = 0;            // the ring's stage of tile j
    unsigned phase = 0;   // the parity of its full barrier's phase
    for (int j = 0; j < tiles; ++j) {
      TRACE(threadIdx.x == 0, 0, j, 0);
      op::mbar_wait(&full[s], phase);
      TRACE(threadIdx.x == 0, 0, j, 1);
      const __nv_bfloat16* qs = q_s + s * LQ::kElems;
      const __nv_bfloat16* gs = do_s + s * LQ::kElems;
      const float* ls = lse_s + s * kQ;
      const float* ds = di_s + s * kQ;

#pragma unroll
      for (int qc = 0; qc < kQ / 16; ++qc) {  // 16 queries: two 8-wide tiles
        float st[2][4] = {}, dpt[2][4] = {};  // S^T and dP^T: keys g, g + 8
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          unsigned bf[4];
          tc::ldmatrix_x4(bf, qs + LQ::at(16 * qc + (lane & 7) + (lane >> 4) * 8,
                                          2 * kk + ((lane >> 3) & 1)));
          tc::mma_bf16(st[0], kf[kk], bf[0], bf[1]);
          tc::mma_bf16(st[1], kf[kk], bf[2], bf[3]);
          tc::ldmatrix_x4(bf, gs + LQ::at(16 * qc + (lane & 7) + (lane >> 4) * 8,
                                          2 * kk + ((lane >> 3) & 1)));
          tc::mma_bf16(dpt[0], vf[kk], bf[0], bf[1]);
          tc::mma_bf16(dpt[1], vf[kk], bf[2], bf[3]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int qi = 16 * qc + 8 * n + c0;  // queries qi, qi + 1 of the tile
          const float2 l2 = *reinterpret_cast<const float2*>(ls + qi);
          const float2 d2 = *reinterpret_cast<const float2*>(ds + qi);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = tc::ex2(fmaf(st[n][e], sc, -(e & 1 ? l2.y : l2.x)));
            if (e < 2 ? drop0 : drop1) p = 0.f;
            st[n][e] = p;
            dpt[n][e] = (dpt[n][e] - (e & 1 ? d2.y : d2.x)) * p * a.scale;  // dS^T
          }
        }
        const unsigned pa[4] = {
            tc::pack_bf16(st[0][0], st[0][1]), tc::pack_bf16(st[0][2], st[0][3]),
            tc::pack_bf16(st[1][0], st[1][1]), tc::pack_bf16(st[1][2], st[1][3])};
        const unsigned sa[4] = {
            tc::pack_bf16(dpt[0][0], dpt[0][1]), tc::pack_bf16(dpt[0][2], dpt[0][3]),
            tc::pack_bf16(dpt[1][0], dpt[1][1]), tc::pack_bf16(dpt[1][2], dpt[1][3])};
#pragma unroll
        for (int nd = 0; nd < kSteps; ++nd) {  // dV += P^T dO, dK += dS^T Q: 16 dims a step
          unsigned bf[4];
          const int r = 16 * qc + (lane & 7) + ((lane >> 3) & 1) * 8;
          tc::ldmatrix_x4_trans(bf, gs + LQ::at(r, 2 * nd + (lane >> 4)));
          tc::mma_bf16(dv[2 * nd], pa, bf[0], bf[1]);
          tc::mma_bf16(dv[2 * nd + 1], pa, bf[2], bf[3]);
          tc::ldmatrix_x4_trans(bf, qs + LQ::at(r, 2 * nd + (lane >> 4)));
          tc::mma_bf16(dk[2 * nd], sa, bf[0], bf[1]);
          tc::mma_bf16(dk[2 * nd + 1], sa, bf[2], bf[3]);
        }
        tc::stmatrix_x4(ds_s + LS::at(row0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                       2 * qc + (lane >> 4)),
                        sa);
      }
      TRACE(threadIdx.x == 0, 0, j, 2);
      op::mbar_arrive(&empty[s]);  // Q, dO, LSE and Di of this stage are read
      if (++s == op::kStages) {
        s = 0;
        phase ^= 1;
      }
      op::consumers_sync();  // dS^T of every warp is in ds_s
      TRACE(threadIdx.x == 0, 0, j, 3);
      const int u = j % op::kParts;
      if (j >= op::kParts) {  // every block has summed tile j - kParts from buffer u
        op::mbar_wait_cluster(&freed[u], (j / op::kParts - 1) & 1);
      }
      TRACE(threadIdx.x == 0, 0, j, 4);

      // This block's partial dQ tile = dS K over its keys, f32.
      float acc[kDw / 8][4];
#pragma unroll
      for (int n = 0; n < kDw / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < op::kKeys / 16; ++ks) {
        unsigned af[4];
        tc::ldmatrix_x4_trans(af, ds_s + LS::at(16 * ks + (lane & 7) + (lane >> 4) * 8,
                                                 2 * qg + ((lane >> 3) & 1)));
        const int r = 16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int n2 = 0; n2 < kDw / 16; ++n2) {
          unsigned bf[4];
          tc::ldmatrix_x4_trans(bf, k_s + LK::at(r, dw0 / 8 + 2 * n2 + (lane >> 4)));
          tc::mma_bf16(acc[2 * n2], af, bf[0], bf[1]);
          tc::mma_bf16(acc[2 * n2 + 1], af, bf[2], bf[3]);
        }
      }
      {
        float* prow = part + u * kQ * op::pitch(D) +
                      (16 * qg + g) * op::pitch(D) + dw0 + c0;
#pragma unroll
        for (int n = 0; n < kDw / 8; ++n) {
          *reinterpret_cast<float2*>(prow + 8 * n) = make_float2(acc[n][0], acc[n][1]);
          *reinterpret_cast<float2*>(prow + 8 * op::pitch(D) + 8 * n) =
              make_float2(acc[n][2], acc[n][3]);
        }
      }
      TRACE(threadIdx.x == 0, 0, j, 5);
      op::consumers_sync();        // every warp is done with ds_s
      TRACE(threadIdx.x == 0, 0, j, 6);
      op::mbar_arrive(&pfull[u]);  // cheap: a release at the block's scope only
    }
    bw::store_rows<D>(a.dk + b * a.sdk.b + h * a.sdk.h, a.sdk.t, key0 + row0, a.tk, dk);
    bw::store_rows<D>(a.dv + b * a.sdv.b + h * a.sdv.h, a.sdv.t, key0 + row0, a.tk, dv);
    cluster.sync();  // no block leaves while another may read its partial tiles
  }
}

// ---- bf16 backward in one pass on wgmma (K4's backward at d = 32 .. 128) ----

namespace wg {

// wgmma's operands in shared memory, here without swizzle: 8 x 8 bf16 core
// matrices of 128 contiguous bytes, a row of 8 elements every 16 bytes.  A
// (Rows, Cols) tile keeps them row of core matrices by row: element (r, c)
// at at<Cols>(r, c), so the core matrix right of another sits 128 bytes on
// and the one below it 16 Cols bytes on.  The same tile serves as a K-major
// operand where K runs along its columns and as an MN-major (transposed) one
// where K runs along its rows; the descriptor gives the byte steps between
// core matrices along K (the leading offset) and along M or N (the stride
// offset).
template <int Cols>
__device__ __forceinline__ int at(int r, int c) {
  return (((r >> 3) * (Cols / 8) + (c >> 3)) << 6) + ((r & 7) << 3) + (c & 7);
}

__device__ __forceinline__ unsigned long long desc(const void* p, unsigned k_step,
                                                   unsigned mn_step) {
  return (unsigned long long)((tc::smem_addr(p) & 0x3FFFF) >> 4) |
         (unsigned long long)(k_step >> 4) << 16 | (unsigned long long)(mn_step >> 4) << 32;
}
// The operand at (r0, c0) of a (Rows, Cols) tile, K along its columns.
template <int Cols>
__device__ __forceinline__ unsigned long long k_major(const __nv_bfloat16* tile, int r0, int c0) {
  return desc(tile + at<Cols>(r0, c0), 128, 16 * Cols);
}
// The operand at (r0, c0) of a (Rows, Cols) tile, K along its rows.
template <int Cols>
__device__ __forceinline__ unsigned long long mn_major(const __nv_bfloat16* tile, int r0, int c0) {
  return desc(tile + at<Cols>(r0, c0), 16 * Cols, 128);
}

// A (Rows, D) bf16 tile as TMA writes it with the 128-byte swizzle: D / 64
// boxes one after another, each Rows rows of 128 bytes (64 elements) whose
// 16-byte chunks the hardware permutes by row % 8, in 1024-byte atoms of 8
// rows.  K-major (K along the rows of 64): the operand of k-step kk starts
// kk % 4 chunk pairs into box kk / 4, 1024 bytes an 8-row group.
template <int Rows>
__device__ __forceinline__ unsigned long long sw128_k(const __nv_bfloat16* tile, int kk) {
  return desc(tile + (kk / 4) * Rows * 64 + (kk % 4) * 16, 16, 1024) | 1ull << 62;
}
// MN-major (K along the tile's rows): k-step kk starts at row 16 kk, 1024
// bytes an 8-row group along K (the stride offset, here), the next box of 64
// along M or N (the leading offset).
template <int Rows>
__device__ __forceinline__ unsigned long long sw128_mn(const __nv_bfloat16* tile, int kk) {
  return desc(tile + kk * 16 * 64, Rows * 128, 1024) | 1ull << 62;
}

// One arrival on the barrier that also expects `bytes` more of TMA copies.
__device__ __forceinline__ void expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tc::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// The box at coordinates (c0, c1, c2, c3) of a 4-d tensor map into `dst`,
// completing `bytes` of the barrier's transactions as it lands.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         int c3, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(tc::smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(tc::smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching accumulators while a wgmma may write them:
// after wait(), every later use reads them through this.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Orders this thread's shared-memory writes before later wgmma reads of them.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x N, f32) += a b (mma_ss0: d = a b), a and b from descriptors, TA /
// TB 1 where the operand is MN-major: wgmma.mma_async m64nNk16, bf16 in, for
// this warpgroup; accumulator register i of warp w holds row 16 w + lane / 4 + 8
// ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2, as mma.sync's.
// mma_rs: a from registers, the m16n8k16 A fragment of each warp's 16 rows.
// The shapes the one-pass kernel uses at d = 64 and 128.
template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[16], unsigned long long a,
                                       unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_ss0(float (&d)[16], unsigned long long a,
                                        unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "l"(a), "l"(b), "r"(0), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[32], unsigned long long a,
                                       unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_ss0(float (&d)[32], unsigned long long a,
                                        unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b), "r"(0), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[32], const unsigned (&a)[4],
                                       unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[64], const unsigned (&a)[4],
                                       unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}


template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace wg

namespace og {

constexpr int kGroups = 2;                          // consumer warpgroups, 64 keys each
constexpr int kKeys = 64 * kGroups;                 // keys per block
constexpr int kMaxKeys = kKeys * op::kClusterMax;   // the longest Tk one cluster covers
constexpr int kQ = 64;                              // queries per tile
constexpr int kConsumers = 128 * kGroups;
// The fourth warpgroup: a warp relaying finished partial dQ tiles to the
// cluster (and loading the query tiles), and three warps summing the
// cluster's.
constexpr int kRelays = 32;
constexpr int kReducers = 96;
constexpr int kThreads = kConsumers + kRelays + kReducers;
// Registers a thread: the launch gives each 168 (one block an SM), and
// setmaxnreg moves them, within the block, to the consumers.
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
static_assert(kConsumers * kConsumerRegs + (kThreads - kConsumers) * kProducerRegs <=
                  kLaunchRegs * kThreads,
              "the consumers take only what the producers give back");
constexpr int kConsumerBarrier = 1;
constexpr int kReducerBarrier = 2;
// Partial dQ tiles in flight (two at d = 128, for shared memory).
__host__ __device__ constexpr int parts(int d) { return d == 128 ? 2 : 4; }
// Floats a row of a partial dQ tile: the eight rows a half warp stores
// 8-byte pairs into fall in different banks.
__host__ __device__ constexpr int pitch(int d) { return d + 8; }

template <int D>
struct Smem {  // byte offsets into the block's dynamic shared memory
  static constexpr int kK = 0;                        // K, keys x D (wg::at)
  static constexpr int kV = kK + kKeys * D * 2;       // V
  static constexpr int kQs = kV + kKeys * D * 2;      // two tiles of Q, kQ x D
  static constexpr int kDo = kQs + 2 * kQ * D * 2;    // and of dO
  static constexpr int kLse = kDo + 2 * kQ * D * 2;   // their LSE
  static constexpr int kDi = kLse + 2 * kQ * 4;       // and Di
  static constexpr int kDs = kDi + 2 * kQ * 4;        // dS^T, keys x kQ, bf16
  static constexpr int kPart = kDs + kKeys * kQ * 2;  // partial dQ tiles, f32
  static constexpr int kBars = kPart + parts(D) * kQ * pitch(D) * 4;
  // full[2], pfull[parts], ready[parts], freed[parts]
  static constexpr int kBytes = kBars + (2 + 3 * parts(D)) * 8;
  static_assert(kQs % 1024 == 0 && kDo % 1024 == 0,
                "TMA's 128-byte swizzle wants 1024-byte atoms");
};

// Where the time, head and batch axes of Q and dO sit in their tensor maps
// (1, 2 or 3; the head dim is 0): the host orders them by stride.
struct MapAxes {
  int t, h, b;
};

template <int Id, int Count>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(Id), "n"(Count) : "memory");
}

// Rows r0 .. r0 + Rows - 1 of a (rows, D) bf16 matrix with row stride `st`
// into a (Rows, D) tile of core matrices (wg::at), 16 bytes a copy, copies e
// = first, first + Step, ...: copy e fills bytes 16 e .. 16 e + 15 of the
// tile, so eight neighbouring copies fill one core matrix; rows past `rows`
// become zeros.  For K and V, once; not unrolled, so no thread keeps the
// addresses.
template <int D, int Rows, int Step>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src, long long st,
                                      int r0, int rows, int first) {
  constexpr int kChunks = D / 8;
#pragma unroll 1
  for (int e = first; e < Rows * kChunks; e += Step) {
    const int r = (e & 7) + 8 * (e / (8 * kChunks));
    const int c = (e >> 3) % kChunks;
    const bool valid = r0 + r < rows;
    tc::cp_async16(dst + 8 * e, src + (valid ? r0 + r : 0) * st + c * 8, valid);
  }
}

__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(tc::smem_addr(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ float4 ld_cluster(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Rows rank, rank + C, ... of query tile t's dQ: the C partial tiles at
// `parts` (tile t's buffer in each block of the cluster, shared::cluster
// addresses) summed in rank order, 4 dims a thread (threads `first`, `first`
// + `step`, ...), four blocks' loads in flight (the registers of the fourth
// warpgroup allow no more); rows past Tq are not written.
template <int D>
__device__ __forceinline__ void sum_partials(const unsigned (&parts)[op::kClusterMax], int t,
                                             int rank, int csize, const bw::Args& a, int b, int h,
                                             int first, int step) {
  const int rows = (kQ - rank + csize - 1) / csize;
  for (int it = first; it < rows * (D / 4); it += step) {
    const int i = rank + csize * (it / (D / 4));
    const int c = 4 * (it % (D / 4));
    const unsigned off = (i * pitch(D) + c) * 4;
    float4 sum = ld_cluster(parts[0] + off);
#pragma unroll
    for (int r0 = 1; r0 < op::kClusterMax; r0 += 4) {
      float4 v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r0 + r < csize) v[r] = ld_cluster(parts[r0 + r] + off);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r0 + r < csize) {
          sum.x += v[r].x;
          sum.y += v[r].y;
          sum.z += v[r].z;
          sum.w += v[r].w;
        }
      }
    }
    if (t * kQ + i < a.tq) {
      __nv_bfloat16* dst =
          a.dq + b * a.sdq.b + (long long)(t * kQ + i) * a.sdq.t + h * a.sdq.h + c;
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(tc::pack_bf16(sum.x, sum.y), tc::pack_bf16(sum.z, sum.w));
    }
  }
}

// Query tile t's rows of a (B, T, H, D) tensor into `dst` by TMA, in boxes
// of 64 dims, counting on `bar`.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const CUtensorMap* map, MapAxes ax,
                                          int t, int b, int h, unsigned long long* bar) {
  int c[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 1; i < 4; ++i) c[i] = ax.t == i ? t * kQ : ax.h == i ? h : b;
#pragma unroll
  for (int box = 0; box < D / 64; ++box) {
    wg::tma_load(dst + box * kQ * 64, map, 64 * box, c[1], c[2], c[3], bar);
  }
}

// Q and dO of query tile t into buffer t % 2 by TMA, `full[t % 2]`
// counting their bytes (one thread issues it).
template <int D>
__device__ __forceinline__ void load_tile(int t, const CUtensorMap* q_map, MapAxes q_ax,
                                          const CUtensorMap* g_map, MapAxes g_ax, int b, int h,
                                          __nv_bfloat16* q_s, __nv_bfloat16* do_s,
                                          unsigned long long* full) {
  const int s = t & 1;
  wg::expect_tx(&full[s], 2 * kQ * D * 2);
  load_rows<D>(q_s + s * kQ * D, q_map, q_ax, t, b, h, &full[s]);
  load_rows<D>(do_s + s * kQ * D, g_map, g_ax, t, b, h, &full[s]);
}

// The LSE and Di of query tile t into buffer t % 2 by cp.async of consumer
// threads 0 .. 2 kQ - 1, one float each (the caller waits for them).
__device__ __forceinline__ void load_vectors(int t, const bw::Args& a, long long vec0,
                                             float* lse_s, float* di_s) {
  const int q0 = t * kQ, s = t & 1;
  const int e = threadIdx.x % kQ;
  const bool valid = q0 + e < a.tq;
  if (threadIdx.x < kQ) {
    tc::cp_async4(lse_s + s * kQ + e, a.lse + vec0 + (valid ? q0 + e : 0), valid);
  } else if (threadIdx.x < 2 * kQ) {
    tc::cp_async4(di_s + s * kQ + e, a.di + vec0 + (valid ? q0 + e : 0), valid);
  }
  tc::cp_async_commit();
}

}  // namespace og

// dQ, dK and dV in one pass over the scores on wgmma (built at d = 64; d =
// 128 works too).  The one-pass kernel's plan (above) with warpgroups: a
// cluster of C = ceil(Tk / 128) blocks owns one (b, h), block r keys 128 r
// .. 128 r + 127, K and V in shared memory (core matrices, no swizzle); two
// consumer warpgroups of 64 keys each keep their dK and dV sums in
// registers (64 + 64 a thread at d = 128, so setmaxnreg gives them 224 and
// the fourth warpgroup 56).  The 64-query tiles of Q and dO come by TMA
// (128-byte swizzle) into two buffers, their LSE and Di by the consumers'
// cp.async, tile j + 1 while tile j computes.  Per tile, keys as the rows:
// S^T = K Q^T and dP^T = V dO^T (m64n64, both operands from shared memory),
// P^T and dS^T once per score, dV += bf16(P^T) dO and dK += bf16(dS^T) Q
// (m64nD, A from registers: the accumulator layout is the A layout);
// bf16(dS^T) goes to shared memory (stmatrix) and, after a barrier of the
// consumers, warpgroup g's half of the block's partial dQ tile = dS K
// (m64n(D/2), both operands MN-major) goes, in f32, to one of parts(D)
// buffers; after another, which also sees tile j + 1's LSE and Di in, the
// consumers arrive on its `pfull` mbarrier.  The fourth warpgroup: a relay
// warp turns `pfull` into an arrival on every block's `ready` (a release at
// cluster scope, too slow for a consumer) and loads tile t + 2 into tile
// t's buffer; three reducer warps sum rows r, r + C, ... of the cluster's
// partial tiles in rank order through distributed shared memory, write
// them as bf16 dQ and arrive on every block's `freed`.
template <int D>
__global__ void __launch_bounds__(og::kThreads, 1)
attention_bwd_one_pass_wgmma_kernel(const bw::Args a, const __grid_constant__ CUtensorMap q_map,
                                    const __grid_constant__ CUtensorMap g_map, og::MapAxes q_ax,
                                    og::MapAxes g_ax) {
  using S = og::Smem<D>;
  constexpr int kQ = og::kQ;
  constexpr int kParts = og::parts(D);
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kK);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kV);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kQs);
  __nv_bfloat16* do_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kDo);
  float* lse_s = reinterpret_cast<float*>(smem + S::kLse);
  float* di_s = reinterpret_cast<float*>(smem + S::kDi);
  __nv_bfloat16* ds_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kDs);
  float* part = reinterpret_cast<float*>(smem + S::kPart);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + S::kBars);
  unsigned long long* pfull = full + 2;        // this block's partial tile is whole
  unsigned long long* ready = pfull + kParts;  // every block's partial tile is whole
  unsigned long long* freed = ready + kParts;  // every block has summed it

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;  // the cluster spans the grid's x axis
  const int csize = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int key0 = rank * og::kKeys;
  const long long vec0 = ((long long)b * gridDim.y + h) * a.tq;  // this (b, h)'s LSE and Di
  const int tiles = (a.tq + kQ - 1) / kQ;

  if (threadIdx.x == 0) {
    op::mbar_init(&full[0], 1);  // thread 0's arrival with the TMA bytes
    op::mbar_init(&full[1], 1);
    for (int t = 0; t < kParts; ++t) {
      op::mbar_init(&pfull[t], og::kConsumers);
      op::mbar_init(&ready[t], csize);  // one arrival a block of the cluster
      op::mbar_init(&freed[t], csize);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  og::stage<D, og::kKeys, og::kThreads>(k_s, a.k + b * a.sk.b + h * a.sk.h, a.sk.t, key0, a.tk,
                                        threadIdx.x);
  og::stage<D, og::kKeys, og::kThreads>(v_s, a.v + b * a.sv.b + h * a.sv.h, a.sv.t, key0, a.tk,
                                        threadIdx.x);
  tc::cp_async_commit();
  {  // Di for this block's C-th of the rows, two threads a row
    const int per = (a.tq + csize - 1) / csize;
    const int half = threadIdx.x % 2;
    for (int base = 0; base < per; base += og::kThreads / 2) {
      const int r = base + threadIdx.x / 2;
      const int i = rank * per + r;
      const bool live = r < per && i < a.tq;
      float sum = 0.f;
      if (live) {
        const __nv_bfloat16* orow =
            a.o + b * a.so.b + (long long)i * a.so.t + h * a.so.h + half * (D / 2);
        const __nv_bfloat16* grow =
            a.dout + b * a.sdo.b + (long long)i * a.sdo.t + h * a.sdo.h + half * (D / 2);
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
          const uint4 gv = *reinterpret_cast<const uint4*>(grow + 8 * c);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 gf = __bfloat1622float2(g2[e]);
            sum = fmaf(of.x, gf.x, sum);
            sum = fmaf(of.y, gf.y, sum);
          }
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (live && half == 0) a.di[vec0 + i] = sum;
    }
  }
  tc::cp_async_wait<0>();
  wg::proxy_fence();  // K and V, staged by this thread, are read by wgmma
  cluster.sync();     // barriers initialised, K and V staged, every Di of the head written

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (warp >= og::kConsumers / 32) {
    wg::regs_dec<og::kProducerRegs>();
    const int pt = threadIdx.x - og::kConsumers;
    if (pt < og::kRelays) {
      // The relay: partial dQ tile t is whole in this block, so tell every
      // block (a release at cluster scope, which a consumer would wait for);
      // the consumers are done with tile t's Q and dO, so load tile t + 2's
      // in their place.
      if (pt == 0) {
        og::load_tile<D>(0, &q_map, q_ax, &g_map, g_ax, b, h, q_s, do_s, full);
        if (tiles > 1) og::load_tile<D>(1, &q_map, q_ax, &g_map, g_ax, b, h, q_s, do_s, full);
      }
      for (int t = 0; t < tiles; ++t) {
        TRACE(pt == 0, 1, t, 0);
        op::mbar_wait(&pfull[t % kParts], (t / kParts) & 1);
        TRACE(pt == 0, 1, t, 1);
        if (pt < csize) op::mbar_arrive_cluster(&ready[t % kParts], pt);
        if (pt == 0 && t + 2 < tiles) {
          og::load_tile<D>(t + 2, &q_map, q_ax, &g_map, g_ax, b, h, q_s, do_s, full);
        }
      }
    } else {
      // The reducers: the cluster's sum of partial dQ tile t once every
      // block has written its own.
      const int rt = pt - og::kRelays;
      unsigned parts[op::kClusterMax];  // every block's partial tiles
#pragma unroll
      for (int r = 0; r < op::kClusterMax; ++r) {
        parts[r] = og::cluster_addr(part, r < csize ? r : 0);
      }
      for (int t = 0; t < tiles; ++t) {
        const int u = t % kParts;
        TRACE(rt == 0, 2, t, 0);
        op::mbar_wait_cluster(&ready[u], (t / kParts) & 1);
        TRACE(rt == 0, 2, t, 1);
        unsigned bufs[op::kClusterMax];
#pragma unroll
        for (int r = 0; r < op::kClusterMax; ++r) bufs[r] = parts[r] + u * kQ * og::pitch(D) * 4;
        og::sum_partials<D>(bufs, t, rank, csize, a, b, h, rt, og::kReducers);
        TRACE(rt == 0, 2, t, 2);
        og::bar_sync<og::kReducerBarrier, og::kReducers>();  // every read of buffer u is done
        if (rt < csize) op::mbar_arrive_cluster(&freed[u], rt);
      }
    }
    cluster.sync();  // no block leaves while another may read its partial tiles
  } else {
    wg::regs_inc<og::kConsumerRegs>();
    const int grp = warp / 4;          // this warpgroup: keys 64 grp .. 64 grp + 63 of the block
    const int row0 = 16 * (warp % 4);  // this warp's rows of the warpgroup's 64
    const int g = lane / 4;
    const int c0 = 2 * (lane & 3);
    // Keys past Tk (zero rows of K and V) get P = 0.  Queries past Tq need no
    // test: their Q, dO, LSE and Di are staged as zeros, so P = 1 and dS = 0
    // exactly, adding nothing to dK and dV, and their dQ rows are not written.
    const int krow = 64 * grp + row0 + g;
    const bool drop0 = key0 + krow >= a.tk, drop1 = key0 + krow + 8 >= a.tk;
    float dk[D / 8][4], dv[D / 8][4];  // keys krow and krow + 8 by 8-wide column tiles
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
    auto& dk_ = reinterpret_cast<float(&)[D / 2]>(dk);
    auto& dv_ = reinterpret_cast<float(&)[D / 2]>(dv);

    og::load_vectors(0, a, vec0, lse_s, di_s);
    tc::cp_async_wait<0>();
    og::bar_sync<og::kConsumerBarrier, og::kConsumers>();  // tile 0's LSE and Di are in
    for (int j = 0; j < tiles; ++j) {
      // Buffer (j + 1) % 2 was last read by tile j - 1, whose products are done.
      TRACE(threadIdx.x == 0, 0, j, 0);
      if (j + 1 < tiles) og::load_vectors(j + 1, a, vec0, lse_s, di_s);
      op::mbar_wait(&full[j & 1], (j >> 1) & 1);  // tile j's Q and dO
      TRACE(threadIdx.x == 0, 0, j, 1);
      const __nv_bfloat16* qs = q_s + (j & 1) * kQ * D;
      const __nv_bfloat16* gs = do_s + (j & 1) * kQ * D;
      const float* ls = lse_s + (j & 1) * kQ;
      const float* ds = di_s + (j & 1) * kQ;

      float st[kQ / 2], dpt[kQ / 2];  // S^T and dP^T: keys krow, krow + 8 by the tile's queries
      wg::fence();
      wg::mma_ss0<0, 0>(st, wg::k_major<D>(k_s, 64 * grp, 0), wg::sw128_k<kQ>(qs, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        wg::mma_ss<0, 0>(st, wg::k_major<D>(k_s, 64 * grp, 16 * kk), wg::sw128_k<kQ>(qs, kk));
      }
      wg::mma_ss0<0, 0>(dpt, wg::k_major<D>(v_s, 64 * grp, 0), wg::sw128_k<kQ>(gs, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        wg::mma_ss<0, 0>(dpt, wg::k_major<D>(v_s, 64 * grp, 16 * kk), wg::sw128_k<kQ>(gs, kk));
      }
      wg::commit();
      wg::wait<0>();
      wg::hold(st);
      wg::hold(dpt);
      TRACE(threadIdx.x == 0, 0, j, 2);

      unsigned pa[kQ / 16][4], sa[kQ / 16][4];  // bf16 P^T and dS^T, A fragments of 16 queries
#pragma unroll
      for (int n = 0; n < kQ / 8; ++n) {
        const int qi = 8 * n + c0;  // queries qi, qi + 1 of the tile
        const float2 l2 = *reinterpret_cast<const float2*>(ls + qi);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + qi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = tc::ex2(fmaf(st[4 * n + e], a.scale_log2, -(e & 1 ? l2.y : l2.x)));
          if (e < 2 ? drop0 : drop1) p = 0.f;
          st[4 * n + e] = p;
          dpt[4 * n + e] = (dpt[4 * n + e] - (e & 1 ? d2.y : d2.x)) * p * a.scale;  // dS^T
        }
        pa[n / 2][2 * (n % 2)] = tc::pack_bf16(st[4 * n], st[4 * n + 1]);
        pa[n / 2][2 * (n % 2) + 1] = tc::pack_bf16(st[4 * n + 2], st[4 * n + 3]);
        sa[n / 2][2 * (n % 2)] = tc::pack_bf16(dpt[4 * n], dpt[4 * n + 1]);
        sa[n / 2][2 * (n % 2) + 1] = tc::pack_bf16(dpt[4 * n + 2], dpt[4 * n + 3]);
      }

      TRACE(threadIdx.x == 0, 0, j, 3);
      // dV += P^T dO and dK += dS^T Q, 16 queries a step.
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        wg::mma_rs<1>(dv_, pa[kk], wg::sw128_mn<kQ>(gs, kk));
      }
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        wg::mma_rs<1>(dk_, sa[kk], wg::sw128_mn<kQ>(qs, kk));
      }
      wg::commit();
      // bf16(dS^T) for the partial dQ product: four 8 x 8 matrices a step.
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        tc::stmatrix_x4(ds_s + wg::at<kQ>(64 * grp + row0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                          16 * kk + 8 * (lane >> 4)),
                        sa[kk]);
      }
      wg::proxy_fence();
      og::bar_sync<og::kConsumerBarrier, og::kConsumers>();  // dS^T of both warpgroups is in ds_s
      TRACE(threadIdx.x == 0, 0, j, 4);
      const int u = j % kParts;
      if (j >= kParts) {  // every block has summed tile j - kParts from buffer u
        op::mbar_wait_cluster(&freed[u], (j / kParts - 1) & 1);
      }
      TRACE(threadIdx.x == 0, 0, j, 5);
      wg::wait<0>();  // dV and dK
      wg::hold(dk_);
      wg::hold(dv_);
      TRACE(threadIdx.x == 0, 0, j, 6);

      // This warpgroup's half of the block's partial dQ tile = dS K over its
      // keys, f32.
      float dq[D / 4];
      wg::fence();
      wg::mma_ss0<1, 1>(dq, wg::mn_major<kQ>(ds_s, 0, 0), wg::mn_major<D>(k_s, 0, grp * (D / 2)));
#pragma unroll
      for (int kk = 1; kk < og::kKeys / 16; ++kk) {
        wg::mma_ss<1, 1>(dq, wg::mn_major<kQ>(ds_s, 16 * kk, 0),
                         wg::mn_major<D>(k_s, 16 * kk, grp * (D / 2)));
      }
      wg::commit();
      wg::wait<0>();
      wg::hold(dq);
      TRACE(threadIdx.x == 0, 0, j, 7);
      {
        float* prow = part + (u * kQ + row0 + g) * og::pitch(D) + grp * (D / 2) + c0;
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          *reinterpret_cast<float2*>(prow + 8 * n) = make_float2(dq[4 * n], dq[4 * n + 1]);
          *reinterpret_cast<float2*>(prow + 8 * og::pitch(D) + 8 * n) =
              make_float2(dq[4 * n + 2], dq[4 * n + 3]);
        }
      }
      TRACE(threadIdx.x == 0, 0, j, 8);
      tc::cp_async_wait<0>();  // this thread's share of tile j + 1's LSE and Di
      // ds_s is read, the partial tile is whole, tile j + 1's LSE and Di are in.
      og::bar_sync<og::kConsumerBarrier, og::kConsumers>();
      TRACE(threadIdx.x == 0, 0, j, 9);
      op::mbar_arrive(&pfull[u]);  // cheap: a release at the block's scope only
    }
    bw::store_rows<D>(a.dk + b * a.sdk.b + h * a.sdk.h, a.sdk.t, key0 + 64 * grp + row0, a.tk, dk);
    bw::store_rows<D>(a.dv + b * a.sdv.b + h * a.sdv.h, a.sdv.t, key0 + 64 * grp + row0, a.tk, dv);
    cluster.sync();  // no block leaves while another may read its partial tiles
  }
}

// ---- f32 on the CUDA cores ----

namespace cc {

constexpr int kGroups = 64;  // row groups per block; a group is the kParts threads of a row

// Query rows per thread where the grid allows more than one: 4 at d = 16 and 2
// at d = 32, so that each 16-byte load of a staged key feeds 4 R FMAs; 1 at
// d = 64 and 128, whose rows are split over threads and which no served path
// runs in f32.
constexpr int wide_rows(int d) { return d == 16 ? 4 : d == 32 ? 2 : 1; }

template <int D, int R>
struct Tiling {
  static constexpr int kSlice = D < 32 ? D : 32;           // dims of a row per thread
  static constexpr int kParts = D / kSlice;                // threads per query row
  static constexpr int kThreads = kGroups * kParts;
  static constexpr int kRows = kGroups * R;                // query rows per block
  static constexpr int kKeys = D <= 32 ? 64 : 2048 / D;    // keys per staged tile
  static constexpr int kChunk = 32 / R < 16 ? 32 / R : 16; // keys per softmax step
  static constexpr int kPad = kParts > 1 ? 4 : 0;          // floats between the slices of a key
  static constexpr int kPitch = kParts * (kSlice + kPad);  // floats per staged key
  static constexpr int kTile = kKeys * kPitch;             // floats per stage
  static constexpr int kVecs = kKeys * D / 4;              // 16-byte copies per stage
  static_assert(D % kSlice == 0 && kSlice % 4 == 0, "head dim");
  static_assert(kKeys % kChunk == 0 && kVecs % kThreads == 0, "tiling");
  __device__ static __forceinline__ int at(int key, int dim) {  // float offset in a stage
    return key * kPitch + (dim / kSlice) * (kSlice + kPad) + dim % kSlice;
  }
};

// Keys j0 .. j0 + kKeys - 1 of a (tk, D) f32 matrix with row stride `st` into
// a stage; keys past tk become zeros.  With `vec` (every row 16-byte aligned)
// by 16-byte cp.async copies, else element by element and synchronously.
template <int D, int R>
__device__ __forceinline__ void stage(float* dst, const float* src, long long st, int j0, int tk,
                                      bool vec) {
  using L = Tiling<D, R>;
  if (vec) {  // kept a loop: unrolled, four f32 instances spilled
#pragma unroll 1
    for (int i = 0; i < L::kVecs / L::kThreads; ++i) {
      const int e = threadIdx.x + i * L::kThreads;
      const int key = e / (D / 4);
      const int dim = e % (D / 4) * 4;
      const bool valid = j0 + key < tk;
      tc::cp_async16(dst + L::at(key, dim), src + (valid ? j0 + key : 0) * st + dim, valid);
    }
  } else {
    for (int e = threadIdx.x; e < L::kKeys * D; e += L::kThreads) {
      const int key = e / D;
      const int dim = e % D;
      dst[L::at(key, dim)] = j0 + key < tk ? src[(j0 + key) * st + dim] : 0.f;
    }
  }
}

}  // namespace cc

// One block per SM is enough (the wide tiling is taken only where the grid
// fills the SMs): without that bound ptxas kept some instances to fewer
// registers, and they spilled.
template <int D, int R>
__global__ void __launch_bounds__(cc::Tiling<D, R>::kThreads, 1)
attention_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, Strides sq, Strides sk,
                     Strides sv, Strides so, int tq, int tk, float scale_log2, bool vec) {
  using L = cc::Tiling<D, R>;
  constexpr int kSlice = L::kSlice;
  constexpr int kChunk = L::kChunk;
  __shared__ __align__(16) float k_s[2 * L::kTile];  // two stages
  __shared__ __align__(16) float v_s[2 * L::kTile];

  const int part = threadIdx.x % L::kParts;
  const int row0 = blockIdx.x * L::kRows + threadIdx.x / L::kParts;  // rows row0 + 64 r
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  cc::stage<D, R>(k_s, kb, sk.t, 0, tk, vec);
  cc::stage<D, R>(v_s, vb, sv.t, 0, tk, vec);
  tc::cp_async_commit();

  // As in the bf16 instance, a negative scale flips the sign of Q (exact), so
  // the max of the raw scores is the max of the scaled ones.
  const float sc = fabsf(scale_log2);
  const float q_sign = scale_log2 < 0.f ? -1.f : 1.f;
  float qr[R][kSlice];
  float acc[R][kSlice];  // unnormalised output sums
  float m[R];            // running max of the scaled scores (base 2)
  float l[R];            // running sum of exp2(s - m)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + cc::kGroups * r;
    const bool live = i < tq;
    const float* qrow = q + b * sq.b + (long long)(live ? i : 0) * sq.t + h * sq.h + part * kSlice;
#pragma unroll
    for (int c = 0; c < kSlice; ++c) {
      qr[r][c] = live ? q_sign * qrow[c] : 0.f;
      acc[r][c] = 0.f;
    }
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  const int tiles = (tk + L::kKeys - 1) / L::kKeys;
  for (int j = 0; j < tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < tiles) {  // the next tile loads while this one computes
      const int at = (j + 1) * L::kKeys;
      cc::stage<D, R>(k_s + (cur ^ 1) * L::kTile, kb, sk.t, at, tk, vec);
      cc::stage<D, R>(v_s + (cur ^ 1) * L::kTile, vb, sv.t, at, tk, vec);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();

    const float* ks = k_s + cur * L::kTile + part * (kSlice + L::kPad);
    const float* vs = v_s + cur * L::kTile + part * (kSlice + L::kPad);
    const int keys = min(L::kKeys, tk - j * L::kKeys);  // keys before tk in this tile
#pragma unroll 1
    for (int c0 = 0; c0 < keys; c0 += kChunk) {
      const bool ragged = c0 + kChunk > keys;  // only in the last tile

      // Raw scores of R rows and kChunk keys.  All lanes of a row slice read
      // the same staged key: a broadcast, 16 bytes at a time.
      float s[R][kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(ks + (c0 + jj) * L::kPitch);
#pragma unroll
        for (int r = 0; r < R; ++r) s[r][jj] = 0.f;
#pragma unroll
        for (int c = 0; c < kSlice / 4; ++c) {
          const float4 kk = kr[c];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            s[r][jj] = fmaf(qr[r][4 * c], kk.x, s[r][jj]);
            s[r][jj] = fmaf(qr[r][4 * c + 1], kk.y, s[r][jj]);
            s[r][jj] = fmaf(qr[r][4 * c + 2], kk.z, s[r][jj]);
            s[r][jj] = fmaf(qr[r][4 * c + 3], kk.w, s[r][jj]);
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int off = L::kParts / 2; off > 0; off /= 2)
            s[r][jj] += __shfl_xor_sync(0xffffffffu, s[r][jj], off);
      }
      if (ragged) {  // keys past tk take no part in the max
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj)
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (c0 + jj >= keys) s[r][jj] = -INFINITY;
      }

      // Online softmax: one rescale of the sums per chunk, then per score one
      // FFMA (scale and max folded) and one ex2.
      float neg_m[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mx = s[r][0];
#pragma unroll
        for (int jj = 1; jj < kChunk; ++jj) mx = fmaxf(mx, s[r][jj]);
        const float m_new = fmaxf(m[r], mx * sc);  // finite: the chunk holds a key before tk
        const float alpha = tc::ex2(m[r] - m_new);  // 0 on the first chunk
        m[r] = m_new;
        neg_m[r] = -m_new;
        l[r] *= alpha;
#pragma unroll
        for (int c = 0; c < kSlice; ++c) acc[r][c] *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float p = tc::ex2(fmaf(s[r][jj], sc, neg_m[r]));
          if (ragged && c0 + jj >= keys) p = 0.f;  // NaN when sc = 0
          s[r][jj] = p;
          l[r] += p;
        }

      // O += P V, each staged value row feeding R rows.
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* vr = reinterpret_cast<const float4*>(vs + (c0 + jj) * L::kPitch);
#pragma unroll
        for (int c = 0; c < kSlice / 4; ++c) {
          const float4 vv = vr[c];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][4 * c] = fmaf(s[r][jj], vv.x, acc[r][4 * c]);
            acc[r][4 * c + 1] = fmaf(s[r][jj], vv.y, acc[r][4 * c + 1]);
            acc[r][4 * c + 2] = fmaf(s[r][jj], vv.z, acc[r][4 * c + 2]);
            acc[r][4 * c + 3] = fmaf(s[r][jj], vv.w, acc[r][4 * c + 3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is overwritten by the load of tile j + 2
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + cc::kGroups * r;
    if (i < tq) {
      float* orow = o + b * so.b + (long long)i * so.t + h * so.h + part * kSlice;
#pragma unroll
      for (int c = 0; c < kSlice; ++c) orow[c] = acc[r][c] / l[r];
    }
  }
}

// Query rows per thread of a float32 launch: the wide tiling where its grid
// still gives each of the device's `sms` SMs a block, else one.
int f32_rows_per_thread(int b, int h, int tq, int d, int sms) {
  const int wide = cc::wide_rows(d);
  const long long row_blocks = (tq + cc::kGroups * wide - 1) / (cc::kGroups * wide);
  return row_blocks * h * b >= sms ? wide : 1;
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <int D, int R>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, Strides sq,
                       Strides sk, Strides sv, Strides so, int b, int h, int tq, int tk,
                       float scale_log2, bool vec, cudaStream_t stream) {
  using L = cc::Tiling<D, R>;
  const dim3 grid((tq + L::kRows - 1) / L::kRows, h, b);
  attention_kernel_f32<D, R><<<grid, L::kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), sq, sk, sv, so, tq, tk, scale_log2, vec);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32_rows(int rows, const void* q, const void* k, const void* v, void* o,
                            Strides sq, Strides sk, Strides sv, Strides so, int b, int h, int tq,
                            int tk, float scale_log2, bool vec, cudaStream_t stream) {
  constexpr int kWide = cc::wide_rows(D);
  if (rows == kWide) {
    return launch_f32<D, kWide>(q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, vec, stream);
  }
  return launch_f32<D, 1>(q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, vec, stream);
}

bool rows_aligned16(const void* p, Strides s) {  // every row of a 4-byte type on 16 bytes
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && s.b % 4 == 0 && s.t % 4 == 0 &&
         s.h % 4 == 0;
}

cudaError_t launch_f32_for_dim(int d, const void* q, const void* k, const void* v, void* o,
                               Strides sq, Strides sk, Strides sv, Strides so, int b, int h,
                               int tq, int tk, float scale_log2, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int rows = f32_rows_per_thread(b, h, tq, d, sms);
  const bool vec = rows_aligned16(k, sk) && rows_aligned16(v, sv);
  switch (d) {
    case 16:
      return launch_f32_rows<16>(rows, q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, vec,
                                 stream);
    case 32:
      return launch_f32_rows<32>(rows, q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, vec,
                                 stream);
    case 64:
      return launch_f32_rows<64>(rows, q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, vec,
                                 stream);
    case 128:
      return launch_f32_rows<128>(rows, q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2,
                                  vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory above the 48 KB default needs an opt-in, once per
// kernel and device (`opted_in`, the kernel's own, holds a bit per device).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<unsigned long long>& opted_in) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((opted_in.load() >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted_in.fetch_or(1ull << dev);
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, Strides sq,
                        Strides sk, Strides sv, Strides so, int b, int h, int tq, int tk,
                        float scale_log2, float* lse, cudaStream_t stream) {
  constexpr int kSmem = 5 * tc::Tile<D>::kElems * sizeof(__nv_bfloat16);  // Q, 2 x (K, V)
  static std::atomic<unsigned long long> opted_in{0};
  const cudaError_t err = allow_smem(attention_kernel_bf16<D>, kSmem, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + tc::kRows - 1) / tc::kRows, h, b);
  using bf16 = __nv_bfloat16;
  attention_kernel_bf16<D><<<grid, tc::kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), sq, sk, sv, so, tq, tk, scale_log2, lse);
  return cudaGetLastError();
}

cudaError_t launch_bf16_for_dim(int d, const void* q, const void* k, const void* v, void* o,
                                Strides sq, Strides sk, Strides sv, Strides so, int b, int h,
                                int tq, int tk, float scale_log2, float* lse,
                                cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_bf16<16>(q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, lse, stream);
    case 32:
      return launch_bf16<32>(q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, lse, stream);
    case 64:
      return launch_bf16<64>(q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, lse, stream);
    case 128:
      return launch_bf16<128>(q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, lse, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The dQ kernel (which writes Di), then the dK/dV kernel, on one stream.
template <int D>
cudaError_t launch_backward(const bw::Args& a, int b, int h, cudaStream_t stream) {
  constexpr int kQ = bw::q_tile(D);
  // dQ: Q, dO, two stages of K and V; the rows' LSE and Di.
  constexpr int kDqSmem = 6 * tc::Tile<D>::kElems * sizeof(__nv_bfloat16) + 2 * bw::kRows * 4;
  // dK/dV: K, V, two stages of Q and dO and of the queries' LSE and Di.
  constexpr int kDkvSmem = (2 * tc::Tile<D>::kElems + 4 * tc::Tile<D, kQ>::kElems) *
                               sizeof(__nv_bfloat16) + 4 * kQ * 4;
  static std::atomic<unsigned long long> dq_opted_in{0}, dkv_opted_in{0};
  cudaError_t err = allow_smem(attention_bwd_dq_kernel<D>, kDqSmem, dq_opted_in);
  if (err != cudaSuccess) return err;
  err = allow_smem(attention_bwd_dkv_kernel<D>, kDkvSmem, dkv_opted_in);
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<D>
      <<<dim3((a.tq + bw::kRows - 1) / bw::kRows, h, b), tc::kThreads, kDqSmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<D>
      <<<dim3((a.tk + bw::kKeys - 1) / bw::kKeys, h, b), tc::kThreads, kDkvSmem, stream>>>(a);
  return cudaGetLastError();
}

// The one-pass kernel: a cluster of ceil(Tk / 128) blocks for each (b, h).
template <int D>
cudaError_t launch_one_pass(const bw::Args& a, int b, int h, cudaStream_t stream) {
  constexpr int kSmem = op::Smem<D>::kBytes;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = allow_smem(attention_bwd_one_pass_kernel<D>, kSmem, opted_in);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (a.tk + op::kKeys - 1) / op::kKeys;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, h, b);
  cfg.blockDim = dim3(op::kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = blocks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attention_bwd_one_pass_kernel<D>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The wgmma one-pass kernel: a cluster of ceil(Tk / 128) blocks for each
// (b, h).  setmaxnreg deals out the registers the launch gave the block, so
// a build that gave the kernel fewer than og::kLaunchRegs would hang at it:
// such a build is refused here.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once (no link to libcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map of a (B, T, H, D) bf16 tensor with element strides `st`, in
// boxes of 64 dims by og::kQ rows with the 128-byte swizzle; its axes after
// the head dim in order of stride (`ax` says where each went).
template <int D>
cudaError_t rows_map(CUtensorMap* map, og::MapAxes* ax, const void* base, Strides st, int t,
                     int h, int b) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  long long stride[3] = {st.t, st.h, st.b};
  int size[3] = {t, h, b}, order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)  // by stride, a stable insertion sort
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int k = order[j];
      order[j] = order[j - 1];
      order[j - 1] = k;
    }
  cuuint64_t dims[4] = {D, 0, 0, 0}, strides[3];
  int* where[3] = {&ax->t, &ax->h, &ax->b};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = size[order[i]];
    strides[i] = 2 * stride[order[i]];
    *where[order[i]] = i + 1;
  }
  cuuint32_t box[4] = {64, 1, 1, 1};
  box[ax->t] = og::kQ;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The wgmma one-pass kernel: a cluster of ceil(Tk / 128) blocks for each
// (b, h).  setmaxnreg deals out the registers the launch gave the block, so
// a build that gave the kernel fewer than og::kLaunchRegs would hang at it:
// such a build is refused here.
template <int D>
cudaError_t launch_one_pass_wgmma(const bw::Args& a, int b, int h, cudaStream_t stream) {
  constexpr int kSmem = og::Smem<D>::kBytes;
  static std::atomic<unsigned long long> opted_in{0};
  static std::atomic<int> regs{0};
  cudaError_t err = allow_smem(attention_bwd_one_pass_wgmma_kernel<D>, kSmem, opted_in);
  if (err != cudaSuccess) return err;
  if (regs.load() == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, attention_bwd_one_pass_wgmma_kernel<D>);
    if (err != cudaSuccess) return err;
    regs.store(attr.numRegs);
  }
  if (regs.load() < og::kLaunchRegs) return cudaErrorInvalidKernelImage;
  CUtensorMap q_map, g_map;
  og::MapAxes q_ax, g_ax;
  err = rows_map<D>(&q_map, &q_ax, a.q, a.sq, a.tq, h, b);
  if (err != cudaSuccess) return err;
  err = rows_map<D>(&g_map, &g_ax, a.dout, a.sdo, a.tq, h, b);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (a.tk + og::kKeys - 1) / og::kKeys;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, h, b);
  cfg.blockDim = dim3(og::kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = blocks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attention_bwd_one_pass_wgmma_kernel<D>, a, q_map, g_map, q_ax,
                           g_ax);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The backward's path for Tk keys at head dim d, where one cluster covers
// the keys: 1, the one-pass kernel on mma.sync (d = 16), 3, the one-pass
// kernel on wgmma (d = 64); else 2, the dQ and dK/dV kernels.  The one-pass
// kernels are instantiated at these head dims only.  At d = 128 the wgmma
// kernel measured slower than the two kernels (PERF.md): a copy of this
// source with `d == 64 || d == 128` in wgmma_dim times it.
constexpr bool one_pass_dim(int d) { return d == 16; }
constexpr bool wgmma_dim(int d) { return d == 64; }
int backward_path(int tk, int d) {
  if (one_pass_dim(d) && tk <= op::kMaxKeys) return 1;
  if (wgmma_dim(d) && tk <= og::kMaxKeys) return 3;
  return 2;
}

template <int D>
cudaError_t launch_backward_path(const bw::Args& a, int b, int h, cudaStream_t stream) {
  const int path = backward_path(a.tk, D);
  if constexpr (one_pass_dim(D)) {
    if (path == 1) return launch_one_pass<D>(a, b, h, stream);
  }
  if constexpr (wgmma_dim(D)) {
    if (path == 3) return launch_one_pass_wgmma<D>(a, b, h, stream);
  }
  return launch_backward<D>(a, b, h, stream);
}

float log2e_times(float scale) { return (float)((double)scale * 1.4426950408889634); }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, (batch, time,
// head) for each of q, k, v, o; the head dim has stride 1.  With `lse` (bf16
// only; nullptr for none) the kernel also writes each query row's
// log-sum-exp, base 2 (log2 sum_j 2^(s_j scale log2(e))), into that
// contiguous (B, H, Tq) f32 tensor, for the backward.
extern "C" int attention_lse_launch(const void* q, const void* k, const void* v, void* o,
                                    int dtype, int b, int h, int tq, int tk, int d,
                                    long long qb, long long qt, long long qh,
                                    long long kb, long long kt, long long kh,
                                    long long vb, long long vt, long long vh,
                                    long long ob, long long ot, long long oh,
                                    float scale, void* stream, float* lse) {
  const Strides sq{qb, qt, qh}, sk{kb, kt, kh}, sv{vb, vt, vh}, so{ob, ot, oh};
  const float scale_log2 = log2e_times(scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && lse == nullptr) {
    err = launch_f32_for_dim(d, q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, s);
  } else if (dtype == 1) {
    err = launch_bf16_for_dim(d, q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, lse, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// attention_lse_launch without the log-sum-exp.
extern "C" int attention_launch(const void* q, const void* k, const void* v, void* o,
                                int dtype, int b, int h, int tq, int tk, int d,
                                long long qb, long long qt, long long qh,
                                long long kb, long long kt, long long kh,
                                long long vb, long long vt, long long vh,
                                long long ob, long long ot, long long oh,
                                float scale, void* stream) {
  return attention_lse_launch(q, k, v, o, dtype, b, h, tq, tk, d, qb, qt, qh, kb, kt, kh, vb,
                              vt, vh, ob, ot, oh, scale, stream, nullptr);
}

// K4's backward, bf16: dq, dk and dv of the attention whose output `o` and
// row log-sum-exp `lse` attention_lse_launch gave, for the output gradient
// `dout`.  `di` is (B, H, Tq) f32 scratch, `lse` the same shape, both
// contiguous; `strides` holds the (batch, time, head) element strides of q,
// k, v, o, dout, dq, dk and dv, in that order, 24 values; every bf16 row
// 16-byte aligned, as for the forward.  Two launches on the caller's stream;
// returns the first error.
extern "C" int attention_backward_launch(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         float* di, void* dq, void* dk, void* dv, int b, int h,
                                         int tq, int tk, int d, const long long* strides,
                                         float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const bw::Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const bf16*>(o),
                   static_cast<const bf16*>(dout), lse, di, static_cast<bf16*>(dq),
                   static_cast<bf16*>(dk), static_cast<bf16*>(dv), st[0], st[1], st[2], st[3],
                   st[4], st[5], st[6], st[7], tq, tk, log2e_times(scale), scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 16: err = launch_backward_path<16>(a, b, h, s); break;
    case 32: err = launch_backward_path<32>(a, b, h, s); break;
    case 64: err = launch_backward_path<64>(a, b, h, s); break;
    case 128: err = launch_backward_path<128>(a, b, h, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The path attention_backward_launch takes for Tk keys at head dim d: 1 the
// one-pass kernel on mma.sync (one launch), 2 the dQ and dK/dV kernels (two
// launches), 3 the one-pass kernel on wgmma (one launch).
extern "C" int attention_backward_path(int tk, int d) { return backward_path(tk, d); }

// Scores one warp handles in a trip of a backward kernel's main loop at head
// dim d, from its tiles: kernel 0 the dQ kernel (16 query rows by a key
// tile), 1 the dK/dV kernel (16 keys by a query tile), 2 the one-pass kernel
// and 3 its wgmma form (16 keys by a query tile); -1 where there is no such
// instance.
extern "C" int attention_backward_loop_scores(int kernel, int d) {
  if (d != 16 && d != 32 && d != 64 && d != 128) return -1;
  switch (kernel) {
    case 0: return 16 * bw::kKeys;
    case 1: return 16 * bw::q_tile(d);
    case 2: return one_pass_dim(d) ? 16 * op::kQ : -1;
    case 3: return wgmma_dim(d) ? 16 * og::kQ : -1;
    default: return -1;
  }
}

// Query rows per thread that attention_launch gives a float32 call of this
// shape on the current device (1, 2 or 4), or -1 if the device cannot be read.
extern "C" int attention_f32_rows_per_thread(int b, int h, int tq, int d) {
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  return f32_rows_per_thread(b, h, tq, d, sms);
}
