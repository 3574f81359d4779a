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
// K4's backward (attention_bwd_dq_kernel<D>, attention_bwd_dkv_kernel<D>,
// bf16) replaces the stock Pallas _flash_attention_bwd_dq and
// _flash_attention_bwd_dkv of jax/experimental/pallas/ops/tpu/
// flash_attention.py (:1287, :941, reached from _flash_attention_bwd :254),
// and computes what they compute: S from the bf16 operands in f32 times the
// scale, P = exp(S - LSE) in f32 from the forward's row log-sum-exp (which
// the forward writes when asked, base 2), Di = sum_d O dO in f32 from the
// bf16 output, dV = bf16(P)^T dO, dP = dO V^T, dS = (dP - Di) P scale, dK =
// bf16(dS)^T Q, dQ = bf16(dS) K, every sum in f32.  What bounds it: the five
// products, 10 B H Tq Tk d operations on the tensor cores (at ART's (16, 8,
// 1024, 16) 2.15e10, 0.022 ms at 989 TFLOP/s) against 35 MB, and again the
// 2 B H Tq Tk exponentials on the SFU at d = 16.  The design is
// FlashAttention-2's backward as two kernels, like JAX's, so nothing is
// summed with atomics and every run gives the same bits: the dQ kernel owns
// 64 query rows (Q, dO, LSE in shared memory; Di computed in its prologue and
// written for the other kernel) and walks the keys; the dK/dV kernel owns 64
// keys (K, V in shared memory, dK and dV summed in f32 registers) and walks
// the queries, 32 a tile at d = 128 (64 below) so the sums and the tile's
// scores fit in registers.  With the keys as the rows, S^T = K Q^T and dP^T =
// V dO^T come out in the accumulator layout, which is the A layout, so P^T
// and dS^T feed dV and dK from registers.  Both recompute S and dP: 7
// products where the bound counts 5.  Staging, ldmatrix and the swizzle are
// the forward's; a negative scale flips Q (dQ kernel) or K (dK/dV kernel).
// Keys past Tk and queries past Tq get P = 0.
//
// The entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() (or cudaErrorInvalidValue for a head dim or type
// they have no instance for) so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

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
    case 16: err = launch_backward<16>(a, b, h, s); break;
    case 32: err = launch_backward<32>(a, b, h, s); break;
    case 64: err = launch_backward<64>(a, b, h, s); break;
    case 128: err = launch_backward<128>(a, b, h, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Query rows per thread that attention_launch gives a float32 call of this
// shape on the current device (1, 2 or 4), or -1 if the device cannot be read.
extern "C" int attention_f32_rows_per_thread(int b, int h, int tq, int d) {
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  return f32_rows_per_thread(b, h, tq, d, sms);
}
