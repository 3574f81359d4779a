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
// use.  Here nothing of size Tk is kept: a block owns 64 query rows of one
// (b, h), walks the keys in tiles staged in shared memory and runs an online
// softmax over them (a running max and sum per row; the output sums are
// rescaled when the max grows), so any Tk works.  The exponentials are base
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
// f32 (attention_kernel<float, D>): the FMAs on the CUDA cores (67 TFLOP/s;
// TF32 tensor cores would change the numerics).  Each thread owns one query
// row, or a 32-wide slice of it when d > 32 (at d = 128 a whole row would
// take q (128), the output sums (128) and the tile's 32 scores in registers,
// over the 255 a thread may have); the d / 32 threads of a row are
// neighbours in one warp and add their partial dot products with shuffles.
// Keys come in tiles of 32, staged as f32; each 32-wide slice of a staged row
// sits 4 floats from the next, so the slices a warp reads at once fall in
// different banks, and all threads of one slice read the same address (a
// broadcast), 16 bytes at a time.
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
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a head dim or type
// it has no instance for) so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kRows = 64;  // query rows per block
constexpr int kKeys = 32;  // keys per staged tile
constexpr int kPad = 4;    // floats between the 32-wide slices of a staged row

template <int D>
struct Split {
  static constexpr int kSlice = D < 32 ? D : 32;  // dims of a row per thread
  static constexpr int kParts = D / kSlice;       // threads per query row
  static constexpr int kPitch = kParts * (kSlice + kPad);  // floats per staged key
  static constexpr int kThreads = kRows * kParts;
  static_assert(D % kSlice == 0 && kSlice % 4 == 0, "head dim");
};

struct Strides {
  long long b, t, h;  // element strides of the batch, time and head axes
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
// A probability rounded to the operand type (round to nearest even).
__device__ __forceinline__ float as_operand(float x, const float*) { return x; }

template <typename T, int D>
__global__ void __launch_bounds__(Split<D>::kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so,
                 int tq, int tk, float scale_log2) {
  using S = Split<D>;
  constexpr int kSlice = S::kSlice;
  __shared__ __align__(16) float k_s[kKeys * S::kPitch];
  __shared__ __align__(16) float v_s[kKeys * S::kPitch];

  const int tid = threadIdx.x;
  const int part = tid % S::kParts;
  const int i = blockIdx.x * kRows + tid / S::kParts;  // query row
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool live = i < tq;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  float qr[kSlice];
  float acc[kSlice];
  {
    const T* qrow = q + b * sq.b + (long long)(live ? i : 0) * sq.t + h * sq.h + part * kSlice;
#pragma unroll
    for (int c = 0; c < kSlice; ++c) {
      qr[c] = live ? load_f32(qrow + c) : 0.f;
      acc[c] = 0.f;
    }
  }
  float m = -INFINITY;  // running max of the scores (base 2)
  float l = 0.f;        // running sum of exp2(s - m)

  for (int j0 = 0; j0 < tk; j0 += kKeys) {
    for (int e = tid; e < kKeys * D; e += S::kThreads) {
      const int jj = e / D;
      const int dd = e % D;
      const int j = j0 + jj;
      const int at = jj * S::kPitch + (dd / kSlice) * (kSlice + kPad) + dd % kSlice;
      k_s[at] = j < tk ? load_f32(kb + j * sk.t + dd) : 0.f;
      v_s[at] = j < tk ? load_f32(vb + j * sv.t + dd) : 0.f;
    }
    __syncthreads();

    float s[kKeys];
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      const float4* kr =
          reinterpret_cast<const float4*>(k_s + jj * S::kPitch + part * (kSlice + kPad));
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kSlice / 4; ++c) {
        const float4 kk = kr[c];
        dot = fmaf(qr[4 * c], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
#pragma unroll
      for (int off = S::kParts / 2; off > 0; off /= 2) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      s[jj] = j0 + jj < tk ? dot * scale_log2 : -INFINITY;
      tile_max = fmaxf(tile_max, s[jj]);
    }

    const float m_new = fmaxf(m, tile_max);  // finite: every tile holds a key
    const float alpha = exp2f(m - m_new);    // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int c = 0; c < kSlice; ++c) acc[c] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      const float p = exp2f(s[jj] - m_new);
      l += p;
      const float pv = as_operand(p, k);
      const float4* vr =
          reinterpret_cast<const float4*>(v_s + jj * S::kPitch + part * (kSlice + kPad));
#pragma unroll
      for (int c = 0; c < kSlice / 4; ++c) {
        const float4 vv = vr[c];
        acc[4 * c] = fmaf(pv, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(pv, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(pv, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(pv, vv.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (live) {
    T* orow = o + b * so.b + (long long)i * so.t + h * so.h + part * kSlice;
#pragma unroll
    for (int c = 0; c < kSlice; ++c) store(orow + c, acc[c] / l);
  }
}

// ---- bf16 on the tensor cores ----

namespace tc {

constexpr int kRows = 64;   // query rows per block, 16 per warp
constexpr int kKeys = 64;   // keys per staged tile
constexpr int kThreads = 128;

// A (64, D) bf16 tile in shared memory: row r's 16-byte chunk c sits at chunk
// c ^ f(r), where f spreads the eight rows an ldmatrix phase reads (rows
// 8i..8i+7, one chunk each) over the eight 16-byte bank groups of 128 bytes.
template <int D>
struct Tile {
  static constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;
  static constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
  static constexpr int kElems = kRows * D;
  static_assert(kRows == kKeys, "one tile shape for Q, K and V");
  static_assert(D % 16 == 0, "head dim");
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

// Rows r0 .. r0 + 63 of a (rows, D) bf16 matrix with row stride `st` into a
// tile, 16 bytes a thread; rows past `rows` become zeros.
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                      long long st, int r0, int rows) {
  using L = Tile<D>;
#pragma unroll
  for (int i = 0; i < kRows * L::kChunks / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / L::kChunks;
    const int c = e % L::kChunks;
    const bool valid = r0 + r < rows;
    cp_async16(dst + L::at(r, c), src + (valid ? r0 + r : 0) * st + c * 8, valid);
  }
}

}  // namespace tc

template <int D>
__global__ void __launch_bounds__(tc::kThreads)
attention_kernel_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      Strides sq, Strides sk, Strides sv, Strides so, int tq, int tk,
                      float scale_log2) {
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
    const __nv_bfloat16* vs = v_s + cur * L::kElems;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned pa[4] = {tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < kSteps; ++nd) {
        unsigned vf[4];
        tc::ldmatrix_x4_trans(vf, vs + L::at(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                                             2 * nd + (lane >> 4)));
        tc::mma_bf16(acc[2 * nd], pa, vf[0], vf[1]);
        tc::mma_bf16(acc[2 * nd + 1], pa, vf[2], vf[3]);
      }
    }
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
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, Strides sq,
                   Strides sk, Strides sv, Strides so, int b, int h, int tq, int tk,
                   float scale_log2, cudaStream_t stream) {
  const dim3 grid((tq + kRows - 1) / kRows, h, b);
  attention_kernel<T, D><<<grid, Split<D>::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, sv, so, tq, tk, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, Strides sq,
                        Strides sk, Strides sv, Strides so, int b, int h, int tq, int tk,
                        float scale_log2, cudaStream_t stream) {
  constexpr int kSmem = 5 * tc::Tile<D>::kElems * sizeof(__nv_bfloat16);  // Q, 2 x (K, V)
  if (kSmem > 48 * 1024) {  // above the default: opt in, once per device
    static std::atomic<unsigned long long> opted_in{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !((opted_in.load() >> dev) & 1ull)) {
      err = cudaFuncSetAttribute(attention_kernel_bf16<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      if (err != cudaSuccess) return err;
      if (dev < 64) opted_in.fetch_or(1ull << dev);
    }
  }
  const dim3 grid((tq + tc::kRows - 1) / tc::kRows, h, b);
  using bf16 = __nv_bfloat16;
  attention_kernel_bf16<D><<<grid, tc::kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), sq, sk, sv, so, tq, tk, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_dim(int d, const void* q, const void* k, const void* v, void* o,
                           Strides sq, Strides sk, Strides sv, Strides so, int b, int h,
                           int tq, int tk, float scale_log2, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, stream);
    case 32: return launch<T, 32>(q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, stream);
    case 64: return launch<T, 64>(q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, stream);
    case 128: return launch<T, 128>(q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bf16_for_dim(int d, const void* q, const void* k, const void* v, void* o,
                                Strides sq, Strides sk, Strides sv, Strides so, int b, int h,
                                int tq, int tk, float scale_log2, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_bf16<16>(q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, stream);
    case 32: return launch_bf16<32>(q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, stream);
    case 64: return launch_bf16<64>(q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, stream);
    case 128:
      return launch_bf16<128>(q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, (batch, time,
// head) for each of q, k, v, o; the head dim has stride 1.
extern "C" int attention_launch(const void* q, const void* k, const void* v, void* o,
                                int dtype, int b, int h, int tq, int tk, int d,
                                long long qb, long long qt, long long qh,
                                long long kb, long long kt, long long kh,
                                long long vb, long long vt, long long vh,
                                long long ob, long long ot, long long oh,
                                float scale, void* stream) {
  const Strides sq{qb, qt, qh}, sk{kb, kt, kh}, sv{vb, vt, vh}, so{ob, ot, oh};
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);  // log2(e)
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_for_dim<float>(d, q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, s);
  } else if (dtype == 1) {
    err = launch_bf16_for_dim(d, q, k, v, o, sq, sk, sv, so, b, h, tq, tk, scale_log2, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
