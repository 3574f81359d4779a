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
// type.  Both layouts launch this one kernel with their own element strides
// of the batch, time and head axes; the head dim must have stride 1.
//
// What bounds it: at ART's shape (T = 1024, H = 8, d = 16) the scores are
// 2 * B * H * T^2 * d FLOP and so is PV, about 17 GFLOP at B = 32, done on
// the CUDA cores in f32 (no tensor cores in this first version), while the
// bytes are only Q, K, V and O (8 MB at B = 32, f32).  So it is bound by its
// FMA and shared-memory load stream, not by device memory.
//
// Design.  The TPU kernel keeps a whole (128, Tk) f32 score tile in VMEM:
// 512 KB at Tk = 1024, more than twice the 227 KB of shared memory a Hopper
// block may use.  Here nothing of size Tk is kept: a block owns 64 query
// rows of one (b, h) and walks the keys in tiles of 32, staging each K and V
// tile in shared memory as f32, and runs an online softmax over the tiles
// (a running max and sum; the accumulated output is rescaled when the max
// grows).  So any Tk works, the shared memory per block is 5 KB at d = 16
// and 36 KB at d = 128, and many blocks share an SM.  The two-pass softmax
// of the TPU kernel would need the score rows of the block in shared memory
// (64 x 2048 x 4 B = 512 KB), or a second pass over K.
//
// Each thread owns one query row, or a 32-wide slice of it when d > 32: at
// d = 128 a whole row would take q (128), the output sums (128) and the tile's
// 32 scores in registers, over the 255 a thread may have.  The d / 32 threads
// of a row are neighbours in one warp and add their partial dot products
// with shuffles.  K and V rows in shared memory keep each 32-wide slice 4
// floats apart from the next, so the slices a warp reads at once fall in
// different banks; all threads of one slice read the same address (a
// broadcast), 16 bytes at a time.
//
// The exponentials are base 2 with log2(e) folded into the scale, so
// softmax in f32 differs from exp(s - max) only in the last bits.  With bf16
// operands each probability is rounded before the PV product as the plain
// version rounds it, but unnormalised (divided by the row sum at the end),
// so the two roundings differ by at most one bf16 rounding per probability.
// Ragged edges: key rows past Tk are staged as zeros and get a score of
// -inf; query rows past Tq compute on zeros and are not written.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a head dim or type
// it has no instance for) so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// A probability rounded to the operand type (round to nearest even).
__device__ __forceinline__ float as_operand(float x, const float*) { return x; }
__device__ __forceinline__ float as_operand(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

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
    err = launch_for_dim<__nv_bfloat16>(d, q, k, v, o, sq, sk, sv, so, b, h, tq, tk,
                                        scale_log2, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
