// Full-cache decode attention for Hopper (sm_90a): one query token per head
// over the whole static (B, L, KVH, D) cache, fp32 or bf16, with a (B, L)
// key-validity mask into which the caller folds causality.
//
// Replaces: rlaifv_tpu/ops/decode_attention.py:_kernel (launched by
// decode_attention's pallas_call), TPU kernel #6.
//
// What it computes (the plain version is ops/decode_attention.py::
// decode_attention_ref): s = (q . k) * (1/sqrt(D)) in fp32 over EVERY cache
// column, -1e30 where mask == 0; m = max(max s, -5e29); p = exp(s - m);
// out = (p . v) / max(sum p, 1e-30), in q's type. A row whose keys are all
// masked returns 0 (the two clamps), not the uniform average a dense
// softmax gives. Unlike kernel #4 (decode_attention.cu) nothing is clamped
// to a live prefix: every one of the L columns is read.
//
// What bounds it on the H100: bytes. Each cached key and value element is
// read once and used by the n_rep query heads of its group (n_rep fp32
// multiply-adds per element read), far below the operations per byte at
// which even the fp32 units would become the limit.
//
// What the design does about it: one CTA owns one (batch row, kv head) and
// serves all n_rep query heads of that group, so every K/V element is read
// once. Keys stream in tiles of TILE = 8 warps x KPW keys: in a tile each
// warp reads KPW key rows, 16 bytes a lane along D (D / VEC lanes cover one
// row), and each lane group keeps its own fp32 online softmax over its keys;
// the partial states merge by shuffles within a warp and through shared
// memory across warps. The last tile is partial when L is not a multiple of
// TILE: its lanes past L load nothing and skip the update.
//
// The fully masked row: the running max starts at the clamp -5e29 instead
// of -inf, and a masked key is skipped (its exp(-1e30 - m) is an exact fp32
// 0 whenever m >= -5e29, so skipping it is the reference's arithmetic). A row
// with no live key thus ends with l = 0 and acc = 0 in every lane and writes
// 0 / max(0, 1e-30) = 0; no -inf or NaN enters a merge, so the merges need no
// special case. A split of the key axis across CTAs (more CTAs in flight at
// small batch) is left for a later change.
#include <math.h>

#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr float M_FLOOR = -5e29f;  // NEG_INF / 2: the reference's clamp of the max

// VEC elements of T in one 16-byte load, as floats
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float *p, float *f) {
    const float4 u = *reinterpret_cast<const float4 *>(p);
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
  __device__ static float store(float x) { return x; }
};

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void load(const bf16 *p, float *f) {
    rlaifv::bf16x8_to_float(rlaifv::load16(p), f);
  }
  __device__ static bf16 store(float x) { return __float2bfloat16(x); }
};

template <typename T, int D, int REP>
__global__ void __launch_bounds__(NTHREADS)
decode_full_kernel(const T *__restrict__ q, const T *__restrict__ k,
                   const T *__restrict__ v, const int *__restrict__ mask,
                   T *__restrict__ out, int KVH, int L, long long qsb,
                   long long qsh, float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPK = D / VEC;       // lanes per key row (16 bytes each)
  constexpr int KPW = 32 / LPK;      // keys a warp reads per tile
  constexpr int TILE = NWARPS * KPW;  // keys a CTA reads per tile
  __shared__ float s_acc[NWARPS][REP][D];
  __shared__ float s_m[NWARPS][REP];
  __shared__ float s_l[NWARPS][REP];

  const int g = blockIdx.x;  // kv head
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = lane / LPK;  // key slot within the warp
  const int c = lane % LPK;     // VEC-wide chunk of D this lane owns

  float qf[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r)
    Vec<T>::load(q + b * qsb + (g * REP + r) * qsh + c * VEC, qf[r]);

  float m[REP], l[REP], acc[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = M_FLOOR;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
  }

  const long long row_stride = (long long)KVH * D;
  const T *kb = k + (long long)b * L * row_stride + g * D + c * VEC;
  const T *vb = v + (long long)b * L * row_stride + g * D + c * VEC;
  const int *mb = mask + (long long)b * L;
  // the loop bound is uniform across a warp so every lane reaches the
  // shuffles; slots past L compute on zeros and are discarded
  for (int t0 = warp * KPW; t0 < L; t0 += TILE) {
    const int t = t0 + slot;
    const bool in_range = t < L;
    float kf[VEC], vf[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
    if (in_range) {
      Vec<T>::load(kb + t * row_stride, kf);
      Vec<T>::load(vb + t * row_stride, vf);
    }
    const bool live = in_range && mb[in_range ? t : 0] != 0;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) s = fmaf(qf[r][i], kf[i], s);
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      s *= scale;
      if (live) {
        const float m_new = fmaxf(m[r], s);
        const float alpha = expf(m[r] - m_new);
        const float p = expf(s - m_new);
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] = fmaf(acc[r][i], alpha, p * vf[i]);
        m[r] = m_new;
      }
    }
  }

  // merge the key slots of this warp (lanes with the same chunk c)
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float m_n = fmaxf(m[r], m_o);
      const float a = expf(m[r] - m_n), a_o = expf(m_o - m_n);
      l[r] = l[r] * a + l_o * a_o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[r][i], o);
        acc[r][i] = acc[r][i] * a + acc_o * a_o;
      }
      m[r] = m_n;
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) s_acc[warp][r][c * VEC + i] = acc[r][i];
      if (c == 0) {
        s_m[warp][r] = m[r];
        s_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  // merge across warps and write (B, H, D)
  for (int idx = threadIdx.x; idx < REP * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    float mx = M_FLOOR;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, s_m[w][r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float a = expf(s_m[w][r] - mx);
      num += s_acc[w][r][d] * a;
      den += s_l[w][r] * a;
    }
    out[((long long)b * KVH * REP + g * REP + r) * D + d] =
        Vec<T>::store(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D, int REP>
cudaError_t launch(const void *q, const void *k, const void *v, const int *mask,
                   void *out, int B, int KVH, int L, long long qsb,
                   long long qsh, float scale, cudaStream_t stream) {
  dim3 grid(KVH, B);
  decode_full_kernel<T, D, REP><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T *>(q), static_cast<const T *>(k),
      static_cast<const T *>(v), mask, static_cast<T *>(out), KVH, L, qsb, qsh,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_rep(int rep, const void *q, const void *k, const void *v,
                         const int *mask, void *out, int B, int KVH, int L,
                         long long qsb, long long qsh, float scale,
                         cudaStream_t st) {
  switch (rep) {
    case 1:
      return launch<T, D, 1>(q, k, v, mask, out, B, KVH, L, qsb, qsh, scale, st);
    case 2:
      return launch<T, D, 2>(q, k, v, mask, out, B, KVH, L, qsb, qsh, scale, st);
    case 4:
      return launch<T, D, 4>(q, k, v, mask, out, B, KVH, L, qsb, qsh, scale, st);
    case 8:
      return launch<T, D, 8>(q, k, v, mask, out, B, KVH, L, qsb, qsh, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(int D, int rep, const void *q, const void *k,
                       const void *v, const int *mask, void *out, int B,
                       int KVH, int L, long long qsb, long long qsh,
                       float scale, cudaStream_t st) {
  switch (D) {
    case 64:
      return dispatch_rep<T, 64>(rep, q, k, v, mask, out, B, KVH, L, qsb, qsh, scale, st);
    case 128:
      return dispatch_rep<T, 128>(rep, q, k, v, mask, out, B, KVH, L, qsb, qsh, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D) with unit stride along D and element strides qsb, qsh; k/v
// (B, L, KVH, D) contiguous; mask (B, L) int32 contiguous; out (B, H, D)
// contiguous; q, k, v and out all fp32 (is_bf16 == 0) or all bf16 (is_bf16 == 1).
// Reads every cache column [0, L).
extern "C" int decode_attention_full_cuda(const void *q, const void *k,
                                          const void *v, const void *mask,
                                          void *out, int B, int H, int KVH,
                                          int L, int D, int qsb, int qsh,
                                          int is_bf16, float scale, void *stream) {
  if (B < 1 || L < 1 || KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  const int rep = H / KVH;
  auto st = static_cast<cudaStream_t>(stream);
  const auto *mp = static_cast<const int *>(mask);
  if (is_bf16)
    return dispatch_d<bf16>(D, rep, q, k, v, mp, out, B, KVH, L, qsb, qsh, scale, st);
  return dispatch_d<float>(D, rep, q, k, v, mp, out, B, KVH, L, qsb, qsh, scale, st);
}
