// Prefix decode attention for Hopper (sm_90a): one query token per head
// over a static (B, L, KVH, D) bf16 KV cache, reading only the live prefix.
//
// Replaces: rlaifv_tpu/ops/decode_attention.py:_prefix_kernel (launched by
// decode_attention_prefix's pallas_call), the TPU kernel of every decode
// step of generate / generate_repeated.
//
// What bounds it on the H100: HBM bytes. Each cached key and value is used
// once per query head of its group (n_rep multiply-adds per element read),
// far below the ~295 operations per byte at which the tensor cores would
// become the limit, so time tracks the bytes of K and V read.
//
// What the design does about it: it reads only cache columns
// [0, valid_len) - `valid_len` is a host int, the engine's cache_index + 1 -
// so traffic follows the generated length and not max_len, which is the
// point of the TPU kernel's clamped index map. One CTA owns one
// (batch row, kv head) and serves all n_rep query heads of that group, so
// every K/V element is read once. Loads are 16 bytes a lane along D (D/8
// lanes cover one key row); each group of lanes keeps its own fp32 online
// softmax over a strided subset of keys, and the partial states are merged
// by shuffles within a warp and through shared memory across warps. A
// split over the key axis across CTAs (more CTAs in flight at small
// batch) is left for a later change.
//
// Semantics kept: scale 1/sqrt(D); mask (int32, nonzero = attend) over the
// live columns; GQA head h = kv_head * n_rep + r; a row whose live keys are
// all masked outputs exactly 0.
#include <math.h>

#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

template <int D, int REP>
__global__ void __launch_bounds__(NTHREADS)
decode_prefix_kernel(const bf16 *__restrict__ q, const bf16 *__restrict__ k,
                     const bf16 *__restrict__ v, const int *__restrict__ mask,
                     bf16 *__restrict__ out, int KVH, int L, int valid_len,
                     long long qsb, long long qsh, float scale) {
  constexpr int LPK = D / 8;     // lanes per key row (16 bytes each)
  constexpr int KPW = 32 / LPK;  // keys a warp reads per step
  constexpr int NG = NWARPS * KPW;  // key groups per CTA
  __shared__ float s_acc[NWARPS][REP][D];
  __shared__ float s_m[NWARPS][REP];
  __shared__ float s_l[NWARPS][REP];

  const int g = blockIdx.x;  // kv head
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = lane / LPK;  // key slot within the warp
  const int c = lane % LPK;     // 8-wide chunk of D this lane owns

  float qf[REP][8];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    rlaifv::bf16x8_to_float(
        rlaifv::load16(q + b * qsb + (g * REP + r) * qsh + c * 8), qf[r]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[r][i] *= scale;
  }

  float m[REP], l[REP], acc[REP][8];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  }

  const long long row_stride = (long long)KVH * D;
  const bf16 *kb = k + (long long)b * L * row_stride + g * D + c * 8;
  const bf16 *vb = v + (long long)b * L * row_stride + g * D + c * 8;
  const int *mb = mask + (long long)b * L;
  // the loop bound is uniform across a warp so every lane reaches the
  // shuffles; slots past valid_len compute on zeros and are discarded
  for (int t0 = warp * KPW; t0 < valid_len; t0 += NG) {
    const int t = t0 + slot;
    const bool in_range = t < valid_len;
    float kf[8], vf[8];
    uint4 ku = make_uint4(0, 0, 0, 0), vu = make_uint4(0, 0, 0, 0);
    if (in_range) {
      ku = rlaifv::load16(kb + t * row_stride);
      vu = rlaifv::load16(vb + t * row_stride);
    }
    const bool live = in_range && mb[in_range ? t : 0] != 0;
    rlaifv::bf16x8_to_float(ku, kf);
    rlaifv::bf16x8_to_float(vu, vf);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) s = fmaf(qf[r][i], kf[i], s);
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (live) {
        const float m_new = fmaxf(m[r], s);
        const float alpha = expf(m[r] - m_new);  // m[r] = -inf -> 0
        const float p = expf(s - m_new);
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(acc[r][i], alpha, p * vf[i]);
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
      const float a = (m[r] == -INFINITY) ? 0.f : expf(m[r] - m_n);
      const float a_o = (m_o == -INFINITY) ? 0.f : expf(m_o - m_n);
      l[r] = l[r] * a + l_o * a_o;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
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
      for (int i = 0; i < 8; ++i) s_acc[warp][r][c * 8 + i] = acc[r][i];
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
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, s_m[w][r]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const float mw = s_m[w][r];
        const float a = (mw == -INFINITY) ? 0.f : expf(mw - mx);
        num += s_acc[w][r][d] * a;
        den += s_l[w][r] * a;
      }
    }
    out[((long long)b * KVH * REP + g * REP + r) * D + d] =
        __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
}

template <int D, int REP>
cudaError_t launch(const bf16 *q, const bf16 *k, const bf16 *v, const int *mask,
                   bf16 *out, int B, int KVH, int L, int valid_len,
                   long long qsb, long long qsh, float scale,
                   cudaStream_t stream) {
  dim3 grid(KVH, B);
  decode_prefix_kernel<D, REP><<<grid, NTHREADS, 0, stream>>>(
      q, k, v, mask, out, KVH, L, valid_len, qsb, qsh, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_rep(int rep, const bf16 *q, const bf16 *k, const bf16 *v,
                         const int *mask, bf16 *out, int B, int KVH, int L,
                         int valid_len, long long qsb, long long qsh,
                         float scale, cudaStream_t st) {
  switch (rep) {
    case 1:
      return launch<D, 1>(q, k, v, mask, out, B, KVH, L, valid_len, qsb, qsh, scale, st);
    case 2:
      return launch<D, 2>(q, k, v, mask, out, B, KVH, L, valid_len, qsb, qsh, scale, st);
    case 4:
      return launch<D, 4>(q, k, v, mask, out, B, KVH, L, valid_len, qsb, qsh, scale, st);
    case 8:
      return launch<D, 8>(q, k, v, mask, out, B, KVH, L, valid_len, qsb, qsh, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D) bf16 with unit stride along D and element strides qsb, qsh;
// k/v (B, L, KVH, D) bf16 contiguous; mask (B, L) int32 contiguous;
// out (B, H, D) bf16 contiguous. Reads cache columns [0, valid_len) only.
extern "C" int decode_attention_prefix_bf16(const void *q, const void *k,
                                            const void *v, const void *mask,
                                            void *out, int B, int H, int KVH,
                                            int L, int D, int valid_len,
                                            int qsb, int qsh, float scale,
                                            void *stream) {
  if (KVH <= 0 || H % KVH != 0 || valid_len < 1 || valid_len > L)
    return cudaErrorInvalidValue;
  const int rep = H / KVH;
  auto st = static_cast<cudaStream_t>(stream);
  const auto *qp = static_cast<const bf16 *>(q);
  const auto *kp = static_cast<const bf16 *>(k);
  const auto *vp = static_cast<const bf16 *>(v);
  const auto *mp = static_cast<const int *>(mask);
  auto *op = static_cast<bf16 *>(out);
  switch (D) {
    case 64:
      return dispatch_rep<64>(rep, qp, kp, vp, mp, op, B, KVH, L, valid_len, qsb, qsh, scale, st);
    case 128:
      return dispatch_rep<128>(rep, qp, kp, vp, mp, op, B, KVH, L, valid_len, qsb, qsh, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
