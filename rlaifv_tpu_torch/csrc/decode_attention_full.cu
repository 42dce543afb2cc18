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
// What the design does about it: the key axis is split into `splits`
// ranges (ops/decode_attention.py:full_plan: (batch row, kv head, split)
// CTAs for three a streaming multiprocessor in one wave, at least 128 keys a
// split; 8 warps a CTA at n_rep 1-2, 4 at n_rep 4-8, whose registers would
// leave one 8-warp CTA an SM), and one
// CTA owns one (batch row, kv head, split), serving all n_rep query heads of
// that group, so every K/V element is read once. Keys stream in tiles of
// TILE = NWARPS x KPW keys: in a tile each warp reads KPW key rows, 16
// bytes a lane along D (D / VEC lanes cover one row), and each lane group
// keeps its own fp32 online softmax over its keys, in log2 units (one exp2f
// a key and head: 2^-|s - m| is either the new key's p or, at a new
// maximum, the old sums' rescale). Each
// lane keeps the raw k, v and mask of the next PREFETCH tiles in flight in
// registers, issued before the current tile's shuffles and exp2f, so the
// loads never wait on them. The partial states merge by shuffles within a
// warp and through shared memory across warps. With one split the CTA
// writes the output; with several each writes its (m, l, acc) and
// decode_full_merge (launched programmatically: it starts while the splits
// run and waits for them) combines them: M = max m_s, out = (sum acc_s
// e^(m_s - M)) / max(sum l_s e^(m_s - M), 1e-30), splits in order.
//
// The fully masked row: every running max starts at the clamp -5e29
// instead of -inf, and a masked key is skipped (its exp(-1e30 - m) is an
// exact fp32 0 whenever m >= -5e29, so skipping it is the reference's
// arithmetic). A split with no live key thus ends with m = -5e29, l = 0 and
// acc = 0, which adds exactly 0 to the merge (a finite weight times 0), and
// a row with no live key in any split writes 0 / max(0, 1e-30) = 0; no -inf
// or NaN enters a merge, so the merges need no special case.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

// warps a CTA: 8 at n_rep 1-2, 4 at n_rep 4-8 (their registers would
// leave one 8-warp CTA an SM)
constexpr int warps_for(int rep) { return rep <= 2 ? 8 : 4; }
constexpr int PREFETCH = 4;        // tiles of k, v and mask in flight a lane
constexpr float M_FLOOR = -5e29f;  // NEG_INF / 2: the reference's clamp of the max
constexpr float LOG2E = 1.4426950408889634f;

// VEC elements of T in one 16-byte load, as floats
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void cvt(const uint4 &u, float *f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static float store(float x) { return x; }
};

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void cvt(const uint4 &u, float *f) { rlaifv::bf16x8_to_float(u, f); }
  __device__ static bf16 store(float x) { return __float2bfloat16(x); }
};

// part: (B, H, splits, D + 2) fp32, a split's acc over D, then m (log2
// units) and l
template <typename T, int D, int REP, int NWARPS = warps_for(REP)>
__global__ void __launch_bounds__(NWARPS * 32)
decode_full_kernel(const T *__restrict__ q, const T *__restrict__ k,
                   const T *__restrict__ v, const int *__restrict__ mask,
                   T *__restrict__ out, float *__restrict__ part, int KVH, int L,
                   long long qsb, long long qsh, float scale) {
  rlaifv::grid_launch_dependents();  // the merge may launch and wait
  // scores in log2 units (s log2 e), so every exponential is one exp2f
  scale *= LOG2E;
  constexpr int VEC = Vec<T>::N;
  constexpr int LPK = D / VEC;       // lanes per key row (16 bytes each)
  constexpr int KPW = 32 / LPK;      // keys a warp reads per tile
  constexpr int TILE = NWARPS * KPW;  // keys a CTA reads per tile
  __shared__ float s_acc[NWARPS][REP][D];
  __shared__ float s_m[NWARPS][REP];
  __shared__ float s_l[NWARPS][REP];

  const int g = blockIdx.x;  // kv head
  const int b = blockIdx.y;
  const int split = blockIdx.z, splits = gridDim.z;
  const int l0 = static_cast<int>(static_cast<long long>(split) * L / splits);
  const int l1 = static_cast<int>(static_cast<long long>(split + 1) * L / splits);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = lane / LPK;  // key slot within the warp
  const int c = lane % LPK;     // VEC-wide chunk of D this lane owns

  float qf[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r)
    Vec<T>::cvt(*reinterpret_cast<const uint4 *>(q + b * qsb + (g * REP + r) * qsh + c * VEC),
                qf[r]);

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
  // tile i covers keys l0 + i TILE .. ; this warp's slots start at warp KPW.
  // The tile count is uniform across a warp so every lane reaches the
  // shuffles; slots past l1 compute on zeros and are discarded
  const int first = l0 + warp * KPW;
  const int tiles = first < l1 ? (l1 - first + TILE - 1) / TILE : 0;
  // the raw k, v and mask of a slot, read when they are used: a value
  // tested at the load would wait for it there
  uint4 kr[PREFETCH], vr[PREFETCH];
  int mr[PREFETCH];
  auto fetch = [&](int u, int i) {
    const int t = first + i * TILE + slot;
    kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
    mr[u] = 0;
    if (i < tiles && t < l1) {
      kr[u] = *reinterpret_cast<const uint4 *>(kb + t * row_stride);
      vr[u] = *reinterpret_cast<const uint4 *>(vb + t * row_stride);
      mr[u] = mb[t];
    }
  };
#pragma unroll
  for (int u = 0; u < PREFETCH; ++u) fetch(u, u);
  for (int i0 = 0; i0 < tiles; i0 += PREFETCH) {
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      if (i0 + u >= tiles) break;
      float kf[VEC], vf[VEC];
      Vec<T>::cvt(kr[u], kf);
      Vec<T>::cvt(vr[u], vf);
      const bool live = mr[u] != 0;
      fetch(u, i0 + u + PREFETCH);  // in flight while this tile is reduced
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) s = fmaf(qf[r][j], kf[j], s);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        s *= scale;
        if (live) {
          // exp(m - max(m, s)) and exp(s - max(m, s)): one is 1, the
          // other exp(-|s - m|)
          const float e = exp2f(-fabsf(s - m[r]));
          if (s > m[r]) {  // a new maximum: the sums so far rescale, p = 1
            l[r] = l[r] * e + 1.f;
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[r][j] = fmaf(acc[r][j], e, vf[j]);
            m[r] = s;
          } else {
            l[r] += e;
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[r][j] = fmaf(e, vf[j], acc[r][j]);
          }
        }
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
      const float a = exp2f(m[r] - m_n), a_o = exp2f(m_o - m_n);
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

  // merge across warps; write (B, H, D), or this split's state
  for (int idx = threadIdx.x; idx < REP * D; idx += NWARPS * 32) {
    const int r = idx / D, d = idx % D;
    float mx = M_FLOOR;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, s_m[w][r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float a = exp2f(s_m[w][r] - mx);
      num += s_acc[w][r][d] * a;
      den += s_l[w][r] * a;
    }
    const long long h = (long long)b * KVH * REP + g * REP + r;
    if (splits == 1) {
      out[h * D + d] = Vec<T>::store(num / fmaxf(den, 1e-30f));
    } else {
      float *ps = part + (h * splits + split) * (D + 2);
      ps[d] = num;
      if (d == 0) {
        ps[D] = mx;
        ps[D + 1] = den;
      }
    }
  }
}

// one CTA a (row, head), a thread a column of D: the splits' states, in
// split order, rescaled to their common max
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_full_merge(const float *__restrict__ part, T *__restrict__ out, int splits) {
  rlaifv::grid_dependency_wait();  // the splits' states
  const float *p = part + (long long)blockIdx.x * splits * (D + 2);
  const int d = threadIdx.x;
  float mx = M_FLOOR;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, p[s * (D + 2) + D]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float *ps = p + s * (D + 2);
    const float a = exp2f(ps[D] - mx);
    num += ps[d] * a;
    den += ps[D + 1] * a;
  }
  out[(long long)blockIdx.x * D + d] = Vec<T>::store(num / fmaxf(den, 1e-30f));
}

struct Args {
  const void *q, *k, *v;
  const int *mask;
  void *out;
  float *part;
  int B, KVH, L, splits;
  long long qsb, qsh;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int REP>
cudaError_t launch(const Args &a) {
  const dim3 grid(a.KVH, a.B, a.splits);
  decode_full_kernel<T, D, REP><<<grid, warps_for(REP) * 32, 0, a.stream>>>(
      static_cast<const T *>(a.q), static_cast<const T *>(a.k), static_cast<const T *>(a.v),
      a.mask, static_cast<T *>(a.out), a.part, a.KVH, a.L, a.qsb, a.qsh, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  // launched while the splits still run; it waits for them
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.KVH * REP);
  cfg.blockDim = dim3(D);
  cfg.stream = a.stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_full_merge<T, D>, static_cast<const float *>(a.part),
                            static_cast<T *>(a.out), a.splits);
}

template <typename T, int D>
cudaError_t dispatch_rep(int rep, const Args &a) {
  switch (rep) {
    case 1:
      return launch<T, D, 1>(a);
    case 2:
      return launch<T, D, 2>(a);
    case 4:
      return launch<T, D, 4>(a);
    case 8:
      return launch<T, D, 8>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(int D, int rep, const Args &a) {
  switch (D) {
    case 64:
      return dispatch_rep<T, 64>(rep, a);
    case 128:
      return dispatch_rep<T, 128>(rep, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D) with unit stride along D and element strides qsb, qsh; k/v
// (B, L, KVH, D) contiguous; mask (B, L) int32 contiguous; out (B, H, D)
// contiguous; q, k, v and out all fp32 (is_bf16 == 0) or all bf16 (is_bf16 ==
// 1). Reads every cache column [0, L), in `splits` ranges (1 to L): with
// more than one, part is (B, H, splits, D + 2) fp32 scratch and a second
// launch merges the splits.
extern "C" int decode_attention_full_cuda(const void *q, const void *k, const void *v,
                                          const void *mask, void *out, void *part, int B,
                                          int H, int KVH, int L, int D, int qsb, int qsh,
                                          int is_bf16, int splits, float scale,
                                          void *stream) {
  if (B < 1 || L < 1 || KVH <= 0 || H % KVH != 0 || splits < 1 || splits > L ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int *>(mask), out, static_cast<float *>(part),
               B, KVH, L, splits, qsb, qsh, scale, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? dispatch_d<bf16>(D, H / KVH, a) : dispatch_d<float>(D, H / KVH, a);
}
