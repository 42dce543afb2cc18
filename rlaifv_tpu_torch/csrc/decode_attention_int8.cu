// Prefix decode attention over an int8 KV cache for Hopper (sm_90a): one
// query token per head over a static (B, L, KVH, D) int8 cache with fp32
// (B, L, KVH) per-(token, head) scales, reading only the live key blocks.
//
// Replaces: rlaifv_tpu/ops/decode_attention.py:_prefix_kernel_int8 (launched
// by decode_attention_prefix_int8's pallas_call), the TPU kernel of every
// decode step of a model with kv_cache_dtype "int8".
//
// What it computes (the TPU kernel's function, block for block): q is
// quantised per head row (sq = max(max|q|, 1e-20) / 127, q8 = round half
// to even of q / sq, clipped to +-127). The keys are walked in blocks of
// block_l (256 when it divides L, else 128) up to ceil(valid_len /
// block_l); per block, s = int(q8 . k8) * sq * ks * (1/sqrt(D)) plus -1e30
// where the mask is 0, then the online softmax with the running max
// floored at -5e29, the v scale folded into the probabilities (pv = p *
// vs), pv quantised per row OF THE BLOCK (sp = max(max|pv|, 1e-20) / 127),
// and acc = acc * corr + int(p8 . v8) * sp. Out = acc / max(l, 1e-30), so
// a row with no live key outputs 0. The per-block quantisation of p makes
// block_l part of the function: the wrapper passes the JAX rule's value.
//
// What bounds it on the H100: HBM bytes. Each int8 key and value is used
// once per query head of its group (n_rep int8 multiply-adds per byte),
// far below the ~590 int8 operations per byte at which the tensor cores
// would become the limit; the int8 cache halves the bytes of the bf16
// cache read by decode_attention.cu.
//
// What the design does about it: one CTA owns one (batch row, kv head) and
// serves all n_rep query heads, so every cache byte is read once, and only
// the live blocks are read. Per block: (1) scores, D/16 lanes per key row
// with one 16-byte load each, __dp4a on packed q8/k8 words and a shuffle
// sum, into shared memory; (2) one warp per query head reduces the block
// max, exponentiates, sums, folds vs, reduces max|pv| and writes p8 to
// shared memory; (3) P8.V8 with one 4-byte word of a value row a lane
// (rows read coalesced along D), exact int32 partial sums merged with
// shared-memory atomics (integer sums are exact in any order); (4) the fp32
// accumulator update. The multiplies and adds of the fp32 epilogues are
// written with __fmul_rn / __fadd_rn so that no FMA contraction departs
// from the plain twin's rounding. wgmma, TMA and a split of the key axis
// over CTAs (more CTAs at small batch) are left for later changes.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_BLOCK_L = 256;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ int quant127(float x) {
  return static_cast<int>(fminf(fmaxf(rintf(x), -127.f), 127.f));
}

template <int D, int REP>
__global__ void __launch_bounds__(NTHREADS)
prefix_int8_kernel(const bf16 *__restrict__ q, const int8_t *__restrict__ k,
                   const float *__restrict__ ks, const int8_t *__restrict__ v,
                   const float *__restrict__ vs, const int *__restrict__ mask,
                   bf16 *__restrict__ out, int KVH, int L, int n_blocks,
                   int block_l, long long qsb, long long qsh, float scale) {
  constexpr int LPK = D / 16;  // lanes per key row in the score stage
  constexpr int KPW = 32 / LPK;  // key rows a warp scores per step
  constexpr int LPV = D / 4;  // lanes per value row in the P.V stage
  constexpr int VPW = 32 / LPV;  // value rows a warp reads per step
  constexpr int QPL = D / 32;  // q values a lane quantises

  __shared__ __align__(16) int8_t s_q8[REP][D];
  __shared__ float s_sq[REP];
  __shared__ float s_s[REP][MAX_BLOCK_L];
  __shared__ int8_t s_p8[REP][MAX_BLOCK_L];
  __shared__ float s_corr[REP], s_sp[REP], s_l[REP];
  __shared__ int s_iacc[REP][D];
  __shared__ float s_acc[REP][D];

  const int g = blockIdx.x;  // kv head
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // quantise q: warp r owns query head g * REP + r
  if (warp < REP) {
    const bf16 *qr = q + b * qsb + (long long)(g * REP + warp) * qsh + lane * QPL;
    float x[QPL];
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < QPL; ++i) {
      x[i] = __bfloat162float(qr[i]);
      a = fmaxf(a, fabsf(x[i]));
    }
    const float sq = fmaxf(warp_max(a), 1e-20f) / 127.0f;
#pragma unroll
    for (int i = 0; i < QPL; ++i) s_q8[warp][lane * QPL + i] = (int8_t)quant127(x[i] / sq);
    if (lane == 0) s_sq[warp] = sq;
  }
  for (int i = threadIdx.x; i < REP * D; i += NTHREADS) (&s_acc[0][0])[i] = 0.f;
  // the online-softmax state of head r lives in warp r (every lane alike)
  float m = NEG_INF, l = 0.f;
  __syncthreads();

  const int slot = lane / LPK, c = lane % LPK;  // score stage: key slot, 16-byte chunk
  int qw[REP][4];
  float sq[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const int *w = reinterpret_cast<const int *>(&s_q8[r][0]) + c * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) qw[r][i] = w[i];
    sq[r] = s_sq[r];
  }
  const int vslot = lane / LPV, vc = lane % LPV;  // P.V stage: row slot, 4-byte word

  const long long row = (long long)KVH * D;  // bytes between key rows
  const int8_t *kb = k + (long long)b * L * row + g * D;
  const int8_t *vb = v + (long long)b * L * row + g * D;
  const float *ksb = ks + (long long)b * L * KVH + g;
  const float *vsb = vs + (long long)b * L * KVH + g;
  const int *mb = mask + (long long)b * L;

  for (int j = 0; j < n_blocks; ++j) {
    const int t0 = j * block_l;
    // (1) scores; block_l is a multiple of NWARPS * KPW, so every slot is
    // in range and every lane reaches the shuffles
    for (int tl = warp * KPW + slot; tl < block_l; tl += NWARPS * KPW) {
      const int t = t0 + tl;
      const uint4 kv = *reinterpret_cast<const uint4 *>(kb + t * row + c * 16);
      const int kw[4] = {(int)kv.x, (int)kv.y, (int)kv.z, (int)kv.w};
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        int dot = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) dot = __dp4a(qw[r][i], kw[i], dot);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
        if (c == 0) {
          float s = __fmul_rn(__fmul_rn(__fmul_rn((float)dot, sq[r]), ksb[t * KVH]), scale);
          s_s[r][tl] = __fadd_rn(s, mb[t] != 0 ? 0.f : NEG_INF);
        }
      }
    }
    __syncthreads();
    // every thread has passed the previous block's (4), which read s_iacc
    for (int i = threadIdx.x; i < REP * D; i += NTHREADS) (&s_iacc[0][0])[i] = 0;

    // (2) softmax statistics and p8 of head `warp`
    if (warp < REP) {
      const int r = warp;
      float bmax = -INFINITY;
      for (int tl = lane; tl < block_l; tl += 32) bmax = fmaxf(bmax, s_s[r][tl]);
      const float m_new = fmaxf(m, fmaxf(warp_max(bmax), NEG_INF / 2));
      float pv[MAX_BLOCK_L / 32];
      float psum = 0.f, pmax = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_BLOCK_L / 32; ++i) {
        const int tl = lane + 32 * i;
        pv[i] = 0.f;
        if (tl < block_l) {
          const float p = expf(__fsub_rn(s_s[r][tl], m_new));
          psum += p;
          pv[i] = __fmul_rn(p, vsb[(t0 + tl) * KVH]);
          pmax = fmaxf(pmax, fabsf(pv[i]));
        }
      }
      psum = warp_sum(psum);
      const float sp = fmaxf(warp_max(pmax), 1e-20f) / 127.0f;
#pragma unroll
      for (int i = 0; i < MAX_BLOCK_L / 32; ++i) {
        const int tl = lane + 32 * i;
        if (tl < block_l) s_p8[r][tl] = (int8_t)quant127(pv[i] / sp);
      }
      const float corr = expf(__fsub_rn(m, m_new));
      l = __fadd_rn(__fmul_rn(l, corr), psum);
      m = m_new;
      if (lane == 0) {
        s_corr[r] = corr;
        s_sp[r] = sp;
      }
    }
    __syncthreads();

    // (3) exact int32 P8.V8 over the block
    int ia[REP][4];
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) ia[r][i] = 0;
    for (int tl = warp * VPW + vslot; tl < block_l; tl += NWARPS * VPW) {
      const int word = *reinterpret_cast<const int *>(vb + (long long)(t0 + tl) * row + vc * 4);
      int vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) vv[i] = (int)(int8_t)(word >> (8 * i));
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const int p = s_p8[r][tl];
#pragma unroll
        for (int i = 0; i < 4; ++i) ia[r][i] += p * vv[i];
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) atomicAdd(&s_iacc[r][vc * 4 + i], ia[r][i]);
    __syncthreads();

    // (4) acc = acc * corr + int(p8 . v8) * sp
    for (int i = threadIdx.x; i < REP * D; i += NTHREADS) {
      const int r = i / D;
      float *a = &s_acc[0][0] + i;
      *a = __fadd_rn(__fmul_rn(*a, s_corr[r]),
                     __fmul_rn((float)(&s_iacc[0][0])[i], s_sp[r]));
    }
    // the next block's (1) writes only s_s, which (4) does not read; s_iacc,
    // s_corr and s_sp are rewritten after the barrier that follows (1)
  }

  if (warp < REP && lane == 0) s_l[warp] = l;
  __syncthreads();
  for (int i = threadIdx.x; i < REP * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    out[((long long)b * KVH * REP + g * REP + r) * D + d] =
        __float2bfloat16(s_acc[r][d] / fmaxf(s_l[r], 1e-30f));
  }
}

template <int D, int REP>
cudaError_t launch(const bf16 *q, const int8_t *k, const float *ks, const int8_t *v,
                   const float *vs, const int *mask, bf16 *out, int B, int KVH, int L,
                   int n_blocks, int block_l, long long qsb, long long qsh, float scale,
                   cudaStream_t stream) {
  dim3 grid(KVH, B);
  prefix_int8_kernel<D, REP><<<grid, NTHREADS, 0, stream>>>(
      q, k, ks, v, vs, mask, out, KVH, L, n_blocks, block_l, qsb, qsh, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_rep(int rep, const bf16 *q, const int8_t *k, const float *ks,
                         const int8_t *v, const float *vs, const int *mask, bf16 *out,
                         int B, int KVH, int L, int n_blocks, int block_l,
                         long long qsb, long long qsh, float scale, cudaStream_t st) {
  switch (rep) {
    case 1:
      return launch<D, 1>(q, k, ks, v, vs, mask, out, B, KVH, L, n_blocks, block_l, qsb, qsh, scale, st);
    case 2:
      return launch<D, 2>(q, k, ks, v, vs, mask, out, B, KVH, L, n_blocks, block_l, qsb, qsh, scale, st);
    case 4:
      return launch<D, 4>(q, k, ks, v, vs, mask, out, B, KVH, L, n_blocks, block_l, qsb, qsh, scale, st);
    case 8:
      return launch<D, 8>(q, k, ks, v, vs, mask, out, B, KVH, L, n_blocks, block_l, qsb, qsh, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D) bf16 with unit stride along D and element strides qsb, qsh;
// k/v (B, L, KVH, D) int8 contiguous; ks/vs (B, L, KVH) fp32 contiguous;
// mask (B, L) int32 contiguous; out (B, H, D) bf16 contiguous. block_l 128
// or 256, dividing L; reads key blocks [0, max(ceil(valid_len / block_l), 1)).
extern "C" int decode_attention_prefix_int8_bf16(
    const void *q, const void *k, const void *ks, const void *v, const void *vs,
    const void *mask, void *out, int B, int H, int KVH, int L, int D, int valid_len,
    int block_l, int qsb, int qsh, float scale, void *stream) {
  if (KVH <= 0 || H % KVH != 0 || valid_len < 1 || valid_len > L ||
      (block_l != 128 && block_l != 256) || L % block_l != 0)
    return cudaErrorInvalidValue;
  const int n_blocks = (valid_len + block_l - 1) / block_l;
  const int rep = H / KVH;
  auto st = static_cast<cudaStream_t>(stream);
  const auto *qp = static_cast<const bf16 *>(q);
  const auto *kp = static_cast<const int8_t *>(k);
  const auto *vp = static_cast<const int8_t *>(v);
  const auto *ksp = static_cast<const float *>(ks);
  const auto *vsp = static_cast<const float *>(vs);
  const auto *mp = static_cast<const int *>(mask);
  auto *op = static_cast<bf16 *>(out);
  switch (D) {
    case 64:
      return dispatch_rep<64>(rep, qp, kp, ksp, vp, vsp, mp, op, B, KVH, L, n_blocks,
                              block_l, qsb, qsh, scale, st);
    case 128:
      return dispatch_rep<128>(rep, qp, kp, ksp, vp, vsp, mp, op, B, KVH, L, n_blocks,
                               block_l, qsb, qsh, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
