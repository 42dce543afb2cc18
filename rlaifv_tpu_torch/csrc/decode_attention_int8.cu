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
// The key axis is split over CTAs on block boundaries
// (ops/decode_attention.py:prefix_int8_plan); each split runs the block
// recurrence over its own blocks from its own running max, and a merge
// combines the splits' (m, l, acc): M = max m_s, out = (sum acc_s e^(m_s -
// M)) / max(sum l_s e^(m_s - M), 1e-30), splits in order. A split changes
// the max under which its first blocks quantise p, so the split kernel
// equals `decode_attention_prefix_int8_split_ref` (the twin as the card
// splits it), which at one split is `decode_attention_prefix_int8_ref`.
//
// What bounds it on the H100: HBM bytes. Each int8 key and value is used
// once per query head of its group (n_rep int8 multiply-adds per byte),
// far below the ~590 int8 operations per byte at which the tensor cores
// would become the limit; the int8 cache halves the bytes of the bf16
// cache read by decode_attention.cu.
//
// What the design does about it:
// - CTAs that fill the card: one CTA owns one (batch row, kv head, split)
//   and serves all n_rep query heads, so every cache byte is read once;
//   the splits bring B x KVH up to one wave of two CTAs an SM (Llama3's
//   GQA step, B 8 x KVH 8, 64 CTAs on 132 SMs, takes 4 splits), and batch
//   24 (768 CTAs) takes one.
// - The cache streamed ahead: the CTA's k and v tiles of each block (block_l
//   rows of D bytes, the head's rows KVH D bytes apart: one box of a rank-3
//   tensor map over (D, KVH, B L)) go by TMA through a ring of swizzled
//   shared-memory slots in the order they are used (k_j, v_j, k_j+1, ...),
//   3-8 slots (~105 KB), each refilled as soon as it is consumed and before
//   the next tile is awaited, so HBM keeps streaming while the softmax and
//   the P.V product of earlier tiles run; the k slot also carries the
//   block's k and v scales and mask (cp.async, staged once, read from
//   shared memory).
// - Every warp busy, both products on the tensor cores (mma.sync m16n8k32
//   s8): the scores as S^T = k8 . q8^T (keys the 16-row side, read as they
//   lie from the 128- or 64-byte-swizzled slot; the n_rep heads padded to
//   the 8-wide side, their fragments in registers), each warp 16-32 keys;
//   then one warp a real head (the scores parked in the k rows their warp
//   has read) takes the block's max, the exponentials, the sums and the
//   IEEE divisions of p8 by shuffles alone, so n_rep 1 does an eighth of
//   the padded heads' work and the softmax needs one barrier; P.V as
//   out^T = v8^T . p8^T, v8^T built in registers
//   from the natural tile by 4 x 4 byte transposes (as quant_matmul.cu's
//   qfwd), each warp 32 columns of D and a part of the block's keys, the
//   parts' exact int32 sums added through shared memory.
// The fp32 epilogues are written with __fmul_rn / __fadd_rn / __fdiv_rn so
// that no FMA contraction departs from the plain twin's rounding.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "int8_mma.cuh"

using bf16 = __nv_bfloat16;

namespace {

using namespace rlaifv;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int HP = 8;  // heads a product holds: n_rep (1-8) padded to the mma's 8
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -5e29f;  // NEG_INF / 2: the twin's floor of the running max
constexpr unsigned FULL = 0xffffffffu;
constexpr int RING_BYTES = 107520;  // the slots of one CTA: two CTAs an SM

template <int D, int BL>
struct Geo {
  static constexpr int DATA = BL * D;  // a tile's int8 rows
  // + a k tile's ks, vs and mask; slots 1024-byte aligned (the swizzle's atom)
  static constexpr int SLOT = (DATA + 12 * BL + 1023) / 1024 * 1024;
  static constexpr int STAGES = RING_BYTES / SLOT < 8 ? RING_BYTES / SLOT : 8;
  static constexpr int RING = STAGES * SLOT + 1024;  // + the alignment slack
  static constexpr int P_PITCH = BL + 16;      // p8 rows: 8 rows on 32 banks
  static constexpr int WD = D / 32;            // P.V: warps along D
  static constexpr int KP = NWARPS / WD;       // ... and parts of the keys
  static constexpr int KT = BL / 16 / NWARPS;  // scores: key tiles a warp
  static_assert(BL == 128 || BL == 256, "block_l 128 or 256");
  static_assert(D == 64 || D == 128, "D 64 or 128");
  static_assert(STAGES >= 3, "three slots at least");
  static_assert((KP - 1) * WD * 32 * 8 * 4 <= DATA, "P.V parts fit a slot");
};

// byte offset of row r's 16-byte chunk c in a slot, as TMA's 128-byte
// (D 128) and 64-byte (D 64) swizzles lay it: 128-byte rows with chunk c at
// c ^ (r % 8), 64-byte rows with chunk c at c ^ ((r / 2) % 4); the 8 rows of
// an mma fragment load land on distinct banks
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return D == 128 ? r * 128 + ((c ^ (r & 7)) << 4) : r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async4(void *smem, const void *gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ float quant127(float x) {
  return fminf(fmaxf(rintf(x), -127.f), 127.f);
}

// the max and the sum over a warp
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// a k slot's score of (key, head h) once its rows are read: float h of row
// key at position (h + key / (128 / D)) % (D / 4), so that 32 consecutive
// keys of one head fall on 32 banks
template <int D>
__device__ __forceinline__ float &score_at(unsigned char *slot, int key, int h) {
  return *reinterpret_cast<float *>(slot + key * D + 4 * ((h + key / (128 / D)) % (D / 4)));
}

// part: (B, H, splits, D + 2) fp32, a split's acc over D, then m and l
template <int D, int BL>
__global__ void __launch_bounds__(NTHREADS, 2)
prefix_int8_split(const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const bf16 *__restrict__ q,
                  const float *__restrict__ ks, const float *__restrict__ vs,
                  const int *__restrict__ mask, bf16 *__restrict__ out,
                  float *__restrict__ part, int REP, int KVH, int L, int n_blocks,
                  long long qsb, long long qsh, float scale) {
  using G = Geo<D, BL>;
  extern __shared__ __align__(1024) unsigned char smem_kv8[];
  unsigned char *ring = smem_kv8 + ((1024 - saddr(smem_kv8) % 1024) % 1024);
  __shared__ __align__(8) uint64_t s_full[G::STAGES];  // a slot's k or v rows have landed
  __shared__ __align__(16) int8_t s_p8[HP][G::P_PITCH];
  __shared__ __align__(16) int8_t s_q8[HP][D];
  __shared__ float s_sq[HP];
  // the softmax state of each head (its warp's lane 0 writes it): running
  // max and sum, the last block's rescale and p scale
  __shared__ float s_m[HP], s_l[HP], s_corr[HP], s_sp[HP];

  grid_launch_dependents();  // the merge may launch now and wait
  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int j0 = split * n_blocks / splits, j1 = (split + 1) * n_blocks / splits;
  const int T = 2 * (j1 - j0);  // tiles: k then v of each block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, t = lane % 4;
  if (threadIdx.x == 0) {
    for (int st = 0; st < G::STAGES; ++st) bar_init(saddr(&s_full[st]), 1);
    bar_init_fence();
  }
  __syncthreads();

  // tile i (k of block j0 + i / 2 for even i, its v for odd i) into slot i %
  // STAGES: its rows by TMA (thread 0), a k tile's scales and mask by
  // cp.async; past the last tile an empty group keeps the group count
  auto load = [&](int i) {
    if (i < T) {
      unsigned char *dst = ring + (i % G::STAGES) * G::SLOT;
      const int p = b * L + (j0 + i / 2) * BL;
      if (threadIdx.x == 0) {
        const uint32_t bar = saddr(&s_full[i % G::STAGES]);
        bar_expect(bar, G::DATA);
        tma_load_3d(saddr(dst), (i & 1) ? &map_v : &map_k, 0, g, p, bar);
      }
      if (!(i & 1)) {
        float *sc = reinterpret_cast<float *>(dst + G::DATA);
        for (int r = threadIdx.x; r < BL; r += NTHREADS) {
          cp_async4(sc + r, ks + (static_cast<long long>(p) + r) * KVH + g);
          cp_async4(sc + BL + r, vs + (static_cast<long long>(p) + r) * KVH + g);
        }
        for (int c = threadIdx.x; c < BL / 4; c += NTHREADS)
          cp_async16(dst + G::DATA + 8 * BL + 16 * c, mask + p + 4 * c);
      }
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int i = 0; i < G::STAGES - 1; ++i) load(i);

  // quantise q: warp r owns query head g REP + r (rows past REP: zeros)
  {
    constexpr int QPL = D / 32;
    const int r = warp;
    float x[QPL], a = 0.f;
    const bf16 *qr = q + b * qsb + static_cast<long long>(g * REP + r) * qsh + lane * QPL;
#pragma unroll
    for (int i = 0; i < QPL; ++i) {
      x[i] = r < REP ? __bfloat162float(qr[i]) : 0.f;
      a = fmaxf(a, fabsf(x[i]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(FULL, a, o));
    const float sq = r < REP ? __fdiv_rn(fmaxf(a, 1e-20f), 127.0f) : 1.f;
#pragma unroll
    for (int i = 0; i < QPL; ++i)
      s_q8[r][lane * QPL + i] = static_cast<int8_t>(quant127(__fdiv_rn(x[i], sq)));
    if (lane == 0) {
      s_sq[r] = sq;
      s_m[r] = NEG_INF;
      s_l[r] = 0.f;
    }
  }
  __syncthreads();
  // the scores' B fragments (q8^T: head gq, D bytes 32 kk + 4 t and + 16)
  // and this thread's heads 2 t, 2 t + 1: their scales and softmax state
  uint32_t qb[D / 32][2];
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    qb[kk][0] = ld32(&s_q8[gq][32 * kk + 4 * t]);
    qb[kk][1] = ld32(&s_q8[gq][32 * kk + 16 + 4 * t]);
  }
  const float sqh[2] = {s_sq[2 * t], s_sq[2 * t + 1]};

  // P.V: this warp's columns of D and part of the keys
  const int wd = warp % G::WD, kpart = warp / G::WD;
  const int qcol = 32 * wd + 4 * gq, qchunk = qcol >> 4, qbyte = qcol & 15;
  // rows of a load permuted by lane so that one load instruction hits no
  // bank twice (lane groups t and t + 2 would share swizzle phases)
  const int rot = (D == 128 ? 2 : 1) * (t >> 1);
  // acc[u][e]: column qcol + 2 u + (e >> 1) of head 2 t + (e & 1)
  float acc[2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;

#pragma unroll 1
  for (int i = 0; i < T; ++i) {
    if (i > 0) {
      fence_async_smem();  // this thread's generic accesses to tile i - 1's slot precede
      __syncthreads();     // ... the TMA that refills it: the slot is free
    }
    load(i + G::STAGES - 1);         // ... and refilled before tile i is awaited
    cp_async_wait<G::STAGES - 1>();  // tile i's scales and mask have landed
    bar_wait(saddr(&s_full[i % G::STAGES]), (i / G::STAGES) & 1);  // ... and its rows
    __syncthreads();                 // ... for every thread
    unsigned char *slot = ring + (i % G::STAGES) * G::SLOT;
    if (!(i & 1)) {
      // ---- the block's scores, softmax statistics and p8
      const float *sks = reinterpret_cast<const float *>(slot + G::DATA);
      const float *svs = sks + BL;
      const int *smask = reinterpret_cast<const int *>(sks + 2 * BL);
      // c[x][e]: key 16 kt + gq + 8 (e >> 1), head 2 t + (e & 1)
      float s[G::KT][4];
#pragma unroll
      for (int x = 0; x < G::KT; ++x) {
        const int kt = warp + NWARPS * x, r0 = 16 * kt + gq;
        int c[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk) {
          const uint32_t a[4] = {ld32(reinterpret_cast<int8_t *>(slot) + swz<D>(r0, 2 * kk) + 4 * t),
                                 ld32(reinterpret_cast<int8_t *>(slot) + swz<D>(r0 + 8, 2 * kk) + 4 * t),
                                 ld32(reinterpret_cast<int8_t *>(slot) + swz<D>(r0, 2 * kk + 1) + 4 * t),
                                 ld32(reinterpret_cast<int8_t *>(slot) + swz<D>(r0 + 8, 2 * kk + 1) + 4 * t)};
          mma_s8(c, a, qb[kk]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = r0 + 8 * (e >> 1);
          const float sc = __fmul_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(c[e]), sqh[e & 1]), sks[key]), scale);
          s[x][e] = __fadd_rn(sc, smask[key] != 0 ? 0.f : NEG_INF);
        }
      }
      // the scores of the REP real heads into the rows of this warp's own
      // keys (read by this warp alone, and done with)
      __syncwarp();
#pragma unroll
      for (int x = 0; x < G::KT; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = 2 * t + (e & 1);
          if (h < REP) score_at<D>(slot, 16 * (warp + NWARPS * x) + gq + 8 * (e >> 1), h) = s[x][e];
        }
      __syncthreads();
      // warp h owns real head h over the block's keys (lane + 32 u): the
      // max, p, pv, their sum and max |pv| by shuffles, p8, and the head's
      // state for the P.V stage
      if (warp < REP) {
        const int h = warp;
        constexpr int U = BL / 32;
        float sv[U], pv[U], bmax = -INFINITY;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          sv[u] = score_at<D>(slot, lane + 32 * u, h);
          bmax = fmaxf(bmax, sv[u]);
        }
        const float m_old = s_m[h];
        const float m_new = fmaxf(m_old, fmaxf(warp_max(bmax), M_FLOOR));
        float psum = 0.f, pmax = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = expf(__fsub_rn(sv[u], m_new));
          psum = __fadd_rn(psum, p);
          pv[u] = __fmul_rn(p, svs[lane + 32 * u]);
          pmax = fmaxf(pmax, fabsf(pv[u]));
        }
        psum = warp_sum(psum);
        const float sp = __fdiv_rn(fmaxf(warp_max(pmax), 1e-20f), 127.0f);
#pragma unroll
        for (int u = 0; u < U; ++u)
          s_p8[h][lane + 32 * u] = static_cast<int8_t>(quant127(__fdiv_rn(pv[u], sp)));
        if (lane == 0) {
          const float corr = expf(__fsub_rn(m_old, m_new));
          s_l[h] = __fadd_rn(__fmul_rn(s_l[h], corr), psum);
          s_m[h] = m_new;
          s_corr[h] = corr;
          s_sp[h] = sp;
        }
      }
      // the next iteration's barrier publishes p8 and the state to the P.V
      // stage
    } else {
      // ---- exact int32 P8 . V8 over the block: this warp's columns, its
      // part of the keys
      constexpr int STEPS = BL / 32 / G::KP;
      int c[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
      for (int kk = 0; kk < STEPS; ++kk) {
        const int k32 = 32 * (kpart * STEPS + kk);
        uint32_t a[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t w0[4], w[4], o[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const int kr = k32 + 16 * h + 4 * t + (ii ^ rot);
            w0[ii] = ld32(reinterpret_cast<int8_t *>(slot) + swz<D>(kr, qchunk) + qbyte);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) w[r] = w0[r ^ rot];
          transpose4x4(w, o);  // o[j] byte r: v8[key k32 + 16 h + 4 t + r][column qcol + j]
          a[0][2 * h] = o[0];
          a[0][2 * h + 1] = o[1];
          a[1][2 * h] = o[2];
          a[1][2 * h + 1] = o[3];
        }
        const uint32_t pb[2] = {ld32(&s_p8[gq][k32 + 4 * t]), ld32(&s_p8[gq][k32 + 16 + 4 * t])};
        mma_s8(c[0], a[0], pb);
        mma_s8(c[1], a[1], pb);
      }
      // the parts' sums into part 0's, through the slot (read by all above)
      int *red_pv = reinterpret_cast<int *>(slot);
      __syncthreads();
      if (kpart > 0) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red_pv[(((kpart - 1) * G::WD + wd) * 32 + lane) * 8 + 4 * u + e] = c[u][e];
      }
      __syncthreads();
      if (kpart == 0) {
#pragma unroll
        for (int pp = 0; pp < G::KP - 1; ++pp)
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              c[u][e] += red_pv[((pp * G::WD + wd) * 32 + lane) * 8 + 4 * u + e];
        // acc = acc * corr + int(p8 . v8) * sp
        const float corr[2] = {s_corr[2 * t], s_corr[2 * t + 1]};
        const float sp[2] = {s_sp[2 * t], s_sp[2 * t + 1]};
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[u][e] = __fadd_rn(__fmul_rn(acc[u][e], corr[e & 1]),
                                  __fmul_rn(__int2float_rn(c[u][e]), sp[e & 1]));
      }
    }
  }
  cp_async_wait<0>();

  if (kpart != 0) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 2 * t + hh;
    if (r >= REP) continue;
    const long long h = static_cast<long long>(b) * KVH * REP + g * REP + r;
    // columns qcol .. qcol + 3 of head r
    const float f[4] = {acc[0][hh], acc[0][2 + hh], acc[1][hh], acc[1][2 + hh]};
    if (splits == 1) {
      const float den = fmaxf(s_l[r], 1e-30f);
      *reinterpret_cast<uint2 *>(out + h * D + qcol) =
          make_uint2(pack_bf16(__fdiv_rn(f[0], den), __fdiv_rn(f[1], den)),
                     pack_bf16(__fdiv_rn(f[2], den), __fdiv_rn(f[3], den)));
    } else {
      float *ps = part + (h * splits + split) * (D + 2);
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[qcol + j] = f[j];
      if (qcol == 0) {
        ps[D] = s_m[r];
        ps[D + 1] = s_l[r];
      }
    }
  }
}

// one CTA a (row, head), a thread a column of D: the splits' states, in
// split order, rescaled to their common max
template <int D>
__global__ void __launch_bounds__(D)
prefix_int8_merge(const float *__restrict__ part, bf16 *__restrict__ out, int splits) {
  grid_dependency_wait();  // the splits' states
  const float *p = part + static_cast<long long>(blockIdx.x) * splits * (D + 2);
  const int d = threadIdx.x;
  float mx = M_FLOOR;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, p[s * (D + 2) + D]);
  float num = 0.f, den = 0.f;
  for (int si = 0; si < splits; ++si) {
    const float *ps = p + si * (D + 2);
    const float w = expf(__fsub_rn(ps[D], mx));
    num = __fadd_rn(num, __fmul_rn(ps[d], w));
    den = __fadd_rn(den, __fmul_rn(ps[D + 1], w));
  }
  out[static_cast<long long>(blockIdx.x) * D + d] =
      __float2bfloat16_rn(__fdiv_rn(num, fmaxf(den, 1e-30f)));
}

struct Args {
  const bf16 *q;
  const void *k, *v;
  const float *ks, *vs;
  const int *mask;
  bf16 *out;
  float *part;
  int B, REP, KVH, L, n_blocks, splits;
  long long qsb, qsh;
  float scale;
  cudaStream_t stream;
};

template <int D, int BL>
cudaError_t launch(const Args &a) {
  using G = Geo<D, BL>;
  static bool smem_set = false;  // once a process: a decode step calls this per layer
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void *>(prefix_int8_split<D, BL>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::RING);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  // the cache as (D, KVH, B L) int8, read in boxes of one head's BL rows,
  // swizzled as swz() reads them
  CUtensorMap mk, mv;
  const long long dims[3] = {D, a.KVH, static_cast<long long>(a.B) * a.L};
  const long long strides[2] = {D, static_cast<long long>(a.KVH) * D};
  const int box[3] = {D, 1, BL};
  const CUtensorMapSwizzle sw = D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (!tensor_map_nd(&mk, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.k, 3, dims, strides, box, sw) ||
      !tensor_map_nd(&mv, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.v, 3, dims, strides, box, sw))
    return cudaErrorInvalidValue;
  const dim3 grid(a.KVH, a.B, a.splits);
  prefix_int8_split<D, BL><<<grid, NTHREADS, G::RING, a.stream>>>(
      mk, mv, a.q, a.ks, a.vs, a.mask, a.out, a.part, a.REP, a.KVH, a.L, a.n_blocks, a.qsb,
      a.qsh, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  // launched while the splits still run; it waits for them
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.KVH * a.REP);
  cfg.blockDim = dim3(D);
  cfg.stream = a.stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, prefix_int8_merge<D>, static_cast<const float *>(a.part),
                            a.out, a.splits);
}

}  // namespace

// q (B, H, D) bf16 with unit stride along D and element strides qsb, qsh;
// k/v (B, L, KVH, D) int8 contiguous and 16-byte aligned; ks/vs (B, L, KVH)
// fp32 contiguous; mask (B, L) int32 contiguous, 16-byte aligned; out (B, H,
// D) bf16 contiguous. D 64 or 128, n_rep = H / KVH 1, 2, 4 or 8; block_l 128
// or 256, dividing L; reads key blocks [0, n_blocks), n_blocks = max(ceil(
// valid_len / block_l), 1), in `splits` ranges of whole blocks (1 to
// n_blocks): with more than one, part is (B, H, splits, D + 2) fp32 scratch
// and a second launch merges the splits. Anything else is refused.
extern "C" int decode_attention_prefix_int8_bf16(
    const void *q, const void *k, const void *ks, const void *v, const void *vs,
    const void *mask, void *out, void *part, int B, int H, int KVH, int L, int D,
    int valid_len, int block_l, int splits, int qsb, int qsh, float scale, void *stream) {
  const auto aligned = [](const void *p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (B < 1 || KVH <= 0 || H % KVH != 0 || valid_len < 1 || valid_len > L ||
      (block_l != 128 && block_l != 256) || L % block_l != 0 || !aligned(k) || !aligned(v) ||
      !aligned(mask))
    return cudaErrorInvalidValue;
  const int n_blocks = (valid_len + block_l - 1) / block_l;
  const int rep = H / KVH;
  if ((rep != 1 && rep != 2 && rep != 4 && rep != 8) || splits < 1 || splits > n_blocks ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16 *>(q), k, v, static_cast<const float *>(ks),
               static_cast<const float *>(vs), static_cast<const int *>(mask),
               static_cast<bf16 *>(out), static_cast<float *>(part), B, rep, KVH, L,
               n_blocks, splits, qsb, qsh, scale, static_cast<cudaStream_t>(stream)};
  if (D == 128) return block_l == 256 ? launch<128, 256>(a) : launch<128, 128>(a);
  if (D == 64) return block_l == 256 ? launch<64, 256>(a) : launch<64, 128>(a);
  return cudaErrorInvalidValue;
}
