// Flash attention backward for Hopper (sm_90a): dq and dk/dv, bf16 in and
// out, fp32 inside.
//
// Replaces: rlaifv_tpu/ops/flash_attention.py:_bwd_dq_kernel and
// _bwd_dkv_kernel (the two pallas_calls of _bwd), the TPU kernels behind
// the gradient of `flash_attention`. The split is the TPU's own: dq from one
// kernel, dk and dv from the other. No atomics: every output element is
// written once by one CTA, so the gradient is deterministic. Probabilities
// are recomputed from the forward's saved lse, p = exp(s scale - lse), and
// dS = p (dP - delta) scale; the products take P and dS rounded to bf16, as
// the TPU kernels' bf16 MXU path does, and every sum is fp32, rounded to
// bf16 once. delta = rowsum(dO O) is a plain torch reduction outside, as it
// is an XLA fusion outside on the TPU. Masking is the forward's: a key with
// mask 0, or (causal) a key past the query's absolute position q_offset +
// row, has p = 0. That covers the rows the forward reported as fully masked
// (their lse is about -5e29): every entry of such a row is masked, so the
// row adds nothing.
//
// What bounds both on the H100: tensor-core FLOPs (dq: 6 D flops a visible
// (query, key) pair of a head, dk/dv: 8 D); at the train step's suffix call
// (B 2, 284 queries over 1052 keys at q_offset 768, H 32, D 128) dk/dv is
// 0.0234 ms at 3.35 TB/s for its bytes and about 0.017 at 989 TFLOP/s.
//
// dq (flash_bwd_dq_kernel): one CTA of 4 warps per (batch, head, 64 query
// rows) streams 64-key K/V tiles through shared memory up to the causal
// diagonal; WMMA 16x16x16 products, dq in WMMA fragments.
//
// dk/dv (dkv::kernel): a CTA owns 128 keys of one (batch, kv head), 64 for
// each of two consumer warpgroups (256 threads, so that each thread may hold
// up to 255 registers). K and V stay resident in shared memory, loaded once
// by TMA. A ring of three stages holds (Q, dO) tiles of 64 query rows and
// their lse and delta rows, TMA-loaded (128-byte-swizzled 64-column boxes of
// rank-4 tensor maps over (D, position, head, batch), which take any (batch,
// position, head) strides and zero-fill ragged tails; lse and delta through
// 1D maps). A step walks every query head of the kv head, then the query
// tiles from the causal start on. Each step runs four wgmma products:
// S^T = K Q^T and dP^T = V dO^T (m64n64k16, both operands in shared memory,
// K-major), then, from P^T and dS^T formed on the accumulator registers and
// rounded to bf16 straight into wgmma's register A fragments, dV += P^T dO
// and dK += dS^T Q with dO and Q read as they lie (MN-major, through
// wgmma's transpose), from the same stage. dK and dV are fp32 register
// accumulators for the CTA's whole life, written once as bf16. A step's dV
// and dK products stay in flight while the next step's S^T and dP^T are
// issued. There is no producer warp (it would cap every thread at 224
// registers): the consumer warpgroup that releases a stage second refills it
// (a counter in shared memory says which). CTAs are launched longest first
// (causal: the first key tiles see the most queries).
#include <math.h>
#include <mma.h>

#include "common.cuh"
#include "hopper.cuh"

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // key rows per tile
constexpr int NWARPS = 4;  // each warp owns 16 rows of the CTA's own tile
constexpr int NTHREADS = NWARPS * 32;
static_assert(BQ == 16 * NWARPS && BK == 16 * NWARPS, "16 rows a warp");

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// element strides (batch, position, head) of q, k, v and dO
struct Strides {
  long long qb, ql, qh, kb, kl, kh, vb, vl, vh, ob, ol, oh;
};

template <int D>
struct Tiles {
  static constexpr int LDQ = D + 8;   // bf16 row stride of Q/K/V/dO tiles
  static constexpr int LDS = 64 + 4;  // fp32 row stride of 64-wide score tiles
  static constexpr int LDP = 64 + 8;  // bf16 row stride of 64-wide P/dS tiles
  static constexpr int LDA = D + 4;   // fp32 row stride of D-wide sums
  static constexpr int TILE = align128(64 * LDQ * 2);
  static constexpr int SCORE = align128(64 * LDS * 4);
  static constexpr int PROB = align128(64 * LDP * 2);
  static constexpr int ACC = align128(64 * LDA * 4);
  static constexpr int ROW = align128(64 * 4);
};

template <int D>
struct DqLayout : Tiles<D> {
  using T = Tiles<D>;
  static constexpr int Q = 0;
  static constexpr int DO = Q + T::TILE;
  static constexpr int K = DO + T::TILE;
  static constexpr int V = K + T::TILE;
  static constexpr int S = V + T::TILE;
  static constexpr int DP = S + T::SCORE;
  static constexpr int DS = DP + T::SCORE;
  static constexpr int OUT = DS + T::PROB;
  static constexpr int MASK = OUT + T::ACC;
  static constexpr int BYTES = MASK + T::ROW;
};

// rows [row0, row0 + 64) of a (.., L, .., D) operand into a shared tile,
// zero-filling rows at or past `rows`; 16-byte loads along D
template <int D>
__device__ __forceinline__ void load_tile(bf16 *dst, const bf16 *src,
                                          long long row_stride, int row0,
                                          int rows) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows) val = rlaifv::load16(src + (row0 + r) * row_stride + c * 8);
    *reinterpret_cast<uint4 *>(dst + r * Tiles<D>::LDQ + c * 8) = val;
  }
}

// out[16 x 64] (fp32, this warp's rows) = A[16 x D] . B[64 x D]^T, with A
// and B row-major bf16 tiles in shared memory
template <int D>
__device__ __forceinline__ void product_abt(float *out, const bf16 *a,
                                            const bf16 *b) {
  constexpr int LDQ = Tiles<D>::LDQ;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk, LDQ);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + n * 16 * LDQ + kk, LDQ);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], Tiles<D>::LDS,
                            wmma::mem_row_major);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16 *__restrict__ q, const bf16 *__restrict__ k,
                    const bf16 *__restrict__ v, const int *__restrict__ mask,
                    const bf16 *__restrict__ dout,
                    const float *__restrict__ lse,
                    const float *__restrict__ delta, bf16 *__restrict__ dq,
                    int H, int KVH, int Lq, int Lk, Strides st, int causal,
                    int q_offset, float scale) {
  using Lay = DqLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *sQ = reinterpret_cast<bf16 *>(smem + Lay::Q);
  bf16 *sDO = reinterpret_cast<bf16 *>(smem + Lay::DO);
  bf16 *sK = reinterpret_cast<bf16 *>(smem + Lay::K);
  bf16 *sV = reinterpret_cast<bf16 *>(smem + Lay::V);
  float *sS = reinterpret_cast<float *>(smem + Lay::S);
  float *sDP = reinterpret_cast<float *>(smem + Lay::DP);
  bf16 *sDS = reinterpret_cast<bf16 *>(smem + Lay::DS);
  float *sOut = reinterpret_cast<float *>(smem + Lay::OUT);
  int *sMask = reinterpret_cast<int *>(smem + Lay::MASK);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile<D>(sQ, q + b * st.qb + h * st.qh, st.ql, q0, Lq);
  load_tile<D>(sDO, dout + b * st.ob + h * st.oh, st.ol, q0, Lq);

  // lanes 2i and 2i+1 share query row warp*16 + i, 32 columns each
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int qi = q0 + row;
  const bool row_ok = qi < Lq;
  const long long stat = ((long long)b * H + h) * Lq + qi;
  const float lse_r = row_ok ? lse[stat] : 0.f;
  const float delta_r = row_ok ? delta[stat] : 0.f;
  const int qpos = q_offset + qi;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  // keys past the tile's last query position are never read
  int kv_end = Lk;
  if (causal) kv_end = min(Lk, q_offset + min(q0 + BQ, Lq));

  const bf16 *kb = k + b * st.kb + kvh * st.kh;
  const bf16 *vb = v + b * st.vb + kvh * st.vh;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous K/V tile is consumed
    load_tile<D>(sK, kb, st.kl, k0, Lk);
    load_tile<D>(sV, vb, st.vl, k0, Lk);
    for (int j = threadIdx.x; j < BK; j += NTHREADS)
      sMask[j] = (k0 + j < Lk) ? mask[(long long)b * Lk + k0 + j] : 0;
    __syncthreads();

    const int wrow = warp * 16;
    product_abt<D>(sS + wrow * Tiles<D>::LDS, sQ + wrow * Tiles<D>::LDQ, sK);
    product_abt<D>(sDP + wrow * Tiles<D>::LDS, sDO + wrow * Tiles<D>::LDQ, sV);
    __syncwarp();

    // dS = P o (dP - delta) * scale, P = exp(S * scale - lse)
    {
      const float *srow = sS + row * Tiles<D>::LDS;
      const float *dprow = sDP + row * Tiles<D>::LDS;
      bf16 *dsrow = sDS + row * Tiles<D>::LDP;
#pragma unroll 8
      for (int j = 0; j < BK / 2; ++j) {
        const int c = 2 * j + half;
        const bool ok = row_ok && sMask[c] != 0 && (!causal || k0 + c <= qpos);
        const float p = ok ? expf(srow[c] * scale - lse_r) : 0.f;
        dsrow[c] = __float2bfloat16(p * (dprow[c] - delta_r) * scale);
      }
    }
    __syncwarp();

    // dq += dS K for this warp's 16 rows
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sDS + wrow * Tiles<D>::LDP + kk, Tiles<D>::LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sK + kk * Tiles<D>::LDQ + n * 16, Tiles<D>::LDQ);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      }
    }
  }

  float *orow_base = sOut + warp * 16 * Tiles<D>::LDA;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(orow_base + n * 16, acc[n], Tiles<D>::LDA,
                            wmma::mem_row_major);
  __syncwarp();
  if (row_ok) {
    const float *orow = sOut + row * Tiles<D>::LDA;
    bf16 *dst = dq + (((long long)b * Lq + qi) * H + h) * D;
#pragma unroll 8
    for (int j = 0; j < D / 2; ++j) {
      const int c = 2 * j + half;
      dst[c] = __float2bfloat16(orow[c]);
    }
  }
}

// ---- dk/dv: TMA + wgmma, the sums in registers

namespace dkv {

constexpr int BKV = 128;          // keys of a CTA: 64 for each consumer warpgroup
constexpr int BQ = 64;            // query rows of a step
constexpr int THREADS = 256;      // two warpgroups; no producer warp (registers)
constexpr int ATOM = 1024;        // a 128-byte swizzle atom: 8 rows of 128 bytes
constexpr float LOG2E = 1.4426950408889634f;
// a TMA box must start 16-byte aligned: a step's lse and delta values are
// read from the aligned element at or before its first, 4 more than BQ
constexpr int ROW_BOX = BQ + 4;
constexpr int ROW_SLOT = 512;  // ROW_BOX floats, rounded up to 128 bytes

template <int D>
struct Smem {
  static constexpr int CH = D / 64;                 // 64-column boxes of a row
  static constexpr int STAGES = 3;                  // (Q, dO, lse, delta) steps in flight
  static constexpr int KV_BOX = BKV * 128;          // BKV rows of one 64-column box
  static constexpr int Q_BOX = BQ * 128;
  static constexpr int K = 0;
  static constexpr int V = K + CH * KV_BOX;
  static constexpr int STAGE = 2 * CH * Q_BOX;      // Q, then dO
  static constexpr int QS = V + CH * KV_BOX;        // stage s at QS + s STAGE
  static constexpr int STATS = QS + STAGES * STAGE;  // stage s: lse, then delta, ROW_SLOT each
  static constexpr int CNT = STATS + STAGES * 2 * ROW_SLOT;  // stage s: releases so far
  static constexpr int BAR = CNT + 16;              // K/V, full[STAGES]
  static constexpr int BYTES = BAR + (1 + STAGES) * 8 + ATOM;  // + slack to align
};

struct Params {
  const int *mask;  // (B, Lk)
  bf16 *dk, *dv;    // (B, Lk, KVH, D)
  int B, H, KVH, Lq, Lk, causal, q_offset;
  float scale;
};

// A CTA owns keys k0 .. k0 + 127 of one (batch, kv head); warpgroup w the 64
// from k0 + 64 w. Its steps walk the query heads of the kv head, and for
// each the query tiles from the first that can see k0 (causal) to Lq.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
       const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
       const __grid_constant__ CUtensorMap map_lse,
       const __grid_constant__ CUtensorMap map_delta, const Params p) {
  using namespace rlaifv;
  using L = Smem<D>;
  constexpr int CH = L::CH, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (saddr(smem_raw) + ATOM - 1) / ATOM * ATOM;
  unsigned char *smem = smem_raw + (base - saddr(smem_raw));
  const float *s_stats = reinterpret_cast<const float *>(smem + L::STATS);
  int *s_cnt = reinterpret_cast<int *>(smem + L::CNT);
  const uint32_t bar_kv = base + L::BAR, full = bar_kv + 8;

  // longest first: with causal masking the first key tiles see the most queries
  const int hb = blockIdx.x % (p.B * p.KVH);
  const int k0 = blockIdx.x / (p.B * p.KVH) * BKV;
  const int kvh = hb % p.KVH, b = hb / p.KVH;
  const int n_rep = p.H / p.KVH;
  const int q_begin = p.causal ? max(0, k0 - p.q_offset) / BQ * BQ : 0;
  const int n_q = q_begin < p.Lq ? (p.Lq - q_begin + BQ - 1) / BQ : 0;
  const int steps = n_rep * n_q;

  if (threadIdx.x == 0) {
    bar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + 8 * s, 1);
      s_cnt[s] = 0;
    }
    bar_init_fence();
  }
  __syncthreads();

  // step i into its stage: Q and dO of query tile qt of head h, and their lse and delta rows
  auto load_step = [&](int i) {
    const int s = i % STAGES;
    const int h = kvh * n_rep + i / n_q, qt = q_begin + (i % n_q) * BQ;
    const uint32_t st = base + L::QS + s * L::STAGE, bar = full + 8 * s;
    const uint32_t stats = base + L::STATS + s * 2 * ROW_SLOT;
    bar_expect(bar, L::STAGE + 2 * ROW_BOX * 4);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      tma_load_4d(st + c * L::Q_BOX, &map_q, 64 * c, qt, h, b, bar);
      tma_load_4d(st + (CH + c) * L::Q_BOX, &map_do, 64 * c, qt, h, b, bar);
    }
    const int row = ((b * p.H + h) * p.Lq + qt) & ~3;
    tma_load_1d(stats, &map_lse, row, bar);
    tma_load_1d(stats + ROW_SLOT, &map_delta, row, bar);
  };
  // this warpgroup is done with step j's stage: the second warpgroup to say
  // so refills it with step j + STAGES
  auto release = [&](int j) {
    if (threadIdx.x % 128 == 0 && (atomicAdd(s_cnt + j % STAGES, 1) & 1) && j + STAGES < steps)
      load_step(j + STAGES);
  };

  if (threadIdx.x == 0 && steps > 0) {
    bar_expect(bar_kv, 2 * CH * L::KV_BOX);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      tma_load_4d(base + L::K + c * L::KV_BOX, &map_k, 64 * c, k0, kvh, b, bar_kv);
      tma_load_4d(base + L::V + c * L::KV_BOX, &map_v, 64 * c, k0, kvh, b, bar_kv);
    }
    for (int i = 0; i < min(STAGES, steps); ++i) load_step(i);
  }

  // this thread holds key rows key0 and key0 + 8 (hh = 0, 1) of its
  // warpgroup's 64, at query columns 8 j + 2 (lane % 4) + {0, 1} of a step
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane % 4;
  const int wg = warp / 4;
  const int kw0 = k0 + 64 * wg;
  const int key0 = kw0 + 16 * (warp % 4) + lane / 4;
  bool key_ok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kj = key0 + 8 * hh;
    key_ok[hh] = kj < p.Lk && p.mask[static_cast<long long>(b) * p.Lk + kj] != 0;
  }
  const float c = p.scale * LOG2E;
  float dk[D / 2], dv[D / 2], sc[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // P^T and dS^T in bf16, wgmma's A fragments
  const uint32_t ka = base + L::K + wg * 64 * 128, va = base + L::V + wg * 64 * 128;

  if (steps > 0) bar_wait(bar_kv, 0);
  int pending = -1;  // the step whose dV and dK products are in flight
  for (int i = 0; i < steps; ++i) {
    const int s = i % STAGES;
    const int qt = q_begin + (i % n_q) * BQ;
    const uint32_t qs = base + L::QS + s * L::STAGE, dos = qs + CH * L::Q_BOX;
    // a step that sees none of this warpgroup's keys adds nothing
    const bool live = kw0 < p.Lk && !(p.causal && kw0 > p.q_offset + qt + BQ - 1);
    bar_wait(full + 8 * s, (i / STAGES) & 1);
    if (live) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_ss<BQ>(sc, gmma_desc(ka + (kk / 4) * L::KV_BOX + (kk % 4) * 32, 16, ATOM),
                          gmma_desc(qs + (kk / 4) * L::Q_BOX + (kk % 4) * 32, 16, ATOM),
                          kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_ss<BQ>(dp, gmma_desc(va + (kk / 4) * L::KV_BOX + (kk % 4) * 32, 16, ATOM),
                          gmma_desc(dos + (kk / 4) * L::Q_BOX + (kk % 4) * 32, 16, ATOM),
                          kk > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();  // S^T and dP^T of this step, dV and dK of the last
    fence_acc(dk);
    fence_acc(dv);
    if (pending >= 0) release(pending);
    pending = -1;
    if (!live) {
      release(i);
      continue;
    }
    fence_acc(sc);
    fence_acc(dp);

    // P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale, masked:
    // keys past Lk or with mask 0, queries at or past Lq (TMA zero-fills their
    // rows, but their lse is another row's), and (causal) keys past the query
    const int h = kvh * n_rep + i / n_q;
    const float *lse = s_stats + s * 2 * (ROW_SLOT / 4) + (((b * p.H + h) * p.Lq + qt) & 3);
    const float *delta = lse + ROW_SLOT / 4;
    const bool tail = qt + BQ > p.Lq;
    const bool diag = p.causal && kw0 + 63 > p.q_offset + qt;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * tq + e;
        const float lse2 = lse[col] * LOG2E, dlt = delta[col];
        const bool col_ok = !tail || qt + col < p.Lq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh + e;
          const bool ok = key_ok[hh] && col_ok &&
                          (!diag || key0 + 8 * hh <= p.q_offset + qt + col);
          const float pv = ok ? exp2_approx(fmaf(sc[i], c, -lse2)) : 0.f;
          sc[i] = pv;
          dp[i] = pv * (dp[i] - dlt) * p.scale;
        }
      }
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[ks][r] = pack_bf16(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);
        da[ks][r] = pack_bf16(dp[8 * ks + 2 * r], dp[8 * ks + 2 * r + 1]);
      }

    // dV += P^T dO and dK += dS^T Q, dO and Q read as they lie (MN-major)
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks)
      wgmma_bf16_rs<D, 1>(dv, pa[ks], gmma_desc(dos + ks * 2 * ATOM, L::Q_BOX, ATOM));
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks)
      wgmma_bf16_rs<D, 1>(dk, da[ks], gmma_desc(qs + ks * 2 * ATOM, L::Q_BOX, ATOM));
    wgmma_commit();
    pending = i;
  }
  wgmma_wait<0>();
  fence_acc(dk);
  fence_acc(dv);
  if (pending >= 0) release(pending);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kj = key0 + 8 * hh;
    if (kj >= p.Lk) continue;
    const long long off = ((static_cast<long long>(b) * p.Lk + kj) * p.KVH + kvh) * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162 *>(p.dk + off + 8 * j) =
          __floats2bfloat162_rn(dk[4 * j + 2 * hh], dk[4 * j + 2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162 *>(p.dv + off + 8 * j) =
          __floats2bfloat162_rn(dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const CUtensorMap (&maps)[6], const Params &p, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int grid = (p.Lk + BKV - 1) / BKV * p.KVH * p.B;
  kernel<D><<<grid, THREADS, bytes, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                              maps[5], p);
  return cudaGetLastError();
}

}  // namespace dkv

template <int D>
cudaError_t launch_dq(const bf16 *q, const bf16 *k, const bf16 *v, const int *mask,
                      const bf16 *dout, const float *lse, const float *delta, bf16 *dq, int B,
                      int H, int KVH, int Lq, int Lk, const Strides &st, int causal,
                      int q_offset, float scale, cudaStream_t stream) {
  constexpr int bytes = DqLayout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      q, k, v, mask, dout, lse, delta, dq, H, KVH, Lq, Lk, st, causal, q_offset, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int KVH, int Lq, int Lk, int D, int q_offset) {
  return B <= 0 || KVH <= 0 || H % KVH != 0 || Lq <= 0 || Lk <= 0 || q_offset < 0 ||
         (D != 64 && D != 128);
}

}  // namespace

// q (B, Lq, H, D), k/v (B, Lk, KVH, D), dout (B, Lq, H, D) bf16 with unit
// stride along D and the given element strides for (batch, position, head);
// mask (B, Lk) int32; lse and delta (B, H, Lq) fp32 contiguous; dq
// (B, Lq, H, D) bf16 contiguous.
extern "C" int flash_attention_bwd_dq_bf16(
    const void *q, const void *k, const void *v, const void *mask,
    const void *dout, const void *lse, const void *delta, void *dq, int B,
    int H, int KVH, int Lq, int Lk, int D, int qsb, int qsl, int qsh, int ksb,
    int ksl, int ksh, int vsb, int vsl, int vsh, int osb, int osl, int osh,
    int causal, int q_offset, float scale, void *stream) {
  if (dq == nullptr || bad_shape(B, H, KVH, Lq, Lk, D, q_offset)) return cudaErrorInvalidValue;
  const Strides st{qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, osb, osl, osh};
  const auto *qp = static_cast<const bf16 *>(q);
  const auto *kp = static_cast<const bf16 *>(k);
  const auto *vp = static_cast<const bf16 *>(v);
  const auto *mp = static_cast<const int *>(mask);
  const auto *op = static_cast<const bf16 *>(dout);
  const auto *lp = static_cast<const float *>(lse);
  const auto *dp = static_cast<const float *>(delta);
  auto *dqp = static_cast<bf16 *>(dq);
  auto stm = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dq<64>(qp, kp, vp, mp, op, lp, dp, dqp, B, H, KVH, Lq, Lk, st, causal,
                                 q_offset, scale, stm)
                 : launch_dq<128>(qp, kp, vp, mp, op, lp, dp, dqp, B, H, KVH, Lq, Lk, st,
                                  causal, q_offset, scale, stm);
}

// as above (q, k, v and dout with strides that are multiples of 8 elements
// and 16-byte aligned bases); dk and dv (B, Lk, KVH, D) bf16 contiguous,
// each the sum over the n_rep = H / KVH query heads of its kv head
extern "C" int flash_attention_bwd_dkv_bf16(
    const void *q, const void *k, const void *v, const void *mask,
    const void *dout, const void *lse, const void *delta, void *dk, void *dv,
    int B, int H, int KVH, int Lq, int Lk, int D, int qsb, int qsl, int qsh,
    int ksb, int ksl, int ksh, int vsb, int vsl, int vsh, int osb, int osl,
    int osh, int causal, int q_offset, float scale, void *stream) {
  if (dk == nullptr || dv == nullptr || bad_shape(B, H, KVH, Lq, Lk, D, q_offset))
    return cudaErrorInvalidValue;
  CUtensorMap maps[6];
  const long long rows = static_cast<long long>(B) * H * Lq;
  using rlaifv::attention_map;
  using rlaifv::tensor_map_1d;
  if (!attention_map(&maps[0], q, B, Lq, H, D, qsb, qsl, qsh, dkv::BQ) ||
      !attention_map(&maps[1], k, B, Lk, KVH, D, ksb, ksl, ksh, dkv::BKV) ||
      !attention_map(&maps[2], v, B, Lk, KVH, D, vsb, vsl, vsh, dkv::BKV) ||
      !attention_map(&maps[3], dout, B, Lq, H, D, osb, osl, osh, dkv::BQ) ||
      !tensor_map_1d(&maps[4], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, lse, rows, dkv::ROW_BOX) ||
      !tensor_map_1d(&maps[5], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, delta, rows, dkv::ROW_BOX))
    return cudaErrorInvalidValue;
  const dkv::Params p{static_cast<const int *>(mask), static_cast<bf16 *>(dk),
                      static_cast<bf16 *>(dv), B, H, KVH, Lq, Lk, causal, q_offset, scale};
  auto stm = static_cast<cudaStream_t>(stream);
  return D == 64 ? dkv::launch<64>(maps, p, stm) : dkv::launch<128>(maps, p, stm);
}
