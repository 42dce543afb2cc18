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
// (B 2, 284 queries over 1052 keys at q_offset 768, H 32, D 128) dq is
// 0.0145 ms for its bytes at 3.35 TB/s and about 0.013 at 989 TFLOP/s, dk/dv
// 0.0234 and 0.017; at B 2, L 2048 both are bound by their operations (dq
// 0.103 ms, dk/dv 0.138). So each kernel's design is about keeping the
// tensor cores fed: TMA loads that overlap the products, the softmax on the
// accumulator registers, and the sums in registers for a CTA's whole life.
//
// The two kernels share one shape: a CTA of 256 threads, two consumer
// warpgroups of 64 rows each and no producer warp (one would cap every
// thread at 168 registers, and ptxas then serialises the products). The
// operands a CTA keeps are loaded once by TMA and stay resident in shared
// memory; the ones it walks over come through a ring of stages, each a TMA
// load of 128-byte-swizzled 64-column boxes from rank-4 tensor maps over
// (D, position, head, batch), which take any (batch, position, head)
// strides and zero-fill ragged tails. The consumer warpgroup that releases a
// stage second refills it (a counter a stage in shared memory says which).
// Each step's products are wgmma (bf16, fp32 sums): the two score products
// with both operands in shared memory (K-major), then the gradient products
// with P or dS formed on the score accumulators and rounded to bf16 straight
// into wgmma's register A fragments, the B operand read as it lies
// (MN-major, through wgmma's transpose) from the same stage. A step's
// gradient products stay in flight while the next step's score products are
// issued. CTAs are launched longest first.
//
// dq (dq::kernel): a CTA owns 128 query rows of one (batch, head). Q and dO
// stay resident; a ring of four stages brings K and V tiles of 64 keys and
// their key-mask ints (a 1D TMA box that starts 16-byte aligned; a warp vote
// skips the mask on tiles whose keys are all live), up to the causal end of
// the CTA's rows. A step runs S = Q K^T and dP = dO V^T (m64n64k16), then
// dQ += dS K (m64n128k16 at D 128, K read MN-major). Each thread keeps its
// rows' lse and delta in registers; dQ is an fp32 register accumulator (64
// registers a thread at D 128), written once as bf16. Causal CTAs run from
// the last query tile, which sees the most keys.
//
// dk/dv (dkv::kernel): a CTA owns 128 keys of one (batch, kv head). K and V
// stay resident; a ring of three stages holds (Q, dO) tiles of 64 query rows
// and their lse and delta rows (through 1D maps). A step walks every query
// head of the kv head, then the query tiles from the causal start on, with
// four products: S^T = K Q^T and dP^T = V dO^T (m64n64k16), then dV += P^T
// dO and dK += dS^T Q with dO and Q read MN-major. dK and dV are fp32
// register accumulators (250 of 255 registers). Causal CTAs run from the
// first key tile, which sees the most queries.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

// ---- dq: TMA + wgmma, dQ in registers

namespace dq {

constexpr int BQ = 128;           // query rows of a CTA: 64 for each consumer warpgroup
constexpr int BK = 64;            // keys of a ring stage
constexpr int THREADS = 256;      // two warpgroups; no producer warp (registers)
constexpr int ATOM = 1024;        // a 128-byte swizzle atom: 8 rows of 128 bytes
constexpr float LOG2E = 1.4426950408889634f;
// a TMA box must start 16-byte aligned: a stage's mask ints are read from
// the aligned element at or before its first key, 4 more than BK
constexpr int MASK_BOX = BK + 4;
constexpr int MASK_SLOT = 384;  // MASK_BOX ints, rounded up to 128 bytes

template <int D>
struct Smem {
  static constexpr int CH = D / 64;                // 64-column boxes of a row
  static constexpr int STAGES = 4;                 // K/V tiles in flight
  static constexpr int Q_BOX = BQ * 128;           // BQ rows of one 64-column box
  static constexpr int KV_BOX = BK * 128;
  static constexpr int KV_BYTES = CH * KV_BOX;     // a K or a V tile
  static constexpr int Q = 0;
  static constexpr int DO = Q + CH * Q_BOX;
  static constexpr int K = DO + CH * Q_BOX;        // stage s: K at K + 2 s KV_BYTES, V after it
  static constexpr int MASK = K + STAGES * 2 * KV_BYTES;  // stage s: MASK_BOX ints of the mask
  static constexpr int CNT = MASK + STAGES * MASK_SLOT;   // stage s: releases so far
  static constexpr int BAR = (CNT + 4 * STAGES + 7) / 8 * 8;  // Q and dO, full[STAGES]
  static constexpr int BYTES = BAR + (1 + STAGES) * 8 + ATOM;  // + slack to align
};

struct Params {
  const float *lse, *delta;  // (B, H, Lq)
  bf16 *dq;                  // (B, Lq, H, D)
  int B, H, KVH, Lq, Lk, n_qt, causal, q_offset;
  float scale;
};

__host__ __device__ __forceinline__ int key_tiles(int end) { return (end + BK - 1) / BK; }

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
       const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
       const __grid_constant__ CUtensorMap map_mask, const Params p) {
  using namespace rlaifv;
  using L = Smem<D>;
  constexpr int CH = L::CH, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (saddr(smem_raw) + ATOM - 1) / ATOM * ATOM;
  unsigned char *smem = smem_raw + (base - saddr(smem_raw));
  const int *s_mask = reinterpret_cast<const int *>(smem + L::MASK);  // stage s at s MASK_SLOT / 4
  int *s_cnt = reinterpret_cast<int *>(smem + L::CNT);
  const uint32_t bar_q = base + L::BAR, full = bar_q + 8;

  // longest first: with causal masking the last query tiles see the most keys
  const int hb = blockIdx.x % (p.B * p.H);
  const int qt = blockIdx.x / (p.B * p.H);
  const int q0 = (p.causal ? p.n_qt - 1 - qt : qt) * BQ;
  const int h = hb % p.H, b = hb / p.H;
  const int kvh = h / (p.H / p.KVH);
  const int n_tiles = key_tiles(p.causal ? min(p.Lk, p.q_offset + min(q0 + BQ, p.Lq)) : p.Lk);

  if (threadIdx.x == 0) {
    bar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + 8 * s, 1);
      s_cnt[s] = 0;
    }
    bar_init_fence();
  }
  __syncthreads();

  // key tile t into its stage: K, V and the tile's mask ints (of batch row
  // b; past Lk they belong to the next row or read 0, and are masked)
  auto load_tile = [&](int t) {
    const int s = t % STAGES, k0 = t * BK;
    const uint32_t kb = base + L::K + s * 2 * L::KV_BYTES, vb = kb + L::KV_BYTES;
    const uint32_t bar = full + 8 * s;
    bar_expect(bar, 2 * L::KV_BYTES + MASK_BOX * 4);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      tma_load_4d(kb + c * L::KV_BOX, &map_k, 64 * c, k0, kvh, b, bar);
      tma_load_4d(vb + c * L::KV_BOX, &map_v, 64 * c, k0, kvh, b, bar);
    }
    tma_load_1d(base + L::MASK + s * MASK_SLOT, &map_mask, (b * p.Lk + k0) & ~3, bar);
  };
  // this warpgroup is done with tile t's stage: the second warpgroup to say
  // so refills it with tile t + STAGES
  auto release = [&](int t) {
    if (threadIdx.x % 128 == 0 && (atomicAdd(s_cnt + t % STAGES, 1) & 1) &&
        t + STAGES < n_tiles)
      load_tile(t + STAGES);
  };
  if (threadIdx.x == 0) {
    bar_expect(bar_q, 2 * CH * L::Q_BOX);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      tma_load_4d(base + L::Q + c * L::Q_BOX, &map_q, 64 * c, q0, h, b, bar_q);
      tma_load_4d(base + L::DO + c * L::Q_BOX, &map_do, 64 * c, q0, h, b, bar_q);
    }
    for (int t = 0; t < min(STAGES, n_tiles); ++t) load_tile(t);
  }

  // a consumer warpgroup: rows r_wg .. r_wg + 63 of the tile; this thread
  // holds rows row0 and row0 + 8 (hh = 0, 1) at columns 8 j + 2 (lane % 4) + {0, 1}
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane % 4;
  const int wg = warp / 4;
  const int r_wg = q0 + 64 * wg;
  const int row0 = r_wg + 16 * (warp % 4) + lane / 4;
  int n_wg = 0;  // the key tiles this warpgroup reads: up to its own causal end
  if (r_wg < p.Lq)
    n_wg = p.causal ? key_tiles(min(p.Lk, p.q_offset + min(r_wg + 64, p.Lq))) : n_tiles;
  // this thread's rows' lse (in log2 units) and delta; rows at or past Lq
  // read zeros (TMA zero-fills their Q and dO: dS = 0) and are never written
  float lse2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const long long at = (static_cast<long long>(b) * p.H + h) * p.Lq + row;
    lse2[hh] = row < p.Lq ? p.lse[at] * LOG2E : 0.f;
    dlt[hh] = row < p.Lq ? p.delta[at] : 0.f;
  }
  const float c = p.scale * LOG2E;  // scores in log2 units
  float acc[D / 2], sc[BK / 2], dp[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);  // the zeros land before the first product's fence
  uint32_t da[BK / 16][4];  // dS in bf16, wgmma's A fragments

  const uint32_t qa = base + L::Q + wg * 64 * 128, doa = base + L::DO + wg * 64 * 128;
  bar_wait(bar_q, 0);
  int pending = -1;  // the tile whose dQ product is in flight
  for (int t = 0; t < n_wg; ++t) {
    const int s = t % STAGES;
    bar_wait(full + 8 * s, (t / STAGES) & 1);
    const uint32_t kb = base + L::K + s * 2 * L::KV_BYTES, vb = kb + L::KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_bf16_ss<BK>(sc, gmma_desc(qa + (kk / 4) * L::Q_BOX + (kk % 4) * 32, 16, ATOM),
                        gmma_desc(kb + (kk / 4) * L::KV_BOX + (kk % 4) * 32, 16, ATOM),
                        kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_bf16_ss<BK>(dp, gmma_desc(doa + (kk / 4) * L::Q_BOX + (kk % 4) * 32, 16, ATOM),
                        gmma_desc(vb + (kk / 4) * L::KV_BOX + (kk % 4) * 32, 16, ATOM),
                        kk > 0);
    wgmma_commit();
    wgmma_wait<0>();  // S and dP of this tile, dQ of the last one
    fence_acc(acc);
    fence_acc(sc);
    fence_acc(dp);
    if (pending >= 0) release(pending);

    // a warp's vote: every key of the tile lies before Lk and has mask 1
    const int k0 = t * BK;
    const int *km = s_mask + s * (MASK_SLOT / 4) + ((b * p.Lk + k0) & 3);
    const bool all_live =
        k0 + 2 * lane + 1 < p.Lk && km[2 * lane] != 0 && km[2 * lane + 1] != 0;
    const bool keyed = !__all_sync(0xffffffffu, all_live);
    const bool on_diagonal = p.causal && k0 + BK - 1 > p.q_offset + r_wg;
    // dS = P (dP - delta) scale, P = exp(S scale - lse), masked, straight
    // into the A fragments: register 8 ks + 2 r + e of S and dP holds row
    // row0 + 8 (r & 1), column 16 ks + 8 (r >> 1) + 2 (lane % 4) + e. No
    // plain code writes the accumulators (ptxas would serialise the products)
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int hh = r & 1;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * ks + 2 * r + e, col = 16 * ks + 8 * (r >> 1) + 2 * tq + e;
          const bool ok = (!keyed || (k0 + col < p.Lk && km[col] != 0)) &&
                          (!on_diagonal || k0 + col <= p.q_offset + row0 + 8 * hh);
          const float pv = ok ? exp2_approx(fmaf(sc[i], c, -lse2[hh])) : 0.f;
          ds[e] = pv * (dp[i] - dlt[hh]) * p.scale;
        }
        da[ks][r] = pack_bf16(ds[0], ds[1]);
      }

    // dQ += dS K, K read as it lies (MN-major)
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_bf16_rs<D, 1>(acc, da[ks], gmma_desc(kb + ks * 2 * ATOM, L::KV_BOX, ATOM));
    wgmma_commit();
    pending = t;
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (pending >= 0) release(pending);
  // the tiles past this warpgroup's causal end: released once they have landed
  for (int t = n_wg; t < n_tiles; ++t) {
    bar_wait(full + 8 * (t % STAGES), (t / STAGES) & 1);
    release(t);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= p.Lq) continue;
    bf16 *dst = p.dq + ((static_cast<long long>(b) * p.Lq + row) * p.H + h) * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162 *>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

template <int D>
cudaError_t launch(const CUtensorMap (&maps)[5], const Params &p, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<D><<<p.n_qt * p.H * p.B, THREADS, bytes, stream>>>(maps[0], maps[1], maps[2],
                                                             maps[3], maps[4], p);
  return cudaGetLastError();
}

}  // namespace dq

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

bool bad_shape(int B, int H, int KVH, int Lq, int Lk, int D, int q_offset) {
  return B <= 0 || KVH <= 0 || H % KVH != 0 || Lq <= 0 || Lk <= 0 || q_offset < 0 ||
         (D != 64 && D != 128);
}

}  // namespace

// q (B, Lq, H, D), k/v (B, Lk, KVH, D), dout (B, Lq, H, D) bf16 with unit
// stride along D, the given element strides for (batch, position, head)
// (each a positive multiple of 8: TMA tensor maps take no stride 0) and
// 16-byte aligned bases; mask (B, Lk) int32, 16-byte aligned; lse and delta
// (B, H, Lq) fp32 contiguous; dq (B, Lq, H, D) bf16 contiguous.
extern "C" int flash_attention_bwd_dq_bf16(
    const void *q, const void *k, const void *v, const void *mask,
    const void *dout, const void *lse, const void *delta, void *dq_out, int B,
    int H, int KVH, int Lq, int Lk, int D, int qsb, int qsl, int qsh, int ksb,
    int ksl, int ksh, int vsb, int vsl, int vsh, int osb, int osl, int osh,
    int causal, int q_offset, float scale, void *stream) {
  if (dq_out == nullptr || bad_shape(B, H, KVH, Lq, Lk, D, q_offset))
    return cudaErrorInvalidValue;
  CUtensorMap maps[5];
  using rlaifv::attention_map;
  if (!attention_map(&maps[0], q, B, Lq, H, D, qsb, qsl, qsh, dq::BQ) ||
      !attention_map(&maps[1], k, B, Lk, KVH, D, ksb, ksl, ksh, dq::BK) ||
      !attention_map(&maps[2], v, B, Lk, KVH, D, vsb, vsl, vsh, dq::BK) ||
      !attention_map(&maps[3], dout, B, Lq, H, D, osb, osl, osh, dq::BQ) ||
      !rlaifv::tensor_map_1d(&maps[4], CU_TENSOR_MAP_DATA_TYPE_INT32, mask,
                             static_cast<long long>(B) * Lk, dq::MASK_BOX))
    return cudaErrorInvalidValue;
  const dq::Params p{static_cast<const float *>(lse), static_cast<const float *>(delta),
                     static_cast<bf16 *>(dq_out), B, H, KVH, Lq, Lk,
                     (Lq + dq::BQ - 1) / dq::BQ, causal, q_offset, scale};
  auto stm = static_cast<cudaStream_t>(stream);
  return D == 64 ? dq::launch<64>(maps, p, stm) : dq::launch<128>(maps, p, stm);
}

// as above; dk and dv (B, Lk, KVH, D) bf16 contiguous, each the sum over the
// n_rep = H / KVH query heads of its kv head
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
