// Flash attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces: rlaifv_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _fwd's pallas_call), the TPU kernel behind `flash_attention`.
//
// What bounds it on the H100: tensor-core FLOPs, 4 D flops a visible (query,
// key) pair of a head (S = Q K^T and O = P V). At the autocheck prefix
// prefill (Lq = Lk = 740, H = 32, D = 128, causal) that is 0.0046 ms at 989
// TFLOP/s against 0.0073 ms for its bytes, so a call of this size is bound
// by how fast its tiles come in and its products issue, not by either peak.
//
// What the design does about it: a CTA of 256 threads owns 128 query rows of
// one (batch, head): two consumer warpgroups of 64 rows each, and no
// producer warp (with one, ptxas caps every thread at 168 registers and
// serialises the products). Thread 0 loads Q once and the first K/V tiles
// (128 keys each; 2 stages at D 128, 3 at D 64) with TMA loads of
// 128-byte-swizzled 64-column boxes from rank-4 tensor maps over (D,
// position, head, batch), which read any (batch, position, head) strides
// and zero-fill the ragged Lq/Lk tails; the walk stops at the causal
// diagonal. The warpgroup that releases a stage second refills it (a
// counter a stage in shared memory says which). Each tile's key mask
// (int32, nonzero = attend) comes in by a 1D TMA box beside it, and a warp
// vote skips the mask on tiles whose keys are all live. Each warpgroup runs
// S = Q K^T as wgmma m64n128k16 with both operands in shared memory
// (K-major), masks on the accumulator registers (the causal test only on
// tiles that cross its diagonal), keeps the online softmax in registers
// (the 4 threads of a row combine with two shuffles), rounds P to bf16
// straight into wgmma's register A fragment and runs O += P V with V read
// as it lies (MN-major, through wgmma's transpose), O an fp32 register
// accumulator. The running max is snapped up to a whole number of log2
// units, so the rescale is a power of two (exact) and bf16(P) scales
// exactly with it: a row's P hardly depends on which tile its keys fell in
// (the shared-prefix scorer left-pads a prefix the train step right-pads).
// The next tile's S product is issued right behind P V, and O is rescaled
// only after both have retired (reading an accumulator while a product is
// in flight would serialise the products). The two warpgroups take turns
// on the tensor cores: one computes its softmax while the other's products
// run. CTAs are launched longest first (causal query tiles from the last),
// one a streaming multiprocessor (~160 KB of shared memory at D 128).
//
// Semantics kept from the TPU kernel: scale 1/sqrt(D); key mask plus an
// optional causal mask on absolute positions (q_offset + row); GQA by
// h / (H / KVH); fp32 scores and sums, P rounded to bf16 for P.V; a row
// whose keys are all masked outputs exactly 0 and lse = -5e29 + log(1e-30);
// otherwise lse = max + log(sum).
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

using namespace rlaifv;

constexpr int BQ = 128;                // query rows of a CTA
constexpr int BK = 128;                // keys of a K/V tile
constexpr int THREADS = 256;           // two warpgroups of 64 rows; no producer warp
constexpr int ATOM = 1024;             // a 128-byte swizzle atom: 8 rows of 128 bytes
// a TMA box must start 16-byte aligned: a tile's mask ints are read from the
// aligned element at or before the tile's first, 4 more than the tile
constexpr int MASK_BOX = BK + 4;
constexpr int MASK_SLOT = 640;         // MASK_BOX ints, rounded up to 128 bytes
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// the TPU kernel floors its running max at -1e30/2: a row whose keys are
// all masked keeps max = -inf here and reports this floor in its lse
constexpr float kMaskedRowMax = -5e29f;

template <int D>
struct Smem {
  static constexpr int CH = D / 64;                // 64-column boxes of a row
  static constexpr int STAGES = D == 128 ? 2 : 3;  // K/V tiles in flight
  static constexpr int Q_BOX = BQ * 128;           // BQ rows of one 64-column box
  static constexpr int KV_BOX = BK * 128;
  static constexpr int KV_BYTES = CH * KV_BOX;     // a K or a V tile
  static constexpr int Q = 0;
  static constexpr int K = Q + CH * Q_BOX;         // stage s: K at K + 2 s KV_BYTES, V after it
  static constexpr int MASK = K + STAGES * 2 * KV_BYTES;  // stage s: MASK_BOX ints of the mask
  static constexpr int CNT = MASK + STAGES * MASK_SLOT;   // stage s: releases so far
  static constexpr int BAR = CNT + 16;                    // Q, full[STAGES]
  static constexpr int BYTES = BAR + (1 + STAGES) * 8 + ATOM;  // + slack to align
};

struct Params {
  bf16 *out;        // (B, Lq, H, D)
  float *lse;       // (B, H, Lq)
  int B, H, KVH, Lq, Lk, n_qt, causal, q_offset;
  float scale;
};

__host__ __device__ __forceinline__ int key_tiles(int end) { return (end + BK - 1) / BK; }

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_mask, const Params p) {
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
  const int kv_end = p.causal ? min(p.Lk, p.q_offset + min(q0 + BQ, p.Lq)) : p.Lk;
  const int n_tiles = key_tiles(kv_end);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

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
    bar_expect(bar_q, CH * L::Q_BOX);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      tma_load_4d(base + L::Q + c * L::Q_BOX, &map_q, 64 * c, q0, h, b, bar_q);
    for (int t = 0; t < min(STAGES, n_tiles); ++t) load_tile(t);
  }

  // a consumer warpgroup: rows r_wg .. r_wg + 63 of the tile; this thread
  // holds rows row0 and row0 + 8 (h = 0, 1) at columns 8 j + 2 (lane % 4) + {0, 1}
  const int wg = warp / 4;
  const int r_wg = q0 + 64 * wg;
  const int row0 = r_wg + 16 * (warp % 4) + lane / 4;
  const int tq = lane % 4;
  int n_wg = 0;  // the key tiles this warpgroup reads: up to its own diagonal
  if (r_wg < p.Lq)
    n_wg = p.causal ? key_tiles(min(p.Lk, p.q_offset + min(r_wg + 64, p.Lq))) : n_tiles;
  const float c = p.scale * LOG2E;  // scores in log2 units
  float m[2] = {-INFINITY, -INFINITY};  // running max of s c rounded up, per row
  float l[2] = {0.f, 0.f};              // this thread's share of the running sum
  float o[D / 2], sc[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t pa[BK / 16][4];  // P in bf16, wgmma's A fragments

  const uint32_t qa = base + L::Q + wg * 64 * 128;
  bar_wait(bar_q, 0);
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
    wgmma_commit();
    wgmma_wait<0>();  // S of this tile and P V of the last one
    fence_acc(sc);
    fence_acc(o);
    if (t > 0) release(t - 1);

    // a warp's vote: every key of the tile lies before Lk and has mask 1
    const int k0 = t * BK;
    const int *km = s_mask + s * (MASK_SLOT / 4) + ((b * p.Lk + k0) & 3);
    bool all_live = k0 + 4 * lane + 3 < p.Lk;
#pragma unroll
    for (int e = 0; e < 4; ++e) all_live = all_live && km[4 * lane + e] != 0;
    const bool keyed = !__all_sync(0xffffffffu, all_live);
    const bool diag = p.causal && k0 + BK - 1 > p.q_offset + r_wg;
    if (keyed || diag) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * tq + e;
          const bool live = !keyed || (k0 + col < p.Lk && km[col] != 0);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const bool ok = live && (!diag || k0 + col <= p.q_offset + row0 + 8 * hh);
            if (!ok) sc[4 * j + 2 * hh + e] = -INFINITY;
          }
        }
    }

    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // the running max snapped up to a whole number (a power of two): the
      // rescale is exact, and bf16(p) scales exactly with it, so a row's P
      // hardly depends on which tile its keys fell in (left- or right-padded
      // keys, any q_offset)
      const float m_new = fmaxf(m[hh], ceilf(mx * c));
      // nothing live yet: the exponents stay -inf and give 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[hh] = m[hh] == -INFINITY ? 0.f : ldexpf(1.f, static_cast<int>(m[hh] - m_new));
      m[hh] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          sc[i] = exp2_approx(fmaf(sc[i], c, -m_use));
          sum += sc[i];
        }
      l[hh] = l[hh] * alpha[hh] + sum;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[ks][r] = pack_bf16(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);

    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_bf16_rs<D, 1>(o, pa[ks], gmma_desc(vb + ks * 2 * ATOM, L::KV_BOX, ATOM));
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_acc(o);
  // the tiles past this warpgroup's diagonal: released once they have landed
  for (int t = n_wg; t < n_tiles; ++t) {
    if (t > 0) release(t - 1);
    bar_wait(full + 8 * (t % STAGES), (t / STAGES) & 1);
  }
  if (n_tiles > 0) release(n_tiles - 1);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = row0 + 8 * hh;
    if (row >= p.Lq) continue;
    const float l_safe = fmaxf(sum, 1e-30f);
    const float inv = 1.f / l_safe;
    bf16 *dst = p.out + ((static_cast<long long>(b) * p.Lq + row) * p.H + h) * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162 *>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
    if (tq == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Lq + row] =
          fmaxf(m[hh] * LN2, kMaskedRowMax) + logf(l_safe);
  }
}

template <int D>
cudaError_t launch(const CUtensorMap &mq, const CUtensorMap &mk, const CUtensorMap &mv,
                   const CUtensorMap &mm, const Params &p, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D><<<p.n_qt * p.H * p.B, THREADS, bytes, stream>>>(mq, mk, mv, mm, p);
  return cudaGetLastError();
}

}  // namespace

// q (B, Lq, H, D), k/v (B, Lk, KVH, D) bf16 with unit stride along D, the
// given element strides for (batch, position, head) (each a multiple of 8)
// and 16-byte aligned bases; mask (B, Lk) int32, 16-byte aligned; out (B, Lq, H, D) bf16 and
// lse (B, H, Lq) fp32, both contiguous.
extern "C" int flash_attention_fwd_bf16(
    const void *q, const void *k, const void *v, const void *mask, void *out,
    void *lse, int B, int H, int KVH, int Lq, int Lk, int D, int qsb, int qsl,
    int qsh, int ksb, int ksl, int ksh, int vsb, int vsl, int vsh, int causal,
    int q_offset, float scale, void *stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || Lq <= 0 || Lk <= 0 || q_offset < 0 ||
      (D != 64 && D != 128))
    return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mm;
  if (!attention_map(&mq, q, B, Lq, H, D, qsb, qsl, qsh, BQ) ||
      !attention_map(&mk, k, B, Lk, KVH, D, ksb, ksl, ksh, BK) ||
      !attention_map(&mv, v, B, Lk, KVH, D, vsb, vsl, vsh, BK) ||
      !tensor_map_1d(&mm, CU_TENSOR_MAP_DATA_TYPE_INT32, mask, static_cast<long long>(B) * Lk,
                     MASK_BOX))
    return cudaErrorInvalidValue;
  Params p{static_cast<bf16 *>(out), static_cast<float *>(lse), B, H, KVH, Lq, Lk,
           (Lq + BQ - 1) / BQ, causal, q_offset, scale};
  auto st = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64>(mq, mk, mv, mm, p, st) : launch<128>(mq, mk, mv, mm, p, st);
}
