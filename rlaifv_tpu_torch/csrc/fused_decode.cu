// Fused decode for Hopper (sm_90a): one cooperative launch computes a whole
// decode step through every layer of a Llama model with int8 (or
// nibble-packed int4) weights, fused q/k/v and gate/up projections and an
// int8 KV cache. fp32 residual x (B, D) in and out, the fresh k/v of every
// layer out; the caller writes those into the cache.
//
// Replaces: rlaifv_tpu/ops/fused_decode.py:_kernel (launched by
// fused_decode_step's pallas_call), the TPU kernel of every decode step of
// the JAX engine's fused_decode=True path.
//
// What it computes, per layer (the TPU kernel's function; the plain twin is
// ops/fused_decode.py::fused_decode_step_ref):
//   rms: xn = (x * rsqrt(mean(x^2) + eps)) * ln in fp32, no cast; every
//     activation is quantised per row, s = max(max|v|, 1e-20) / 127 and
//     q = clamp(rn(v / s), +-127) with IEEE divisions;
//   qkv: y = (float(x8 . Wqkv) * sx) * s (int4: the per-group products in
//     order, sum_g float(x8 . W_g) * gs[g], times sx); rope on q and k with
//     fp32 cos/sin; the fresh k and v quantised per (kv head, row) -> out;
//   attention per (kv head, row) and its n_rep query heads: the fresh
//     column seeds m, l and acc from the unquantised q, k, v; then the live
//     cache blocks of 128 keys: s = ((float(q8 . k8) * sq) * ks) * scale
//     where mask != 0 and col < cache_index (else -1e30), the online
//     softmax (max floored at -5e29), pv = p * vs quantised per row of the
//     block, acc = acc * corr + float(p8 . v8) * sp; out = acc / max(l,
//     1e-30), quantised per (head, row);
//   o: per head h, float(ao8_h . Wo_h) * sa[h] (int4: times the head's group
//     scale), summed over the heads in order within chunks of 8 heads and
//     the chunks in order, int8 times s, added to x;
//   gate/up as qkv; a = (g * sigmoid(g)) * u quantised per row AND per
//     I-block of bi columns; down: per I-block, (float(a8 . Wd) * sa) * s
//     (int4: group sums in order, times sa), added to x block by block.
// Deliberate difference: the live cache blocks of a (row, kv head) are cut
// into `att_splits` ranges of whole blocks (ops/fused_decode.py:
// fused_attention_plan); each split runs the block recurrence from its own
// running max (split 0 from the fresh column's state, the others from m =
// -1e30, l = 0, acc = 0), and the splits' (m, l, acc) merge in split order:
// M = max m_s, out = (sum acc_s e^(m_s - M)) / max(sum l_s e^(m_s - M),
// 1e-30). A split's first blocks quantise p under its own max, so the
// kernel equals the twin run with the same splits (`fused_decode_step_ref(
// ..., attn_splits=)`), which at one split is the sequential function.
// Integer sums are exact (a contraction split into slices sums its int32
// partials: any order is the same sum); each fp32 multiply and add of these
// formulas is written with __fmul_rn / __fadd_rn in the twin's order. The
// fresh column's dot, the norm's sum of squares and the block softmax sums
// are reduced in another order than the twin's, and expf / sigmoid / rsqrt
// round differently, so after a quantisation step flips the two drift
// apart: the card check holds them to a bound set from readings.
//
// What bounds it on the H100: bytes. Every weight byte is used by the B <= 32
// rows (at most 64 int8 operations a byte, against ~590 at which the tensor
// cores become the limit), and the live cache is read once: 6.6 GB of
// weights a token at 7B int8 (3.3 GB int4), ~2 ms at 3.35 TB/s, plus the
// cache prefix.
//
// What the design does about it: one persistent cooperative grid (two
// CTAs an SM, 8 warps each) walks the layers in 8 phases (rms | qkv |
// attention | o | rms | gate/up | act | down), each a grid-stride loop over
// its items in an order that puts item i < #SMs on a distinct SM (the CTAs
// ranked by %smid at the start), ending at a grid barrier (an
// acquire-release arrival on one counter, the waiters polling a generation
// word with ld.acquire; a wait far longer than any phase traps). The
// residual and the small activations live in device memory (a few MB,
// read with ld.cg across the barriers); the weight and cache streams load
// with an L2 evict-first hint so they do not push those out of L2. A load
// of a partial sum is never behind a branch or a use of the one before it
// (clamped indices, slice counts as template cases), so a phase's loads
// are in flight together: guarded loads cost one L2 round trip each.
// - Row phases: an item is 512 columns of a row (a row over up to 8 CTAs);
//   its parts exchange their sums of squares, then their max |xn|, through
//   a per-row acquire-release count, read in part order.
// - Products (qkv, o, gate/up, down): an item is 128 output columns over a
//   range of the contraction's 128-row chunks: a slice of it for int8 qkv
//   and gate/up (ops/fused_decode.py:fused_product_slices, chosen so the
//   items fill whole waves of the grid; each slice writes its exact int32
//   partial and the consumer phase sums them), one chunk of 8 heads for o,
//   one I-block for down; int4 items take their groups whole, in order. One
//   producer thread streams the weight chunks (128 rows as they lie, int4
//   64 packed rows) by TMA through a 5-stage (int4 8-stage) ring with the
//   activation rows of the same chunk (a TMA box of B rows, zeros past B)
//   and, int4, the group's scale row; four consumer warps (32 columns each)
//   build q^T in registers from the natural tile by 4 x 4 byte transposes
//   (int4: after sign-extending the nibbles) and run mma.sync m16n8k32 s8
//   with the rows as the 8-wide side. Weights do not depend on the step, so
//   each product phase's first ring stages are issued before the grid
//   barrier that precedes it (before the row phase in front of it, for
//   gate/up and the next layer's qkv), their activation boxes after it.
// - Attention: kernel #5's design (csrc/decode_attention_int8.cu): one item
//   a (kv head, row, split); the k/v tiles of its blocks by TMA (128-byte
//   swizzle) and their scales and mask by bulk copies, through a 5-slot
//   mbarrier ring that runs on across the CTA's items, the first slots
//   issued before the barrier that ends the qkv phase. One step a block,
//   software-pipelined: block i's scores (S^T = k8 . q8^T on mma.sync) beside
//   block i - 1's P.V (out^T = v8^T . p8^T, each warp 16 columns over all
//   keys, v8^T built from 16-bit loads), then one warp a real head takes the
//   softmax by shuffles alone: two barriers a block. The fresh column seeds
//   split 0; the last split of a (row, kv head) to finish (an arrival
//   counter, reset for the next layer) merges the splits and quantises the
//   output.
// - The o head-chunk sums and down's I-block outputs go to partial buffers
//   that the next row phase adds to x in order, so every sum follows the
//   twin's order.
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "int8_mma.cuh"

namespace {

using namespace rlaifv;

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int DH = 128;   // head dim
constexpr int TK = 128;   // contraction rows of a chunk: one int4 group, one head
constexpr int TN = 128;   // output columns of a product item
constexpr int CW = 4;     // consumer warps of a product phase, 32 columns each
constexpr int PRODUCER = CW * 32;  // the thread that issues a product phase's loads
constexpr int MAXB = 32;  // rows: the 8-wide mma side, four times
constexpr int BL = 128;   // cache key block
constexpr int HP = 8;     // heads an attention product holds: n_rep padded to 8
constexpr int RING = 106496;               // dynamic shared memory past the alignment slack
constexpr int SMEM_BYTES = RING + 1024;    // + the slack: two CTAs an SM
constexpr int MAXP = 8;   // partial sums a row phase may add: I-blocks, or o's head chunks
constexpr int MAXS = 8;   // product ring stages at most
constexpr int MAXSM = 1024;  // SM ids the grid's ordering counts (%smid below it)
constexpr int MAXSL = 8;  // int8 contraction slices at most
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -5e29f;  // NEG_INF / 2: the twin's floor of the running max
constexpr unsigned FULL = 0xffffffffu;

enum { QKV, O, GU, DOWN };

// The product ring: STAGES stages of [weight chunk | activation box], then
// STAGES extras of [int4 group scales (512 B) | o's activation scales (128 B)]
template <bool W4>
struct PGeo {
  static constexpr int WROWS = W4 ? TK / 2 : TK;  // byte rows of a weight chunk
  static constexpr int WBYTES = WROWS * TN;
  static constexpr int ABYTES = MAXB * TK;
  static constexpr int STAGE = WBYTES + ABYTES;  // a multiple of 1024: swizzled boxes
  static constexpr int EXTRA = 640;
  static constexpr int STAGES = RING / (STAGE + EXTRA) < MAXS ? RING / (STAGE + EXTRA) : MAXS;
  static_assert(STAGE % 1024 == 0 && STAGES >= 3, "ring");
};

// The attention ring: slots of one key block's k (with its scales and mask)
// or v rows, then the output rows of a split that needs no merge
struct AGeo {
  static constexpr int DATA = BL * DH;
  static constexpr int SLOT = (DATA + 12 * BL + 1023) / 1024 * 1024;
  static constexpr int STAGES = 5;
  static constexpr int OUT = STAGES * SLOT;
  static constexpr int P_PITCH = BL + 16;  // p8 rows: 8 rows on 32 banks
  static_assert(OUT + HP * DH * 4 <= RING, "attention ring");
  static_assert(BL == 16 * NWARPS && DH == 16 * NWARPS, "a warp's 16 keys, 16 columns");
};

// the TMA maps: weights as (n_layers x byte rows, N) read in boxes of 128
// columns x one chunk's rows; the activations as (B, K) read in boxes of 128
// columns x 8 MT rows; the cache as (n KVH B L, DH) read a key block a box.
// All 128-byte swizzled.
struct Maps {
  CUtensorMap wqkv, wo, wgu, wdown, x8, ao8, a8, kc, vc;
};

struct Args {
  const float *cossin;  // (2, B, DH)
  const int *mask;      // (B, L)
  const float *ln;      // (n, 2, D)
  const float *sqkv;    // int8 (n, 1, Nq); int4 (n, D / 128, Nq)
  const float *ksc;     // (n, KVH, B, L)
  const float *vsc;
  const float *so;      // int8 (n, 1, D); int4 (n, H, D)
  const float *sgu;
  const float *sdown;
  float *x;      // (B, D): x in on entry, x out on exit
  int8_t *nk;    // (n, KVH, B, DH)
  float *nks;    // (n, KVH, B)
  int8_t *nv;
  float *nvs;
  float *xs;     // (B,) the quantised rows' scales (x8 is behind its map)
  void *pqkv;    // int8: int32 (qkv_slices, B, Nq) partials; int4: fp32 (B, Nq)
  float *aos;    // (H, 32): the attention output's scale of (head, row)
  void *pgu;     // as pqkv over 2 Ip columns
  float *sa;     // (B, Ip / bi)
  float *po;     // (ceil(H / 8), B, D): o's head-chunk sums
  float *pdown;  // (nI, B, D): down's I-block outputs
  float *patt;   // (B, H, att_splits, DH + 4): a split's acc, m and l (16-byte rows)
  unsigned *cnt; // (B, KVH) arrivals of a (row, kv head)'s splits, (B,) of a row's parts,
                 // the barrier's 2 words, then (MAXSM) CTAs an SM id and (2) a rank; 0 on entry
  float *rowp;   // (2, B, 8): a row part's sum of squares, then its max |xn|
  int B, n_layers, D, H, KVH, Ip, bi, L, cache_index, valid_blocks;
  int att_splits, qkv_slices, gu_slices;
  float eps, scale;
  int MT;   // rows in tiles of 8
  int per_sm;  // CTAs an SM holds: 1 or 2
  int REP;  // query heads a kv head serves: 1, 2, 4 or 8
  int8_t *x8, *ao8, *a8;  // (B, D), (B, H DH), (B, Ip): written here, read by their maps
};

// this CTA's place in every phase's item order: the first CTA on each SM
// takes places [0, sms), the second [sms, 2 sms), so a phase with fewer items
// than CTAs spreads them over distinct SMs (set at the kernel's start)
__shared__ int s_vid;

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

__device__ __forceinline__ int8_t quant127(float v, float s) {
  return static_cast<int8_t>(max(-127, min(127, __float2int_rn(__fdiv_rn(v, s)))));
}

__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-20f), 127.0f);
}

// every thread gets the same value: the warps' partials summed in warp order
__device__ float block_reduce(float v, float *red, bool is_max) {
  v = is_max ? warp_max(v) : warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < NWARPS; ++w) t = is_max ? fmaxf(t, red[w]) : __fadd_rn(t, red[w]);
  __syncthreads();
  return t;
}

// bytes from global memory into shared memory by the bulk-copy engine,
// counted on the barrier; 16-byte aligned, a multiple of 16 bytes
__device__ __forceinline__ void bulk_load(uint32_t dst, const void *src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A 2D TMA load of data read once (weights, the cache): L2 evicts it first,
// so the stream does not push out the activations and partial sums that
// the next phase reads
__device__ __forceinline__ void tma_load_stream(uint32_t dst, const CUtensorMap *map, int c0,
                                                int c1, uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 pol;\ncreatepolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%3, %4}], [%2], pol;\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// this thread's generic writes to global memory, ordered before TMA reads
// of them (by any CTA, after the next grid barrier)
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// the sums of n (1 to MAXSL) int32 partials `stride` apart of 4 neighbouring
// values at p (16-byte aligned), every load in flight at once (a load behind
// a branch or a use waits for the one before it)
template <int N>
__device__ __forceinline__ void sum4_n(const int *p, long long stride, int (&s)[4]) {
  int4 v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = __ldcg(reinterpret_cast<const int4 *>(p + k * stride));
  s[0] = v[0].x;
  s[1] = v[0].y;
  s[2] = v[0].z;
  s[3] = v[0].w;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    s[0] += v[k].x;
    s[1] += v[k].y;
    s[2] += v[k].z;
    s[3] += v[k].w;
  }
}

// a product phase's output at 4 neighbouring columns [col, col + 4) of row
// b: int8 (float(the n slices' int32 sum) * sx) * s; int4 the phase's fp32
// output (part: its buffer, plane: a slice's size, idx: row b col col)
template <bool W4>
__device__ __forceinline__ void proj4(const void *part, long long plane, long long idx, int n,
                                      float sx, const float *s, float (&out)[4]) {
  if constexpr (W4) {
    const float4 v = __ldcg(reinterpret_cast<const float4 *>(part) + idx / 4);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    const int *p = reinterpret_cast<const int *>(part) + idx;
    int sum[4];
    switch (n) {
      case 1: sum4_n<1>(p, plane, sum); break;
      case 2: sum4_n<2>(p, plane, sum); break;
      case 3: sum4_n<3>(p, plane, sum); break;
      case 4: sum4_n<4>(p, plane, sum); break;
      case 5: sum4_n<5>(p, plane, sum); break;
      case 6: sum4_n<6>(p, plane, sum); break;
      case 7: sum4_n<7>(p, plane, sum); break;
      default: sum4_n<8>(p, plane, sum); break;
    }
    const float4 sc = __ldg(reinterpret_cast<const float4 *>(s));
    const float c[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] = __fmul_rn(__fmul_rn(__int2float_rn(sum[q]), sx), c[q]);
  }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned *p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The grid-wide barrier of a cooperative launch (every CTA resident): an
// acquire-release arrival on the count; the last CTA to arrive resets it
// and releases the generation word the others poll with ld.acquire. A wait
// far longer than any phase traps instead of hanging.
__device__ void grid_sync(unsigned *bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned g, old;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(g) : "l"(bar + 1) : "memory");
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(bar)
                 : "memory");
    if (old == gridDim.x - 1) {
      asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(bar), "r"(0u) : "memory");
      asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(bar + 1), "r"(g + 1)
                   : "memory");
    } else {
      const long long t0 = clock64();
      while (ld_acquire(bar + 1) == g)
        if (clock64() - t0 > SPIN_CYCLES) __trap();
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------- rms

// What a row phase adds to x first: nothing, the down product's I-block
// outputs in block order (x = ((x + y_0) + y_1) + ...), or the o
// projection's head-chunk sums in chunk order (int8: times its column
// scales) added to x
enum { PEND_NONE, PEND_DOWN, PEND_O };

template <bool W4, int PEND>
__device__ __forceinline__ float pending(const Args &a, int b, int c, const float *sc) {
  const long long bd = (long long)a.B * a.D, i = (long long)b * a.D + c;
  float x = __ldcg(a.x + i);
  if constexpr (PEND == PEND_NONE) return x;
  const int n = PEND == PEND_DOWN ? a.Ip / a.bi : (a.H + 7) / 8;
  // every partial's load in flight at once: unconditional loads (a guarded
  // load waits for the one before it), the index clamped to the last
  float y[MAXP];
#pragma unroll
  for (int k = 0; k < MAXP; ++k)
    y[k] = __ldcg((PEND == PEND_DOWN ? a.pdown : a.po) + min(k, n - 1) * bd + i);
  if constexpr (PEND == PEND_DOWN) {
#pragma unroll
    for (int k = 0; k < MAXP; ++k)
      if (k < n) x = __fadd_rn(x, y[k]);
    return x;
  }
  float t = y[0];
#pragma unroll
  for (int k = 1; k < MAXP; ++k)
    if (k < n) t = __fadd_rn(t, y[k]);
  return __fadd_rn(x, W4 ? t : __fmul_rn(t, __ldg(sc + c)));
}

constexpr int RW = 2 * NTHREADS;  // row columns an item of a row phase covers

// until the count at c reaches n (thread 0 polls with ld.acquire; a wait
// far longer than any phase traps), then every thread of the CTA
__device__ void wait_count(const unsigned *c, unsigned n) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    while (ld_acquire(c) < n)
      if (clock64() - t0 > SPIN_CYCLES) __trap();
  }
  __syncthreads();
}

__device__ __forceinline__ void arrive_count(unsigned *c) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(c) : "memory");
}

// item (row b, part p): columns [p RW, p RW + RW) of row b get their
// pending sums, then xn = (x * r) * ln, r = rsqrt(mean(x^2) + eps) over the
// whole row, quantised with the row's scale into x8 (ln null: the update
// only). A row's P parts exchange their sums of squares, then their max
// |xn|, through rowp, read in part order, each exchange after an
// acquire-release count on rcnt[b] that reaches P more (epoch: the row
// phases with ln before this one). Every CTA holds at most one item (B P
// <= the grid), so no part waits on its own CTA.
template <bool W4, int PEND>
__device__ void phase_rms(const Args &a, const float *ln, const float *sc, float *red,
                          int epoch) {
  const int D = a.D, P = (D + RW - 1) / RW, tid = threadIdx.x;
  for (int it = s_vid; it < a.B * P; it += gridDim.x) {
    const int b = it / P, p = it % P;
    float *xr = a.x + (long long)b * D;
    int c[2];
    float v[2], lv[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // every load in flight at once: the columns clamped
      c[k] = p * RW + tid + k * NTHREADS;
      const int cc = min(c[k], D - 1);
      v[k] = pending<W4, PEND>(a, b, cc, sc);
      lv[k] = ln ? __ldg(ln + cc) : 0.f;
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (c[k] >= D) continue;
      if constexpr (PEND != PEND_NONE) xr[c[k]] = v[k];
      ss = __fadd_rn(ss, __fmul_rn(v[k], v[k]));
    }
    if (!ln) continue;
    float *ssp = a.rowp + b * 8, *amp = a.rowp + (a.B + b) * 8;
    unsigned *rc = a.cnt + a.B * a.KVH + b;
    ss = block_reduce(ss, red, false);
    if (tid == 0) {
      ssp[p] = ss;
      arrive_count(rc);
    }
    wait_count(rc, (2 * epoch + 1) * P);
    float tot = 0.f;
    for (int q = 0; q < P; ++q) tot = __fadd_rn(tot, __ldcg(ssp + q));
    const float r = __frsqrt_rn(__fadd_rn(__fdiv_rn(tot, static_cast<float>(D)), a.eps));
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      v[k] = __fmul_rn(__fmul_rn(v[k], r), lv[k]);
      if (c[k] < D) amax = fmaxf(amax, fabsf(v[k]));
    }
    amax = block_reduce(amax, red, true);
    if (tid == 0) {
      amp[p] = amax;
      arrive_count(rc);
    }
    wait_count(rc, (2 * epoch + 2) * P);
    float mx = 0.f;
    for (int q = 0; q < P; ++q) mx = fmaxf(mx, __ldcg(amp + q));
    const float s = row_scale(mx);
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (c[k] < D) a.x8[(long long)b * D + c[k]] = quant127(v[k], s);
    if (tid == 0 && p == 0) a.xs[b] = s;
  }
  fence_proxy_global();  // x8 is read by TMA after the barrier
}

// ---------------------------------------------------------------- products

// The phase's shape: N output columns, K contraction rows, the parts of the
// contraction an item covers
template <int MODE>
__device__ __forceinline__ void pshape(const Args &a, int &N, int &K, int &nparts) {
  if constexpr (MODE == QKV) {
    N = (a.H + 2 * a.KVH) * DH;
    K = a.D;
    nparts = a.qkv_slices;
  } else if constexpr (MODE == GU) {
    N = 2 * a.Ip;
    K = a.D;
    nparts = a.gu_slices;
  } else if constexpr (MODE == O) {
    N = a.D;
    K = a.H * DH;
    nparts = (a.H + 7) / 8;
  } else {
    N = a.D;
    K = a.Ip;
    nparts = a.Ip / a.bi;
  }
}

// item it -> its column tile and the range [c0, c1) of 128-row chunks:
// a slice of the whole contraction (qkv, gate/up), a chunk of 8 heads (o),
// an I-block (down)
template <int MODE>
__device__ __forceinline__ void item_range(const Args &a, int it, int N, int K, int &tile,
                                           int &part, int &c0, int &c1) {
  const int ntiles = N / TN;
  tile = it % ntiles;
  part = it / ntiles;
  if constexpr (MODE == O) {
    c0 = 8 * part;
    c1 = min(a.H, c0 + 8);
  } else if constexpr (MODE == DOWN) {
    c0 = part * (a.bi / TK);
    c1 = c0 + a.bi / TK;
  } else {
    const int C = K / TK, S = MODE == QKV ? a.qkv_slices : a.gu_slices;
    c0 = part * C / S;
    c1 = (part + 1) * C / S;
  }
}

// the chunks this CTA takes in phase MODE
template <int MODE>
__device__ int my_chunks(const Args &a) {
  int N, K, nparts, n = 0;
  pshape<MODE>(a, N, K, nparts);
  for (int it = s_vid; it < N / TN * nparts; it += gridDim.x) {
    int tile, part, c0, c1;
    item_range<MODE>(a, it, N, K, tile, part, c0, c1);
    n += c1 - c0;
  }
  return n;
}

enum { LOAD_W = 1, LOAD_A = 2 };

// The producer's place in phase MODE's chunks of this CTA: chunk c of item
// it (whose range ends at c1), the phase's n-th
struct PCursor {
  int it, c, c1, n;
};

template <int MODE>
__device__ __forceinline__ PCursor pcursor_start(const Args &a) {
  int N, K, nparts, tile, part;
  pshape<MODE>(a, N, K, nparts);
  PCursor cur{s_vid, 0, 0, 0};
  if (cur.it < N / TN * nparts) item_range<MODE>(a, cur.it, N, K, tile, part, cur.c, cur.c1);
  return cur;
}

// The producer: the loads of this CTA's share of phase MODE from the
// cursor's chunk up to (not including) the phase's n1-th, chunk n in stage
// (pbase + n) % STAGES: LOAD_W the weight rows (and int4's group scales),
// announcing the whole stage's bytes, after the stage's previous use is
// released; LOAD_A the activation box (and o's activation scales)
template <bool W4, int MODE>
__device__ void issue_chunks(const Maps &mp, const Args &a, int layer, uint32_t ring,
                             uint32_t full, uint32_t empty, int pbase, PCursor &cur, int n1,
                             int what) {
  using G = PGeo<W4>;
  int N, K, nparts;
  pshape<MODE>(a, N, K, nparts);
  const int items = N / TN * nparts;
  const CUtensorMap *wm = MODE == QKV ? &mp.wqkv : MODE == O ? &mp.wo : MODE == GU ? &mp.wgu
                                                                                    : &mp.wdown;
  const CUtensorMap *am = MODE == O ? &mp.ao8 : MODE == DOWN ? &mp.a8 : &mp.x8;
  const float *gs = MODE == QKV ? a.sqkv : MODE == O ? a.so : MODE == GU ? a.sgu : a.sdown;
  const int bytes = G::WBYTES + 8 * a.MT * TK + (W4 ? 512 : 0) + (MODE == O ? 128 : 0);
  while (cur.n < n1 && cur.it < items) {
    const int tile = cur.it % (N / TN), c = cur.c;
    const int u = pbase + cur.n, st = u % G::STAGES;
    const uint32_t dst = ring + st * G::STAGE, fb = full + 8 * st;
    const uint32_t ext = ring + G::STAGES * G::STAGE + st * G::EXTRA;
    if (what & LOAD_W) {
      if (u >= G::STAGES) bar_wait(empty + 8 * st, (u / G::STAGES - 1) & 1);
      bar_expect(fb, bytes);
      tma_load_stream(dst, wm, tile * TN, (layer * (K / TK) + c) * G::WROWS, fb);
      if constexpr (W4)
        bulk_load(ext, gs + ((long long)layer * (K / TK) + c) * N + tile * TN, 512, fb);
    }
    if (what & LOAD_A) {
      tma_load(dst + G::WBYTES, am, c * TK, 0, fb);
      if constexpr (MODE == O) bulk_load(ext + 512, a.aos + c * 32, 128, fb);
    }
    ++cur.n;
    if (++cur.c == cur.c1) {
      cur.it += gridDim.x;
      int tl, part;
      if (cur.it < items) item_range<MODE>(a, cur.it, N, K, tl, part, cur.c, cur.c1);
    }
  }
}

// A rows' product side: B fragments of rows 8 j + g from the swizzled
// activation box, K step ks; d[u][j] += A[u] . B
__device__ __forceinline__ void mma_rows(int (&d)[2][4][4], const uint32_t (&A)[2][4],
                                         const int8_t *xs, int ks, int MT, int g, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= MT) break;
    const int8_t *xr = xs + (8 * j + g) * 128 + 4 * t;
    const uint32_t b[2] = {ld32(xr + (((2 * ks) ^ g) << 4)), ld32(xr + (((2 * ks + 1) ^ g) << 4))};
    mma_s8(d[0][j], A[0], b);
    mma_s8(d[1][j], A[1], b);
  }
}

// w (4 K rows x 4 columns, a row a register) -> A[u] registers 2 h, 2 h + 1:
// rows g, g + 8 of tile u are columns qcol + 2 u, qcol + 2 u + 1
__device__ __forceinline__ void to_a(const uint32_t (&w)[4], uint32_t (&A)[2][4], int h) {
  uint32_t o[4];
  transpose4x4(w, o);  // o[j] byte r: row k0 + r, column qcol + j
  A[0][2 * h] = o[0];
  A[0][2 * h + 1] = o[1];
  A[1][2 * h] = o[2];
  A[1][2 * h + 1] = o[3];
}

// One chunk for this warp's 32 columns (qcol = 32 warp + 4 g: a thread's
// four neighbouring columns are rows g, g + 8 of two m16 tiles): q^T built
// from the natural 128-byte-swizzled tile by four 32-bit loads (4 K rows x
// 4 columns) and a 4 x 4 byte transpose a K group; int4 byte row r holds
// K row r (low nibble) and 64 + r (high)
template <bool W4>
__device__ __forceinline__ void chunk_mma(int (&d)[2][4][4], const int8_t *ws, const int8_t *xs,
                                          int MT, int qchunk, int qbyte, int g, int t) {
  const auto row = [&](int k) { return ld32(ws + k * 128 + (((qchunk ^ (k & 7)) << 4) | qbyte)); };
  if constexpr (!W4) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t A[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) w[r] = row(32 * ks + 16 * h + 4 * t + r);
        to_a(w, A, h);
      }
      mma_rows(d, A, xs, ks, MT, g, t);
    }
  } else {
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      uint32_t w[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 4; ++r) w[h][r] = row(32 * kp + 16 * h + 4 * t + r);
      // the low nibbles are K step kp, the high ones K step kp + 2
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        uint32_t A[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) v[r] = hi ? hi_nibbles(w[h][r]) : lo_nibbles(w[h][r]);
          to_a(v, A, h);
        }
        mma_rows(d, A, xs, kp + 2 * hi, MT, g, t);
      }
    }
  }
}

// A product phase, consumer side (warps 0 .. CW - 1): the CTA's items in
// turn, each chunk awaited in its stage and released after its products.
// d[u][j][e]: column tile * TN + qcol + 2 u + (e >> 1), row 8 j + 2 t + (e & 1)
template <bool W4, int MODE>
__device__ void consume(const Args &a, int layer, unsigned char *ring, uint32_t full,
                        uint32_t empty, int pbase) {
  using G = PGeo<W4>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int qcol = 32 * warp + 4 * g, qchunk = qcol >> 4, qbyte = qcol & 15;
  const int B = a.B, MT = a.MT;
  int N, K, nparts, n = 0;
  pshape<MODE>(a, N, K, nparts);
  const long long bn = (long long)B * N;
  // int32 sums over the item: int8 qkv, gate/up and down; fp32 group (or
  // head) sums else
  constexpr bool INT = !W4 && MODE != O;
  for (int it = s_vid; it < N / TN * nparts; it += gridDim.x) {
    int tile, part, c0, c1;
    item_range<MODE>(a, it, N, K, tile, part, c0, c1);
    int d[2][4][4];
    float f[2][4][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          d[u][j][e] = 0;
          f[u][j][e] = 0.f;
        }
    for (int c = c0; c < c1; ++c, ++n) {
      const int u0 = pbase + n, st = u0 % G::STAGES;
      bar_wait(full + 8 * st, (u0 / G::STAGES) & 1);
      const int8_t *ws = reinterpret_cast<const int8_t *>(ring + st * G::STAGE);
      const float *ext =
          reinterpret_cast<const float *>(ring + G::STAGES * G::STAGE + st * G::EXTRA);
      if constexpr (!INT) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) d[u][j][e] = 0;
      }
      chunk_mma<W4>(d, ws, ws + G::WBYTES, MT, qchunk, qbyte, g, t);
      if constexpr (!INT) {
        // this chunk's fp32 term: int4 times the group's column scale; o
        // times the (head, row) activation scale first
        float cs[4] = {1.f, 1.f, 1.f, 1.f};
        if constexpr (W4) {
          const float4 v = *reinterpret_cast<const float4 *>(ext + qcol);
          cs[0] = v.x;
          cs[1] = v.y;
          cs[2] = v.z;
          cs[3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j >= MT) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ra = MODE == O ? ext[128 + 8 * j + 2 * t + e] : 1.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int uu = q >> 1, ee = 2 * (q & 1) + e;
              float v = __int2float_rn(d[uu][j][ee]);
              if constexpr (MODE == O) v = __fmul_rn(v, ra);
              if constexpr (W4) v = __fmul_rn(v, cs[q]);
              f[uu][j][ee] = c == c0 ? v : __fadd_rn(f[uu][j][ee], v);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty + 8 * st);
    }
    // the item's outputs: 4 neighbouring columns of a row a store
    const int col = tile * TN + qcol;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= MT) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 8 * j + 2 * t + e;
        if (row >= B) continue;
        if constexpr (INT && MODE == DOWN) {  // (float(sum) * sa) * s of the I-block
          const float r = __ldcg(a.sa + row * (a.Ip / a.bi) + part);
          const float *s = a.sdown + (long long)layer * N + col;
          const int v[4] = {d[0][j][e], d[0][j][2 + e], d[1][j][e], d[1][j][2 + e]};
          float y[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) y[q] = __fmul_rn(__fmul_rn(__int2float_rn(v[q]), r), __ldg(s + q));
          *reinterpret_cast<float4 *>(a.pdown + part * bn + (long long)row * N + col) =
              make_float4(y[0], y[1], y[2], y[3]);
        } else if constexpr (INT) {
          int *p = reinterpret_cast<int *>(MODE == QKV ? a.pqkv : a.pgu);
          *reinterpret_cast<int4 *>(p + part * bn + (long long)row * N + col) =
              make_int4(d[0][j][e], d[0][j][2 + e], d[1][j][e], d[1][j][2 + e]);
        } else {
          float y[4] = {f[0][j][e], f[0][j][2 + e], f[1][j][e], f[1][j][2 + e]};
          float *p;
          if constexpr (MODE == O) {
            p = a.po + part * bn;
          } else if constexpr (MODE == DOWN) {  // int4: times the block's row scale
            const float r = __ldcg(a.sa + row * (a.Ip / a.bi) + part);
#pragma unroll
            for (int q = 0; q < 4; ++q) y[q] = __fmul_rn(y[q], r);
            p = a.pdown + part * bn;
          } else {  // int4 qkv, gate/up: times the row scale
            const float r = __ldcg(a.xs + row);
#pragma unroll
            for (int q = 0; q < 4; ++q) y[q] = __fmul_rn(y[q], r);
            p = reinterpret_cast<float *>(MODE == QKV ? a.pqkv : a.pgu);
          }
          *reinterpret_cast<float4 *>(p + (long long)row * N + col) =
              make_float4(y[0], y[1], y[2], y[3]);
        }
      }
    }
  }
}

// A product phase: the producer finishes the loads (the activation boxes of
// the stages issued before the barrier, then whole stages), the consumer
// warps take the chunks. -> the phase's chunks of this CTA.
template <bool W4, int MODE>
__device__ int phase_product(const Maps &mp, const Args &a, int layer, unsigned char *ring,
                             uint32_t full, uint32_t empty, int pbase, int pre) {
  if (threadIdx.x == PRODUCER) {
    const uint32_t rs = saddr(ring);
    fence_proxy_global();  // the activations were written before the barrier
    PCursor cur = pcursor_start<MODE>(a);
    issue_chunks<W4, MODE>(mp, a, layer, rs, full, empty, pbase, cur, pre, LOAD_A);
    issue_chunks<W4, MODE>(mp, a, layer, rs, full, empty, pbase, cur, 1 << 30,
                           LOAD_W | LOAD_A);
  } else if (threadIdx.x < CW * 32) {
    consume<W4, MODE>(a, layer, ring, full, empty, pbase);
  }
  return my_chunks<MODE>(a);
}

// the weights (and int4 group scales) of phase MODE's first ring stages,
// issued ahead of the barriers before the phase -> the stages issued
template <bool W4, int MODE>
__device__ int prefetch(const Maps &mp, const Args &a, int layer, unsigned char *ring,
                        uint32_t full, uint32_t empty, int pbase) {
  PCursor cur = pcursor_start<MODE>(a);
  issue_chunks<W4, MODE>(mp, a, layer, saddr(ring), full, empty, pbase, cur, PGeo<W4>::STAGES,
                         LOAD_W);
  return cur.n;
}

// ---------------------------------------------------------------- attention

// byte offset of row r's 16-byte chunk c in a slot (TMA's 128-byte swizzle)
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// a k slot's score of (key, head h) once its rows are read: float h of row
// key at position (h + key) % 32, so that 32 consecutive keys of one head
// fall on 32 banks
__device__ __forceinline__ float &score_at(unsigned char *slot, int key, int h) {
  return *reinterpret_cast<float *>(slot + key * DH + 4 * ((h + key) % (DH / 4)));
}

struct AttnItem {
  int g, b, split, j0, j1;
};

__device__ __forceinline__ AttnItem attn_item(const Args &a, int it) {
  AttnItem r;
  const int S = a.att_splits;
  r.split = it % S;
  r.b = (it / S) % a.B;
  r.g = it / S / a.B;
  r.j0 = r.split * a.valid_blocks / S;
  r.j1 = (r.split + 1) * a.valid_blocks / S;
  return r;
}

// the next attention tile thread 0 loads: tile i of item it, the phase's n-th
struct ACursor {
  int it, i, n;
};

// thread 0: the loads of this CTA's attention tiles up to (not including)
// the phase's n_end-th, in order (tile 2 i of an item the k rows of its
// block j0 + i with the block's scales and mask, 2 i + 1 the v rows), tile n
// in slot (abase + n) % STAGES
__device__ void attn_issue(const Maps &mp, const Args &a, int layer, unsigned char *ring,
                           uint64_t *afull, int abase, ACursor &cur, int n_end) {
  while (cur.n < n_end && cur.it < a.KVH * a.B * a.att_splits) {
    const AttnItem w = attn_item(a, cur.it);
    if (cur.i >= 2 * (w.j1 - w.j0)) {
      cur.it += gridDim.x;
      cur.i = 0;
      continue;
    }
    const long long kvrow = ((long long)layer * a.KVH + w.g) * a.B + w.b;
    const int i = cur.i++, n = cur.n++;
    {
      const int u = abase + n, st = u % AGeo::STAGES;
      const uint32_t dst = saddr(ring + st * AGeo::SLOT), bar = saddr(&afull[st]);
      const long long p = kvrow * a.L + (w.j0 + i / 2) * BL;
      if (i & 1) {
        bar_expect(bar, AGeo::DATA);
        tma_load_stream(dst, &mp.vc, 0, static_cast<int>(p), bar);
      } else {
        bar_expect(bar, AGeo::DATA + 3 * BL * 4);
        tma_load_stream(dst, &mp.kc, 0, static_cast<int>(p), bar);
        bulk_load(dst + AGeo::DATA, a.ksc + p, BL * 4, bar);
        bulk_load(dst + AGeo::DATA + BL * 4, a.vsc + p, BL * 4, bar);
        bulk_load(dst + AGeo::DATA + 2 * BL * 4,
                  a.mask + (long long)w.b * a.L + (w.j0 + i / 2) * BL, BL * 4, bar);
      }
    }
  }
}

// the tiles this CTA takes in the attention phase
__device__ int my_tiles(const Args &a) {
  int n = 0;
  for (int it = s_vid; it < a.KVH * a.B * a.att_splits; it += gridDim.x) {
    const AttnItem w = attn_item(a, it);
    n += 2 * (w.j1 - w.j0);
  }
  return n;
}

struct AttnSmem {
  __align__(16) int8_t p8[HP][AGeo::P_PITCH];
  __align__(16) int8_t q8[HP][DH];
  __align__(16) float kf[DH];  // the fresh k (roped), fp32
  __align__(16) float vf[DH];  // ... and v
  float sq[HP];
  // the softmax state of each head (its warp's lane 0 writes it): running
  // max and sum, the last block's rescale and p scale
  float m[HP], l[HP], corr[HP], sp[HP];
  int last;
};

// the merged (or only) output of head h at row b: lane owns dims 4 lane +
// i; quantised per (head, row) -> ao8, aos
__device__ __forceinline__ void attn_out(const Args &a, const float (&o)[4], int h, int b,
                                         int lane) {
  const float s = row_scale(warp_max(fmaxf(fmaxf(fabsf(o[0]), fabsf(o[1])),
                                           fmaxf(fabsf(o[2]), fabsf(o[3])))));
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) w |= (static_cast<uint32_t>(quant127(o[i], s)) & 0xffu) << (8 * i);
  *reinterpret_cast<uint32_t *>(a.ao8 + (long long)b * a.H * DH + h * DH + lane * 4) = w;
  if (lane == 0) a.aos[h * 32 + b] = s;
}

// The attention phase: this CTA's (kv head g, row b, split) items in turn,
// the tiles streaming through the ring across them (module comment)
template <bool W4>
__device__ void phase_attention(const Maps &mp, const Args &a, int layer, unsigned char *ring,
                                uint64_t *afull, AttnSmem &sm, int abase, ACursor &cur) {
  using G = AGeo;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, t = lane % 4;
  const int B = a.B, H = a.H, S = a.att_splits, REP = a.REP;
  const float *sqkv = a.sqkv + (long long)layer * (W4 ? 0 : (a.H + 2 * a.KVH) * DH);
  // P.V: this warp's 16 columns of DH, all of a block's keys; this
  // thread's two neighbouring columns (rows gq, gq + 8 of the product)
  const int pcol = 16 * warp + 2 * gq, pchunk = pcol >> 4, pbyte = pcol & 15;
  int tbase = 0;  // this phase's tiles before the item's
  for (int it = s_vid; it < a.KVH * B * S; it += gridDim.x) {
    const AttnItem w = attn_item(a, it);
    const int g = w.g, b = w.b;
    const long long kvrow = ((long long)layer * a.KVH + g) * B + b;
    const float *cosr = a.cossin + b * DH, *sinr = a.cossin + (B + b) * DH;

    // rope: x cos + rotate_half(x) sin, the partner of dim d (d ^ 64) in
    // lane ^ 16; lane owns dims 4 lane + i
    const int Nq = (H + 2 * a.KVH) * DH;
    const float sxb = W4 ? 1.f : __ldcg(a.xs + b);
    auto head_values = [&](int col0, bool roped, float (&v)[4]) {
      const int col = col0 + lane * 4;
      proj4<W4>(a.pqkv, (long long)B * Nq, (long long)b * Nq + col, a.qkv_slices, sxb, sqkv + col,
                v);
      if (roped) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = lane * 4 + i;
          const float partner = __shfl_xor_sync(FULL, v[i], 16);
          const float rh = d < DH / 2 ? -partner : partner;
          v[i] = __fadd_rn(__fmul_rn(v[i], __ldg(cosr + d)), __fmul_rn(rh, __ldg(sinr + d)));
        }
      }
    };
    // tasks, one warp each: the REP query heads g REP + r, roped and
    // quantised per (head, row), kept in fp32 for the fresh column (in the
    // output rows' place); split 0 also the fresh k (roped) and v, out
    // quantised per (kv head, row), kept in fp32
    float *qf = reinterpret_cast<float *>(ring + G::OUT);
    for (int task = warp; task < REP + 2; task += NWARPS) {
      if (task >= REP && w.split != 0) break;
      const int col0 = task < REP ? (g * REP + task) * DH : (H + (task - REP) * a.KVH + g) * DH;
      float v[4];
      head_values(col0, task <= REP, v);
      const float s = row_scale(warp_max(fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                                               fmaxf(fabsf(v[2]), fabsf(v[3])))));
      uint32_t q = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) q |= (static_cast<uint32_t>(quant127(v[i], s)) & 0xffu) << (8 * i);
      float *keep = task < REP ? qf + task * DH : task == REP ? sm.kf : sm.vf;
      *reinterpret_cast<float4 *>(keep + lane * 4) = make_float4(v[0], v[1], v[2], v[3]);
      if (task < REP) {
        *reinterpret_cast<uint32_t *>(&sm.q8[task][lane * 4]) = q;
        if (lane == 0) sm.sq[task] = s;
      } else {
        *reinterpret_cast<uint32_t *>((task == REP ? a.nk : a.nv) + kvrow * DH + lane * 4) = q;
        if (lane == 0) (task == REP ? a.nks : a.nvs)[kvrow] = s;
      }
    }
    // the padded heads' rows zero
    if (warp >= REP) {
      *reinterpret_cast<uint32_t *>(&sm.q8[warp][lane * 4]) = 0u;
      if (lane == 0) sm.sq[warp] = 1.f;
    }
    __syncthreads();
    // split 0's state from the fresh column (m = (q . k) scale, l = 1), the
    // others' empty
    if (warp < REP) {
      float dot = 0.f;
      if (w.split == 0) {
        const float4 qv = *reinterpret_cast<const float4 *>(qf + warp * DH + lane * 4);
        const float4 kv = *reinterpret_cast<const float4 *>(sm.kf + lane * 4);
        dot = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(qv.x, kv.x), __fmul_rn(qv.y, kv.y)),
                                  __fmul_rn(qv.z, kv.z)),
                        __fmul_rn(qv.w, kv.w));
        dot = warp_sum(dot);
      }
      if (lane == 0) {
        sm.m[warp] = w.split == 0 ? __fmul_rn(dot, a.scale) : NEG_INF;
        sm.l[warp] = w.split == 0 ? 1.f : 0.f;
      }
    }
    __syncthreads();
    // the scores' B fragments (q8^T: head gq) and this thread's heads 2 t, 2 t + 1
    uint32_t qb[DH / 32][2];
#pragma unroll
    for (int kk = 0; kk < DH / 32; ++kk) {
      qb[kk][0] = ld32(&sm.q8[gq][32 * kk + 4 * t]);
      qb[kk][1] = ld32(&sm.q8[gq][32 * kk + 16 + 4 * t]);
    }
    const float sqh[2] = {sm.sq[2 * t], sm.sq[2 * t + 1]};
    // acc[e]: column pcol + (e >> 1) of head 2 t + (e & 1); split 0 starts
    // from the fresh v
    float acc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = w.split == 0 ? sm.vf[pcol + (e >> 1)] : 0.f;

    // one step a block, software-pipelined: step i takes block i's scores
    // (its k tile, item tile 2 i) beside block i - 1's P.V (its v tile, 2 i -
    // 1, with the p8 that step i - 1's softmax left); the softmax of block i
    // follows the barrier in the middle
    const int nbk = w.j1 - w.j0;
#pragma unroll 1
    for (int i = 0; i <= nbk; ++i) {
      fence_async_smem();  // this thread's generic accesses to the freed slots precede
      __syncthreads();     // ... the TMA that refills them
      const int lo = tbase + (i ? 2 * i - 1 : 0);  // the oldest tile in use
      if (threadIdx.x == 0) attn_issue(mp, a, layer, ring, afull, abase, cur, lo + G::STAGES);
      unsigned char *kslot = nullptr;
      if (i < nbk) {
        // ---- the block's scores: warp w's keys 16 w + gq (+ 8)
        const int u = abase + tbase + 2 * i;
        bar_wait(saddr(&afull[u % G::STAGES]), (u / G::STAGES) & 1);
        kslot = ring + (u % G::STAGES) * G::SLOT;
        const int t0 = (w.j0 + i) * BL;
        const float *sks = reinterpret_cast<const float *>(kslot + G::DATA);
        const int *smask = reinterpret_cast<const int *>(sks + 2 * BL);
        const int r0 = 16 * warp + gq;
        const int8_t *sl = reinterpret_cast<const int8_t *>(kslot);
        int c[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kk = 0; kk < DH / 32; ++kk) {
          const uint32_t af[4] = {ld32(sl + swz(r0, 2 * kk) + 4 * t),
                                  ld32(sl + swz(r0 + 8, 2 * kk) + 4 * t),
                                  ld32(sl + swz(r0, 2 * kk + 1) + 4 * t),
                                  ld32(sl + swz(r0 + 8, 2 * kk + 1) + 4 * t)};
          mma_s8(c, af, qb[kk]);
        }
        float sc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = r0 + 8 * (e >> 1);
          const float v = __fmul_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(c[e]), sqh[e & 1]), sks[key]), a.scale);
          sc[e] = smask[key] != 0 && t0 + key < a.cache_index ? v : NEG_INF;
        }
        // the real heads' scores into the rows of this warp's own keys
        __syncwarp();
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = 2 * t + (e & 1);
          if (h < REP) score_at(kslot, r0 + 8 * (e >> 1), h) = sc[e];
        }
      }
      if (i > 0) {
        // ---- exact int32 P8 . V8 of block i - 1 over its keys, this warp's
        // columns: A = v8^T built from 16-bit loads (2 columns x 4 keys)
        const int u = abase + tbase + 2 * i - 1;
        bar_wait(saddr(&afull[u % G::STAGES]), (u / G::STAGES) & 1);
        const int8_t *vs = reinterpret_cast<const int8_t *>(ring + (u % G::STAGES) * G::SLOT);
        int c[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kk = 0; kk < BL / 32; ++kk) {
          uint32_t af[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t x[2];
#pragma unroll
            for (int r2 = 0; r2 < 2; ++r2) {
              const int kr = 32 * kk + 16 * h + 4 * t + 2 * r2;
              const uint32_t lo = *reinterpret_cast<const uint16_t *>(vs + swz(kr, pchunk) + pbyte);
              const uint32_t hi =
                  *reinterpret_cast<const uint16_t *>(vs + swz(kr + 1, pchunk) + pbyte);
              x[r2] = lo | (hi << 16);  // keys kr, kr + 1 x columns pcol, pcol + 1
            }
            af[2 * h] = __byte_perm(x[0], x[1], 0x6420);      // column pcol, 4 keys
            af[2 * h + 1] = __byte_perm(x[0], x[1], 0x7531);  // column pcol + 1
          }
          const uint32_t pb[2] = {ld32(&sm.p8[gq][32 * kk + 4 * t]),
                                  ld32(&sm.p8[gq][32 * kk + 16 + 4 * t])};
          mma_s8(c, af, pb);
        }
        // acc = acc * corr + int(p8 . v8) * sp, block i - 1's state
        const float corr[2] = {sm.corr[2 * t], sm.corr[2 * t + 1]};
        const float sp[2] = {sm.sp[2 * t], sm.sp[2 * t + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[e] = __fadd_rn(__fmul_rn(acc[e], corr[e & 1]),
                             __fmul_rn(__int2float_rn(c[e]), sp[e & 1]));
      }
      __syncthreads();  // the scores are parked; p8 and the state are read
      if (i < nbk && warp < REP) {
        // warp h owns real head h over block i's keys (lane + 32 u)
        const int h = warp;
        const float *svs = reinterpret_cast<const float *>(kslot + G::DATA) + BL;
        constexpr int U = BL / 32;
        float sv[U], pv[U], bmax = -INFINITY;
#pragma unroll
        for (int uu = 0; uu < U; ++uu) {
          sv[uu] = score_at(kslot, lane + 32 * uu, h);
          bmax = fmaxf(bmax, sv[uu]);
        }
        const float m_old = sm.m[h];
        const float m_new = fmaxf(m_old, fmaxf(warp_max(bmax), M_FLOOR));
        float psum = 0.f, pmax = 0.f;
#pragma unroll
        for (int uu = 0; uu < U; ++uu) {
          const float p = expf(__fsub_rn(sv[uu], m_new));
          psum = __fadd_rn(psum, p);
          pv[uu] = __fmul_rn(p, svs[lane + 32 * uu]);
          pmax = fmaxf(pmax, fabsf(pv[uu]));
        }
        psum = warp_sum(psum);
        const float sp = row_scale(warp_max(pmax));
#pragma unroll
        for (int uu = 0; uu < U; ++uu) sm.p8[h][lane + 32 * uu] = quant127(pv[uu], sp);
        if (lane == 0) {
          const float corr = expf(__fsub_rn(m_old, m_new));
          sm.l[h] = __fadd_rn(__fmul_rn(sm.l[h], corr), psum);
          sm.m[h] = m_new;
          sm.corr[h] = corr;
          sm.sp[h] = sp;
        }
      }
    }
    tbase += 2 * nbk;
    __syncthreads();  // the last block's softmax state is in

    if (S == 1) {
      // out = acc / max(l, 1e-30) through shared memory, then one warp a head
      float *so = reinterpret_cast<float *>(ring + G::OUT);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 2 * t + hh;
        if (r >= REP) continue;
        const float den = fmaxf(sm.l[r], 1e-30f);
        *reinterpret_cast<float2 *>(so + r * DH + pcol) =
            make_float2(__fdiv_rn(acc[hh], den), __fdiv_rn(acc[2 + hh], den));
      }
      __syncthreads();
      if (warp < REP) {
        const float4 v = *reinterpret_cast<const float4 *>(so + warp * DH + lane * 4);
        const float o[4] = {v.x, v.y, v.z, v.w};
        attn_out(a, o, g * REP + warp, b, lane);
      }
      __syncthreads();  // the output rows are read before the next item's q lands there
    } else {
      // this split's state out; the last split of (b, g) to arrive merges
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 2 * t + hh;
        if (r >= REP) continue;
        float *ps = a.patt + (((long long)b * H + g * REP + r) * S + w.split) * (DH + 4);
        *reinterpret_cast<float2 *>(ps + pcol) = make_float2(acc[hh], acc[2 + hh]);
        if (pcol == 0) {
          ps[DH] = sm.m[r];
          ps[DH + 1] = sm.l[r];
        }
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) {
        unsigned *c = a.cnt + b * a.KVH + g;
        const unsigned prev = atomicAdd(c, 1u);
        sm.last = prev == static_cast<unsigned>(S - 1);
        if (sm.last) {
          atomicExch(c, 0u);  // for the next layer
          __threadfence();
        }
      }
      __syncthreads();
      if (sm.last && warp < REP) {
        const float *p = a.patt + ((long long)b * H + g * REP + warp) * S * (DH + 4);
        float mx = M_FLOOR;
        for (int s = 0; s < S; ++s) mx = fmaxf(mx, __ldcg(p + s * (DH + 4) + DH));
        float num[4] = {0.f, 0.f, 0.f, 0.f}, den = 0.f;
        for (int s = 0; s < S; ++s) {
          const float *ps = p + s * (DH + 4);
          const float wgt = expf(__fsub_rn(__ldcg(ps + DH), mx));
          const float4 v = __ldcg(reinterpret_cast<const float4 *>(ps + lane * 4));
          num[0] = __fadd_rn(num[0], __fmul_rn(v.x, wgt));
          num[1] = __fadd_rn(num[1], __fmul_rn(v.y, wgt));
          num[2] = __fadd_rn(num[2], __fmul_rn(v.z, wgt));
          num[3] = __fadd_rn(num[3], __fmul_rn(v.w, wgt));
          den = __fadd_rn(den, __fmul_rn(__ldcg(ps + DH + 1), wgt));
        }
        const float dd = fmaxf(den, 1e-30f);
        const float o[4] = {__fdiv_rn(num[0], dd), __fdiv_rn(num[1], dd), __fdiv_rn(num[2], dd),
                            __fdiv_rn(num[3], dd)};
        attn_out(a, o, g * REP + warp, b, lane);
      }
    }
  }
  fence_proxy_global();  // ao8 is read by TMA after the barrier
}

// ---------------------------------------------------------------- MLP activation

constexpr int MAXA = 8;  // activation values a thread keeps: bi <= 2048

// item (row b, I-block blk): a = (g * sigmoid(g)) * u over the block's bi
// columns, quantised with one scale for the block
template <bool W4>
__device__ void phase_act(const Args &a, int layer, float *red) {
  const int nI = a.Ip / a.bi;
  const float *sgu = a.sgu + (long long)layer * (W4 ? 0 : 2 * a.Ip);
  for (int it = s_vid; it < a.B * nI; it += gridDim.x) {
    const int b = it / nI, blk = it % nI, c0 = blk * a.bi;
    // a thread's columns: 4 neighbours, then 4 more 4 NTHREADS on
    const long long row = (long long)b * 2 * a.Ip, plane = (long long)a.B * 2 * a.Ip;
    const float sxb = W4 ? 1.f : __ldcg(a.xs + b);
    float v[MAXA];
    float amax = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < MAXA; k0 += 4) {
      const int c = 4 * threadIdx.x + k0 * NTHREADS;
      if (k0 * NTHREADS >= a.bi) break;
      const int cc = c0 + min(c, a.bi - 4);  // loads for every thread: the columns clamped
      float gv[4], uv[4];
      proj4<W4>(a.pgu, plane, row + cc, a.gu_slices, sxb, sgu + cc, gv);
      proj4<W4>(a.pgu, plane, row + a.Ip + cc, a.gu_slices, sxb, sgu + a.Ip + cc, uv);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-gv[q])));
        v[k0 + q] = __fmul_rn(__fmul_rn(gv[q], sig), uv[q]);
        if (c < a.bi) amax = fmaxf(amax, fabsf(v[k0 + q]));
      }
    }
    const float s = row_scale(block_reduce(amax, red, true));
#pragma unroll
    for (int k0 = 0; k0 < MAXA; k0 += 4) {
      const int c = 4 * threadIdx.x + k0 * NTHREADS;
      if (c >= a.bi) break;
      uint32_t w = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w |= (static_cast<uint32_t>(quant127(v[k0 + q], s)) & 0xffu) << (8 * q);
      *reinterpret_cast<uint32_t *>(a.a8 + (long long)b * a.Ip + c0 + c) = w;
    }
    if (threadIdx.x == 0) a.sa[b * nI + blk] = s;
  }
  fence_proxy_global();  // a8 is read by TMA after the barrier
}

// ---------------------------------------------------------------- the kernel

template <bool W4>
__global__ void __launch_bounds__(NTHREADS, 2)
    fused_decode_kernel(const __grid_constant__ Maps mp, const __grid_constant__ Args a) {
  using PG = PGeo<W4>;
  extern __shared__ __align__(1024) unsigned char smem_fd[];
  unsigned char *ring = smem_fd + ((1024 - saddr(smem_fd) % 1024) % 1024);
  __shared__ __align__(8) uint64_t s_full[MAXS], s_empty[MAXS], s_afull[AGeo::STAGES];
  __shared__ float red[NWARPS];
  __shared__ AttnSmem asm_;
  if (threadIdx.x == 0) {
    for (int st = 0; st < PG::STAGES; ++st) {
      bar_init(saddr(&s_full[st]), 1);
      bar_init(saddr(&s_empty[st]), CW);
    }
    for (int st = 0; st < AGeo::STAGES; ++st) bar_init(saddr(&s_afull[st]), 1);
    bar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the CTA's rank on its SM, then its place in that rank
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    unsigned *ranks = a.cnt + a.B * a.KVH + a.B + 2;
    const unsigned r = atomicAdd(ranks + min(smid, MAXSM - 1u), 1u);
    s_vid = r < static_cast<unsigned>(a.per_sm) && smid < MAXSM
                ? static_cast<int>(r * (gridDim.x / a.per_sm) + atomicAdd(ranks + MAXSM + r, 1u))
                : -1;
  }
  __syncthreads();
  if (s_vid < 0) __trap();  // an SM beyond the ordering's reach: never on the cards served
  const uint32_t full = saddr(s_full), empty = saddr(s_empty);
  const bool producer = threadIdx.x == PRODUCER;
  unsigned *bar = a.cnt + a.B * a.KVH + a.B;
  int pbase = 0, abase = 0, pre = 0;  // ring uses so far; stages issued ahead
  ACursor cur;
  if (producer) pre = prefetch<W4, QKV>(mp, a, 0, ring, full, empty, pbase);
  for (int layer = 0; layer < a.n_layers; ++layer) {
    const float *ln = a.ln + (long long)layer * 2 * a.D;
    if (layer)
      phase_rms<W4, PEND_DOWN>(a, ln, nullptr, red, 2 * layer);
    else
      phase_rms<W4, PEND_NONE>(a, ln, nullptr, red, 0);
    grid_sync(bar);
    pbase += phase_product<W4, QKV>(mp, a, layer, ring, full, empty, pbase, pre);
    fence_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) {
      cur = ACursor{s_vid, 0, 0};
      attn_issue(mp, a, layer, ring, s_afull, abase, cur, AGeo::STAGES - 1);
    }
    grid_sync(bar);
    phase_attention<W4>(mp, a, layer, ring, s_afull, asm_, abase, cur);
    abase += my_tiles(a);
    fence_async_smem();
    __syncthreads();
    if (producer) pre = prefetch<W4, O>(mp, a, layer, ring, full, empty, pbase);
    grid_sync(bar);
    pbase += phase_product<W4, O>(mp, a, layer, ring, full, empty, pbase, pre);
    __syncthreads();
    if (producer) pre = prefetch<W4, GU>(mp, a, layer, ring, full, empty, pbase);
    grid_sync(bar);
    phase_rms<W4, PEND_O>(a, ln + a.D, a.so + (long long)layer * (W4 ? 0 : a.D), red,
                          2 * layer + 1);
    grid_sync(bar);
    pbase += phase_product<W4, GU>(mp, a, layer, ring, full, empty, pbase, pre);
    __syncthreads();
    if (producer) pre = prefetch<W4, DOWN>(mp, a, layer, ring, full, empty, pbase);
    grid_sync(bar);
    phase_act<W4>(a, layer, red);
    grid_sync(bar);
    pbase += phase_product<W4, DOWN>(mp, a, layer, ring, full, empty, pbase, pre);
    __syncthreads();
    if (producer && layer + 1 < a.n_layers)
      pre = prefetch<W4, QKV>(mp, a, layer + 1, ring, full, empty, pbase);
    grid_sync(bar);
  }
  // the last layer's down outputs into x
  phase_rms<W4, PEND_DOWN>(a, nullptr, nullptr, red, 2 * a.n_layers);
}

// CTAs of the cooperative grid: every SM holds as many as the occupancy
// API allows (at most 2, the launch bounds); 0 with an error in *err
template <bool W4>
int grid_ctas(cudaError_t *err, int *held) {
  auto kern = fused_decode_kernel<W4>;
  *err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (*err != cudaSuccess) return 0;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  if ((*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return 0;
  if ((*err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NTHREADS, SMEM_BYTES);
  if (*err != cudaSuccess) return 0;
  if (!coop || per_sm < 1) {
    *err = cudaErrorCooperativeLaunchTooLarge;
    return 0;
  }
  *held = per_sm < 2 ? per_sm : 2;
  return sms * *held;
}

template <bool W4>
int launch(const Maps &mp, const Args &a, cudaStream_t st) {
  cudaError_t err;
  int per_sm = 0;
  const int ctas = grid_ctas<W4>(&err, &per_sm);
  if (!ctas) return static_cast<int>(err);
  if (a.B * ((a.D + RW - 1) / RW) > ctas) return cudaErrorInvalidValue;  // phase_rms' items
  Maps m = mp;
  Args copy = a;
  copy.per_sm = per_sm;
  void *params[] = {&m, &copy};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void *>(fused_decode_kernel<W4>),
                                    dim3(ctas), dim3(NTHREADS), params, SMEM_BYTES, st);
  return static_cast<int>(err);
}

// the maps of the weights, activations and cache
bool make_maps(Maps *m, const Args &a, const void *wqkv, const void *wo, const void *wgu,
               const void *wdown, const void *kc, const void *vc, bool w4) {
  const int wrows = w4 ? TK / 2 : TK;
  const long long n = a.n_layers, Nq = (long long)(a.H + 2 * a.KVH) * DH, HD = a.H * DH;
  const long long kr = w4 ? 2 : 1;  // contraction rows a byte row holds
  const auto wmap = [&](CUtensorMap *mm, const void *w, long long K, long long N) {
    return tensor_map_2d(mm, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, n * K / kr, N, N, TN, wrows,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  };
  const auto amap = [&](CUtensorMap *mm, const void *x, long long K) {
    return tensor_map_2d(mm, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, a.B, K, K, TK, 8 * a.MT,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  };
  const long long rows = n * a.KVH * a.B * a.L;
  return wmap(&m->wqkv, wqkv, a.D, Nq) && wmap(&m->wo, wo, HD, a.D) &&
         wmap(&m->wgu, wgu, a.D, 2LL * a.Ip) && wmap(&m->wdown, wdown, a.Ip, a.D) &&
         amap(&m->x8, a.x8, a.D) && amap(&m->ao8, a.ao8, HD) && amap(&m->a8, a.a8, a.Ip) &&
         rows < (1LL << 31) &&
         tensor_map_2d(&m->kc, CU_TENSOR_MAP_DATA_TYPE_UINT8, kc, rows, DH, DH, DH, BL,
                       CU_TENSOR_MAP_SWIZZLE_128B) &&
         tensor_map_2d(&m->vc, CU_TENSOR_MAP_DATA_TYPE_UINT8, vc, rows, DH, DH, DH, BL,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// p: the N_PTRS device pointers in the order of ops/fused_decode.py::_TENSORS,
// then its N_INTS ints (_INTS); every tensor contiguous, in the layouts of
// the Args comments (weights: ops/fused_decode.py's stacked layouts). w4:
// int4 weights with groups of 128.
extern "C" int fused_decode_step_cuda(const long long *p, int np, float eps, float scale, int w4,
                                      void *stream) {
  constexpr int N_PTRS = 33, N_INTS = 13;
  if (np != N_PTRS + N_INTS) return cudaErrorInvalidValue;
  Args a;
  const void *wqkv, *wo, *wgu, *wdown, *kc, *vc;
  const void **ptrs[N_PTRS] = {
      (const void **)&a.cossin, (const void **)&a.mask, (const void **)&a.ln,
      &wqkv, (const void **)&a.sqkv, &kc, (const void **)&a.ksc, &vc,
      (const void **)&a.vsc, &wo, (const void **)&a.so, &wgu, (const void **)&a.sgu,
      &wdown, (const void **)&a.sdown, (const void **)&a.x, (const void **)&a.nk,
      (const void **)&a.nks, (const void **)&a.nv, (const void **)&a.nvs,
      (const void **)&a.x8, (const void **)&a.xs, (const void **)&a.pqkv,
      (const void **)&a.ao8, (const void **)&a.aos, (const void **)&a.pgu,
      (const void **)&a.a8, (const void **)&a.sa, (const void **)&a.po,
      (const void **)&a.pdown, (const void **)&a.patt, (const void **)&a.cnt,
      (const void **)&a.rowp};
  for (int i = 0; i < N_PTRS; ++i) *ptrs[i] = reinterpret_cast<const void *>(p[i]);
  int *ints[N_INTS] = {&a.B, &a.n_layers, &a.D, &a.H, &a.KVH, &a.Ip, &a.bi, &a.L,
                       &a.cache_index, &a.valid_blocks, &a.att_splits, &a.qkv_slices,
                       &a.gu_slices};
  for (int i = 0; i < N_INTS; ++i) *ints[i] = static_cast<int>(p[N_PTRS + i]);
  a.eps = eps;
  a.scale = scale;
  a.MT = (a.B + 7) / 8;
  a.REP = a.KVH > 0 ? a.H / a.KVH : 0;
  const int nb = a.valid_blocks;
  if (a.B < 1 || a.B > MAXB || a.KVH < 1 || a.H % a.KVH ||
      (a.REP != 1 && a.REP != 2 && a.REP != 4 && a.REP != 8) || a.D % TK || a.Ip % a.bi ||
      a.bi % TK || a.bi > MAXA * NTHREADS || a.D > 8 * RW || a.Ip / a.bi > MAXP || (a.H + 7) / 8 > MAXP ||
      a.L % BL || a.cache_index < 0 || a.cache_index >= a.L || nb != (a.cache_index + BL - 1) / BL ||
      a.att_splits < 1 || a.att_splits > (nb > 1 ? nb : 1) || a.qkv_slices < 1 ||
      a.qkv_slices > a.D / TK || a.qkv_slices > MAXSL || a.gu_slices < 1 ||
      a.gu_slices > a.D / TK || a.gu_slices > MAXSL ||
      (w4 && (a.qkv_slices != 1 || a.gu_slices != 1)))
    return cudaErrorInvalidValue;
  Maps m;
  if (!make_maps(&m, a, wqkv, wo, wgu, wdown, kc, vc, w4 != 0)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return w4 ? launch<true>(m, a, st) : launch<false>(m, a, st);
}
