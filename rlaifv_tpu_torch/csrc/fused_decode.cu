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
// Integer sums are exact; each fp32 multiply and add of these formulas is
// written with __fmul_rn / __fadd_rn in the twin's order. The fresh
// column's dot, the norm's sum of squares and the block softmax sums are
// reduced in another order than the twin's, and expf / sigmoid / rsqrt
// round differently, so after a quantisation step flips the two drift
// apart: the card check holds them to a bound set from readings.
//
// What bounds it on the H100: bytes. Every weight byte is used by the B <= 32
// rows (at most 64 int8 operations a byte, against ~590 at which the tensor
// cores become the limit), and the live cache is read once: 6.6 GB of
// weights a token at 7B int8 (3.3 GB int4), ~2 ms at 3.35 TB/s, plus the
// cache prefix.
//
// What the design does about it: one persistent cooperative grid (every
// CTA resident, sized by the occupancy API) walks the layers; each phase is
// a grid-stride loop over its work items and ends at a grid-wide barrier.
// The residual and the small activations (x8, q/k/v, the attention output,
// gate/up, the quantised MLP activation) live in device memory, a few MB
// that stay in L2, read with ld.cg across the barriers. A product item owns
// 32 output columns and a range of the contraction (all of it for qkv and
// gate/up; 8 heads for o; two I-blocks for down, which keeps every SM busy
// on those narrow outputs): each of the 8 warps takes 128-row sub-chunks
// (one int4 group, one head) in turn: the tile as it lies arrives by
// cp.async while the warp works on the sub-chunk before it, is transposed
// with byte permutes (int4: after sign-extending the nibbles) into a
// contraction-contiguous shared tile, the <= 32 activation rows are staged
// beside it (rows past B zero, in shared memory only), and mma.sync
// m16n8k32 s8 runs; the sub-chunks' exact int32 partials meet in shared
// memory (each warp's activation tile, free by then) and are scaled and
// summed in sub-chunk order. o's head-chunk
// sums and down's I-block outputs go to a partial buffer, and the next row
// phase adds them to x in order, so int8 qkv and gate/up, every int4 group
// sum, the o projection's head sum (in chunks of 8 heads, the twin's order)
// and the down product's I-block sum follow the twin's order. The
// attention item is kernel #5's design (csrc/decode_attention_int8.cu) with
// the fresh column in front. wgmma, TMA, deeper pipelining and a split of
// the key axis are left for later changes.
#include <math.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

using namespace rlaifv;

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int DH = 128;   // head dim
constexpr int SUB = 128;  // contraction rows of a sub-chunk: one int4 group, one head
constexpr int TN = 32;    // output columns of a product item
constexpr int MAXB = 32;  // rows the two m16 tiles cover
constexpr int BL = 128;   // cache key block
constexpr int LDS = SUB + 16;  // 144-byte rows: fragment loads hit 32 distinct banks
constexpr int LDP = TN + 1;
constexpr int TILE_BYTES = MAXB * LDS;  // one warp's activation (or weight) tile
constexpr int RAW_BYTES = SUB * TN;     // one warp's weight sub-chunk as it lies (int8)
constexpr int SMEM_BYTES = 2 * NWARPS * TILE_BYTES + NWARPS * RAW_BYTES;  // 106,496
static_assert(MAXB * LDP * 4 <= TILE_BYTES, "a warp's partials fit in its activation tile");
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(TN == MAXB, "weight and activation tiles share TILE_BYTES");

enum { QKV, O, GU, DOWN };

struct Args {
  const float *cossin;  // (2, B, DH)
  const int *mask;      // (B, L)
  const float *ln;      // (n, 2, D)
  const int8_t *wqkv;
  const float *sqkv;
  const int8_t *kc;  // (n, KVH, B, L, DH)
  const float *ksc;  // (n, KVH, B, L)
  const int8_t *vc;
  const float *vsc;
  const int8_t *wo;
  const float *so;
  const int8_t *wgu;
  const float *sgu;
  const int8_t *wdown;
  const float *sdown;
  float *x;  // (B, D): x in on entry, x out on exit
  int8_t *nk;  // (n, KVH, B, DH)
  float *nks;  // (n, KVH, B)
  int8_t *nv;
  float *nvs;
  int8_t *x8;   // (B, D)
  float *xs;    // (B,)
  float *qkv;   // (B, Nq)
  int8_t *ao8;  // (B, H DH)
  float *aos;   // (B, H)
  float *gu;    // (B, 2 Ip)
  int8_t *a8;   // (B, Ip)
  float *sa;    // (B, Ip / bi)
  float *yp;    // (max(H / 8, Ip / bi), B, D): o's head-chunk sums, down's I-block outputs
  unsigned *bar;  // 2 words, 0 on entry
  int B, n_layers, D, H, KVH, Ip, bi, L, cache_index, valid_blocks;
  float eps, scale;
};
constexpr int N_PTRS = 30, N_INTS = 10;

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
  for (int w = 1; w < NWARPS; ++w) t = is_max ? fmaxf(t, red[w]) : t + red[w];
  __syncthreads();
  return t;
}

// The grid-wide barrier of a cooperative launch (every CTA resident): the
// last CTA to arrive resets the count and bumps the generation the others
// wait on. A wait far longer than any phase traps instead of hanging.
__device__ void grid_sync(unsigned *bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned *gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      unsigned spins = 0;
      while (*gen == g) {
        __nanosleep(64);
        if (++spins == (1u << 28)) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------- rms

// What a row phase adds to x first: nothing, the down product's I-block
// outputs in block order (x = ((x + y_0) + y_1) + ...), or the o
// projection's head-chunk sums in chunk order (int8: times its column
// scales) added to x
enum { PEND_NONE, PEND_DOWN, PEND_O };

constexpr int MAXP = 8;  // partial sums a row phase may add: I-blocks, or o's head chunks
constexpr int RV = 4;  // columns a thread handles at once in the row phases (loads first)

template <int PEND>
__device__ __forceinline__ float pending(const Args &a, int b, int c, const float *so) {
  const long long bd = (long long)a.B * a.D, i = (long long)b * a.D + c;
  const int n = PEND == PEND_DOWN ? a.Ip / a.bi : (a.H + NWARPS - 1) / NWARPS;
  float x = __ldcg(a.x + i), y[MAXP];
  if constexpr (PEND == PEND_NONE) return x;
#pragma unroll
  for (int k = 0; k < MAXP; ++k) y[k] = k < n ? __ldcg(a.yp + k * bd + i) : 0.f;
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
  return __fadd_rn(x, so ? __fmul_rn(t, __ldg(so + c)) : t);
}

// item b: x_b gets its pending sums, then xn = (x_b * r) * ln, r =
// rsqrt(mean(x_b^2) + eps), quantised per row (ln null: the update only);
// RV columns a thread at a time, their loads issued before their stores
template <int PEND>
__device__ void phase_rms(const Args &a, const float *ln, const float *so, float *red) {
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    float *xr = a.x + (long long)b * a.D;
    float ss = 0.f;
    for (int c0 = threadIdx.x; c0 < a.D; c0 += RV * NTHREADS) {
      float v[RV];
#pragma unroll
      for (int k = 0; k < RV; ++k)
        v[k] = c0 + k * NTHREADS < a.D ? pending<PEND>(a, b, c0 + k * NTHREADS, so) : 0.f;
#pragma unroll
      for (int k = 0; k < RV; ++k) {
        if (c0 + k * NTHREADS >= a.D) break;
        if constexpr (PEND != PEND_NONE) xr[c0 + k * NTHREADS] = v[k];
        ss = __fadd_rn(ss, __fmul_rn(v[k], v[k]));
      }
    }
    if (!ln) continue;
    ss = block_reduce(ss, red, false);
    const float r = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, static_cast<float>(a.D)), a.eps));
    float amax = 0.f;
#pragma unroll 4
    for (int c = threadIdx.x; c < a.D; c += NTHREADS)
      amax = fmaxf(amax, fabsf(__fmul_rn(__fmul_rn(__ldcg(xr + c), r), __ldg(ln + c))));
    const float s = row_scale(block_reduce(amax, red, true));
    for (int c0 = threadIdx.x; c0 < a.D; c0 += RV * NTHREADS) {
      float v[RV];
#pragma unroll
      for (int k = 0; k < RV; ++k) {
        const int c = c0 + k * NTHREADS;
        v[k] = c < a.D ? __fmul_rn(__fmul_rn(__ldcg(xr + c), r), __ldg(ln + c)) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < RV; ++k)
        if (c0 + k * NTHREADS < a.D)
          a.x8[(long long)b * a.D + c0 + k * NTHREADS] = quant127(v[k], s);
    }
    if (threadIdx.x == 0) a.xs[b] = s;
  }
}

// ---------------------------------------------------------------- products

// rows [0, B) of the activation sub-chunk s (128 bytes a row) -> sA, rows
// [B, 16 MT) zero
__device__ __forceinline__ void stage_act(int8_t *sA, const int8_t *A, int K, int B, int MT,
                                          int s, int lane) {
  for (int u = lane; u < MT * 16 * (SUB / 16); u += 32) {
    const int r = u / (SUB / 16), ch = u % (SUB / 16);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < B) v = __ldcg(reinterpret_cast<const uint4 *>(A + (long long)r * K + s * SUB + ch * 16));
    *reinterpret_cast<uint4 *>(sA + r * LDS + ch * 16) = v;
  }
}

// A weight sub-chunk as it lies: byte row R (32 bytes: columns [c0, c0 +
// 32)) at R / 4 * 128 + ((R % 4) ^ (R / 4 % 4)) * 32, so the transpose's
// reads (4 rows apart across a quarter warp) fall in distinct banks
__device__ __forceinline__ int raw_offset(int row) {
  return (row >> 2) * 128 + (((row & 3) ^ ((row >> 2) & 3)) << 5);
}

// start loading the weight sub-chunk s, columns [c0, c0 + 32) of a
// row-major (K, N) int8 matrix (int4: (K/2, N) packed, the group's low run
// then its high run), into `raw` with cp.async: it lands while the warp
// works on the sub-chunk before it
template <bool W4>
__device__ __forceinline__ void fetch_weight(int8_t *raw, const int8_t *W, int N, int c0, int s,
                                             int lane) {
  constexpr int ROWS = W4 ? SUB / 2 : SUB;  // byte rows of the sub-chunk
  for (int u = lane; u < ROWS * 2; u += 32) {
    const int r = u / 2, half = u % 2;
    cp_async16(raw + raw_offset(r) + half * 16, W + (long long)(s * ROWS + r) * N + c0 + half * 16);
  }
  cp_async_commit();
}

// the landed sub-chunk in `raw` -> sW[col][k], contraction-contiguous: 4
// rows x 16 bytes a unit, 4 x 4 byte blocks transposed with byte permutes
// (int4: the nibbles sign-extended first)
template <bool W4>
__device__ __forceinline__ void transpose_weight(int8_t *sW, const int8_t *raw, int lane) {
  constexpr int ROWS = W4 ? SUB / 2 : SUB;
  for (int u = lane; u < (ROWS / 4) * 2; u += 32) {
    const int quad = u / 2, half = u % 2;
    uint4 w4[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w4[r] = *reinterpret_cast<const uint4 *>(raw + raw_offset(quad * 4 + r) + half * 16);
#pragma unroll
    for (int cq = 0; cq < 4; ++cq) {
      uint32_t w[4], o[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) w[r] = reinterpret_cast<const uint32_t *>(&w4[r])[cq];
      int8_t *dst = sW + (half * 16 + cq * 4) * LDS + quad * 4;
      if constexpr (W4) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          lo[r] = lo_nibbles(w[r]);
          hi[r] = hi_nibbles(w[r]);
        }
        transpose4x4(lo, o);
#pragma unroll
        for (int j = 0; j < 4; ++j) *reinterpret_cast<uint32_t *>(dst + j * LDS) = o[j];
        transpose4x4(hi, o);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t *>(dst + j * LDS + SUB / 2) = o[j];
      } else {
        transpose4x4(w, o);
#pragma unroll
        for (int j = 0; j < 4; ++j) *reinterpret_cast<uint32_t *>(dst + j * LDS) = o[j];
      }
    }
  }
}

// A product phase: items are 32-column tiles of the output, each over the
// whole contraction (module comment). MODE picks the operands and the
// scaling of each 128-row sub-chunk's exact int32 partial.
template <bool W4, int MODE>
__device__ void phase_product(const Args &a, int layer, int8_t *smem) {
  const int B = a.B, D = a.D, HD = a.H * DH, Ip = a.Ip;
  const int Nq = (a.H + 2 * a.KVH) * DH, nI = Ip / a.bi;
  int K, N, srows;
  const int8_t *A, *W;
  const float *S;
  if constexpr (MODE == QKV || MODE == GU) {
    K = D;
    N = MODE == QKV ? Nq : 2 * Ip;
    A = a.x8;
    W = MODE == QKV ? a.wqkv : a.wgu;
    S = MODE == QKV ? a.sqkv : a.sgu;
  } else if constexpr (MODE == O) {
    K = HD;
    N = D;
    A = a.ao8;
    W = a.wo;
    S = a.so;
  } else {
    K = Ip;
    N = D;
    A = a.a8;
    W = a.wdown;
    S = a.sdown;
  }
  srows = W4 ? K / SUB : 1;  // scale rows a layer: int4 group scales, int8 one row
  W += (long long)layer * (W4 ? K / 2 : K) * N;
  S += (long long)layer * srows * N;
  const int nsub = K / SUB, MT = (B + 15) / 16, spb = a.bi / SUB;
  // sub-chunks an item covers: all (qkv, gate/up); one chunk of NWARPS heads
  // (o); two I-blocks, or one where their count is odd (down)
  const int spi = MODE == O ? min(NWARPS, nsub)
                            : MODE == DOWN ? spb * (nI % 2 ? 1 : 2) : nsub;
  const int ntiles = N / TN, nparts = (nsub + spi - 1) / spi;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  int8_t *sA = smem + warp * TILE_BYTES;  // after the mma: the warp's partials [MAXB][LDP]
  int8_t *sW = smem + (NWARPS + warp) * TILE_BYTES;
  int8_t *raw = smem + 2 * NWARPS * TILE_BYTES + warp * RAW_BYTES;
  const int col = threadIdx.x % TN, row0 = threadIdx.x / TN;  // this thread's rows: row0 + 8 i
  const long long bd = (long long)B * D;

  for (int it = blockIdx.x; it < ntiles * nparts; it += gridDim.x) {
    const int c0 = (it % ntiles) * TN, gc = c0 + col;
    const int s0 = (it / ntiles) * spi, s1 = min(nsub, s0 + spi);
    float f[4];
    int ia[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = 0.f;
      ia[i] = 0;
    }
    if (s0 + warp < s1) fetch_weight<W4>(raw, W, N, c0, s0 + warp, lane);
    for (int r0 = s0; r0 < s1; r0 += NWARPS) {
      const int s = r0 + warp;
      if (s < s1) {
        stage_act(sA, A, K, B, MT, s, lane);
        cp_async_wait<0>();
        __syncwarp();
        transpose_weight<W4>(sW, raw, lane);
        __syncwarp();  // raw is read: the next sub-chunk may land in it
        if (s + NWARPS < s1) fetch_weight<W4>(raw, W, N, c0, s + NWARPS, lane);
        int acc[2][4][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][j][e] = 0;
#pragma unroll
        for (int ks = 0; ks < SUB; ks += 32) {
          uint32_t bf[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int8_t *p = sW + (j * 8 + g) * LDS + ks + t * 4;
            bf[j][0] = ld32(p);
            bf[j][1] = ld32(p + 16);
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if (m >= MT) break;
            const int8_t *p = sA + (m * 16 + g) * LDS + ks + t * 4;
            const uint32_t af[4] = {ld32(p), ld32(p + 8 * LDS), ld32(p + 16),
                                    ld32(p + 8 * LDS + 16)};
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_s8(acc[m][j], af, bf[j]);
          }
        }
        __syncwarp();  // every lane's fragments are read: sA takes the partials
        int *pw = reinterpret_cast<int *>(sA);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (m >= MT) break;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              pw[(m * 16 + g + (e / 2) * 8) * LDP + j * 8 + t * 2 + e % 2] = acc[m][j][e];
        }
      }
      __syncthreads();
      const int nv = min(NWARPS, s1 - r0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + 8 * i;
        if (row >= B) continue;
        for (int jj = 0; jj < nv; ++jj) {
          const int sub = r0 + jj;
          const int p = reinterpret_cast<const int *>(smem + jj * TILE_BYTES)[row * LDP + col];
          if constexpr (MODE == QKV || MODE == GU) {
            if constexpr (W4) {
              const float v = __fmul_rn(__int2float_rn(p), __ldg(S + (long long)sub * N + gc));
              f[i] = sub == 0 ? v : __fadd_rn(f[i], v);
            } else {
              ia[i] += p;
            }
          } else if constexpr (MODE == O) {
            float v = __fmul_rn(__int2float_rn(p), __ldcg(a.aos + row * a.H + sub));
            if constexpr (W4) v = __fmul_rn(v, __ldg(S + (long long)sub * N + gc));
            f[i] = sub == s0 ? v : __fadd_rn(f[i], v);
          } else {  // an I-block's output goes out when its last sub-chunk is in
            const int blk = sub / spb;
            float *y = a.yp + blk * bd + (long long)row * D + gc;
            if constexpr (W4) {
              const float v = __fmul_rn(__int2float_rn(p), __ldg(S + (long long)sub * N + gc));
              f[i] = sub % spb == 0 ? v : __fadd_rn(f[i], v);
              if ((sub + 1) % spb == 0) *y = __fmul_rn(f[i], __ldcg(a.sa + row * nI + blk));
            } else {
              ia[i] += p;
              if ((sub + 1) % spb == 0) {
                *y = __fmul_rn(__fmul_rn(__int2float_rn(ia[i]), __ldcg(a.sa + row * nI + blk)),
                               __ldg(S + gc));
                ia[i] = 0;
              }
            }
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 8 * i;
      if (row >= B) continue;
      if constexpr (MODE == QKV || MODE == GU) {
        const float sx = __ldcg(a.xs + row);
        const float y = W4 ? __fmul_rn(f[i], sx)
                           : __fmul_rn(__fmul_rn(__int2float_rn(ia[i]), sx), __ldg(S + gc));
        (MODE == QKV ? a.qkv : a.gu)[(long long)row * N + gc] = y;
      } else if constexpr (MODE == O) {  // this head chunk's sum
        a.yp[(s0 / spi) * bd + (long long)row * D + gc] = f[i];
      }
    }
  }
}

// ---------------------------------------------------------------- attention

template <int REP>
struct AttnSmem {
  float q[REP][DH];  // roped q, fp32
  float k[DH], v[DH];
  float s[REP][BL];
  float acc[REP][DH];
  int iacc[REP][DH];
  float qs[REP], corr[REP], sp[REP];
  __align__(16) int8_t q8[REP][DH];
  int8_t p8[REP][BL];
};

// item (kv head g, row b): rope, the fresh k/v out, then attention of the
// n_rep query heads g REP .. g REP + REP - 1 over the fresh column and the
// live cache blocks; the output quantised per (head, row) -> ao8, aos
template <int REP>
__device__ void phase_attention(const Args &a, int layer, int8_t *smem) {
  auto &sm = *reinterpret_cast<AttnSmem<REP> *>(smem);
  const int B = a.B, L = a.L, HD = a.H * DH, Nq = (a.H + 2 * a.KVH) * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int it = blockIdx.x; it < a.KVH * B; it += gridDim.x) {
    const int g = it / B, b = it % B;
    const long long kvrow = ((long long)layer * a.KVH + g) * B + b;  // (layer, g, b)
    const float *cosr = a.cossin + b * DH, *sinr = a.cossin + (B + b) * DH;

    // tasks: REP q heads, then k, then v, one warp each; lane owns dims 4 lane + i
    for (int task = warp; task < REP + 2; task += NWARPS) {
      const int src_head = task < REP ? g * REP + task : task == REP ? a.H + g : a.H + a.KVH + g;
      const float *src = a.qkv + (long long)b * Nq + src_head * DH;
      float v[4];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = lane * 4 + i;
        v[i] = __ldcg(src + d);
        if (task <= REP) {  // rope: x cos + rotate_half(x) sin
          const float partner = __ldcg(src + (d ^ (DH / 2)));
          const float rot = d < DH / 2 ? -partner : partner;
          v[i] = __fadd_rn(__fmul_rn(v[i], __ldg(cosr + d)), __fmul_rn(rot, __ldg(sinr + d)));
        }
        amax = fmaxf(amax, fabsf(v[i]));
      }
      const float s = row_scale(warp_max(amax));
      float *keep = task < REP ? sm.q[task] : task == REP ? sm.k : sm.v;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = lane * 4 + i;
        keep[d] = v[i];
        const int8_t q = quant127(v[i], s);
        if (task < REP) sm.q8[task][d] = q;
        else (task == REP ? a.nk : a.nv)[kvrow * DH + d] = q;
      }
      if (lane == 0) {
        if (task < REP) sm.qs[task] = s;
        else (task == REP ? a.nks : a.nvs)[kvrow] = s;
      }
    }
    __syncthreads();

    // the fresh column: m = (q . k) * scale, l = 1, acc = v
    float m = NEG_INF, l = 1.f;
    if (warp < REP) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) dot = __fadd_rn(dot, __fmul_rn(sm.q[warp][lane * 4 + i], sm.k[lane * 4 + i]));
      m = __fmul_rn(warp_sum(dot), a.scale);
    }
    for (int i = threadIdx.x; i < REP * DH; i += NTHREADS) (&sm.acc[0][0])[i] = sm.v[i % DH];

    const int slot = lane / 8, c = lane % 8;  // scores: 4 keys a warp step, 16 bytes a lane
    int qw[REP][4];
    float sq[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const int *w = reinterpret_cast<const int *>(&sm.q8[r][0]) + c * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) qw[r][i] = w[i];
      sq[r] = sm.qs[r];
    }
    const int8_t *kb = a.kc + kvrow * L * DH;
    const int8_t *vb = a.vc + kvrow * L * DH;
    const float *ksb = a.ksc + kvrow * L, *vsb = a.vsc + kvrow * L;
    const int *mb = a.mask + (long long)b * L;

    for (int j = 0; j < a.valid_blocks; ++j) {
      const int t0 = j * BL;
      // (1) scores of the block's keys: 4 key rows a lane, loaded first
      constexpr int KPL = BL / (NWARPS * 4);
      uint4 kv[KPL];
      float ks[KPL];
      bool live[KPL];
#pragma unroll
      for (int k = 0; k < KPL; ++k) {
        const int tk = t0 + warp * 4 + slot + NWARPS * 4 * k;
        kv[k] = __ldg(reinterpret_cast<const uint4 *>(kb + (long long)tk * DH + c * 16));
        ks[k] = __ldg(ksb + tk);
        live[k] = __ldg(mb + tk) != 0 && tk < a.cache_index;
      }
#pragma unroll
      for (int k = 0; k < KPL; ++k) {
        const int tl = warp * 4 + slot + NWARPS * 4 * k;
        const int kw[4] = {(int)kv[k].x, (int)kv[k].y, (int)kv[k].z, (int)kv[k].w};
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          int dot = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) dot = __dp4a(qw[r][i], kw[i], dot);
#pragma unroll
          for (int o = 4; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
          if (c == 0)
            sm.s[r][tl] = live[k] ? __fmul_rn(__fmul_rn(__fmul_rn((float)dot, sq[r]), ks[k]),
                                              a.scale)
                                  : NEG_INF;
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < REP * DH; i += NTHREADS) (&sm.iacc[0][0])[i] = 0;

      // (2) the online softmax of head `warp`, p8 of the v-scaled probabilities
      if (warp < REP) {
        const int r = warp;
        float bmax = -INFINITY;
        for (int tl = lane; tl < BL; tl += 32) bmax = fmaxf(bmax, sm.s[r][tl]);
        const float m_new = fmaxf(m, fmaxf(warp_max(bmax), NEG_INF / 2));
        float pv[BL / 32];
        float psum = 0.f, pmax = 0.f;
#pragma unroll
        for (int i = 0; i < BL / 32; ++i) {
          const int tl = lane + 32 * i;
          const float p = expf(__fsub_rn(sm.s[r][tl], m_new));
          psum += p;
          pv[i] = __fmul_rn(p, __ldg(vsb + t0 + tl));
          pmax = fmaxf(pmax, fabsf(pv[i]));
        }
        psum = warp_sum(psum);
        const float sp = row_scale(warp_max(pmax));
#pragma unroll
        for (int i = 0; i < BL / 32; ++i) sm.p8[r][lane + 32 * i] = quant127(pv[i], sp);
        const float corr = expf(__fsub_rn(m, m_new));
        l = __fadd_rn(__fmul_rn(l, corr), psum);
        m = m_new;
        if (lane == 0) {
          sm.corr[r] = corr;
          sm.sp[r] = sp;
        }
      }
      __syncthreads();

      // (3) exact int32 P8.V8: a warp reads one value row (4 bytes a lane) a
      // step, all its BL / NWARPS rows loaded first
      int ia[REP][4];
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) ia[r][i] = 0;
      int words[BL / NWARPS];
#pragma unroll
      for (int k = 0; k < BL / NWARPS; ++k)
        words[k] = __ldg(reinterpret_cast<const int *>(
            vb + (long long)(t0 + warp + NWARPS * k) * DH + lane * 4));
#pragma unroll
      for (int k = 0; k < BL / NWARPS; ++k) {
        const int tl = warp + NWARPS * k;
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const int p = sm.p8[r][tl];
#pragma unroll
          for (int i = 0; i < 4; ++i) ia[r][i] += p * (int)(int8_t)(words[k] >> (8 * i));
        }
      }
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) atomicAdd(&sm.iacc[r][lane * 4 + i], ia[r][i]);
      __syncthreads();

      // (4) acc = acc * corr + float(p8 . v8) * sp
      for (int i = threadIdx.x; i < REP * DH; i += NTHREADS) {
        const int r = i / DH;
        float *ac = &sm.acc[0][0] + i;
        *ac = __fadd_rn(__fmul_rn(*ac, sm.corr[r]),
                        __fmul_rn((float)(&sm.iacc[0][0])[i], sm.sp[r]));
      }
      // the next block's (1) writes only sm.s, which (4) does not read
    }
    __syncthreads();

    // out = acc / max(l, 1e-30), quantised per (head, row)
    if (warp < REP) {
      const int h = g * REP + warp;
      float o[4];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i] = __fdiv_rn(sm.acc[warp][lane * 4 + i], fmaxf(l, 1e-30f));
        amax = fmaxf(amax, fabsf(o[i]));
      }
      const float s = row_scale(warp_max(amax));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a.ao8[(long long)b * HD + h * DH + lane * 4 + i] = quant127(o[i], s);
      if (lane == 0) a.aos[b * a.H + h] = s;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- MLP activation

// item (row b, I-block blk): a = (g * sigmoid(g)) * u over the block's bi
// columns, quantised with one scale for the block
__device__ void phase_act(const Args &a, float *red) {
  const int nI = a.Ip / a.bi;
  for (int it = blockIdx.x; it < a.B * nI; it += gridDim.x) {
    const int b = it / nI, blk = it % nI;
    const float *gr = a.gu + (long long)b * 2 * a.Ip + blk * a.bi;
    const float *ur = gr + a.Ip;
    auto act = [&](int c) {
      const float gv = __ldcg(gr + c);
      const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-gv)));
      return __fmul_rn(__fmul_rn(gv, sig), __ldcg(ur + c));
    };
    float amax = 0.f;
#pragma unroll 4
    for (int c = threadIdx.x; c < a.bi; c += NTHREADS) amax = fmaxf(amax, fabsf(act(c)));
    const float s = row_scale(block_reduce(amax, red, true));
    for (int c0 = threadIdx.x; c0 < a.bi; c0 += RV * NTHREADS) {
      float v[RV];
#pragma unroll
      for (int k = 0; k < RV; ++k) v[k] = c0 + k * NTHREADS < a.bi ? act(c0 + k * NTHREADS) : 0.f;
#pragma unroll
      for (int k = 0; k < RV; ++k)
        if (c0 + k * NTHREADS < a.bi)
          a.a8[(long long)b * a.Ip + blk * a.bi + c0 + k * NTHREADS] = quant127(v[k], s);
    }
    if (threadIdx.x == 0) a.sa[b * nI + blk] = s;
  }
}

// ---------------------------------------------------------------- the kernel

template <bool W4, int REP>
__global__ void __launch_bounds__(NTHREADS, 2) fused_decode_kernel(Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  float *red = reinterpret_cast<float *>(smem);
  for (int layer = 0; layer < a.n_layers; ++layer) {
    const float *ln = a.ln + (long long)layer * 2 * a.D;
    if (layer)
      phase_rms<PEND_DOWN>(a, ln, nullptr, red);
    else
      phase_rms<PEND_NONE>(a, ln, nullptr, red);
    grid_sync(a.bar);
    phase_product<W4, QKV>(a, layer, smem);
    grid_sync(a.bar);
    phase_attention<REP>(a, layer, smem);
    grid_sync(a.bar);
    phase_product<W4, O>(a, layer, smem);
    grid_sync(a.bar);
    phase_rms<PEND_O>(a, ln + a.D, W4 ? nullptr : a.so + (long long)layer * a.D, red);
    grid_sync(a.bar);
    phase_product<W4, GU>(a, layer, smem);
    grid_sync(a.bar);
    phase_act(a, red);
    grid_sync(a.bar);
    phase_product<W4, DOWN>(a, layer, smem);
    grid_sync(a.bar);
  }
  phase_rms<PEND_DOWN>(a, nullptr, nullptr, red);  // the last layer's down outputs into x
}

// CTAs of the cooperative grid: every SM holds as many as the occupancy
// API allows (at most 2, the launch bounds); 0 with an error in *err
template <bool W4, int REP>
int grid_ctas(cudaError_t *err) {
  auto kern = fused_decode_kernel<W4, REP>;
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
  return sms * per_sm;
}

template <bool W4, int REP>
int launch(const Args &a, cudaStream_t st) {
  cudaError_t err;
  const int ctas = grid_ctas<W4, REP>(&err);
  if (!ctas) return static_cast<int>(err);
  Args copy = a;
  void *params[] = {&copy};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void *>(fused_decode_kernel<W4, REP>),
                                    dim3(ctas), dim3(NTHREADS), params, SMEM_BYTES, st);
  return static_cast<int>(err);
}

template <bool W4>
int dispatch(int rep, const Args &a, cudaStream_t st) {
  switch (rep) {
    case 1: return launch<W4, 1>(a, st);
    case 2: return launch<W4, 2>(a, st);
    case 4: return launch<W4, 4>(a, st);
    case 8: return launch<W4, 8>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// p: the N_PTRS device pointers of struct Args in order, then its N_INTS
// ints (ops/fused_decode.py::_TENSORS, _INTS); every tensor contiguous, in
// the layouts of the Args comments. w4: int4 weights with groups of 128.
extern "C" int fused_decode_step_cuda(const long long *p, int np, float eps, float scale, int w4,
                                      void *stream) {
  if (np != N_PTRS + N_INTS) return cudaErrorInvalidValue;
  Args a;
  const void **ptrs[N_PTRS] = {
      (const void **)&a.cossin, (const void **)&a.mask, (const void **)&a.ln,
      (const void **)&a.wqkv, (const void **)&a.sqkv, (const void **)&a.kc,
      (const void **)&a.ksc, (const void **)&a.vc, (const void **)&a.vsc,
      (const void **)&a.wo, (const void **)&a.so, (const void **)&a.wgu,
      (const void **)&a.sgu, (const void **)&a.wdown, (const void **)&a.sdown,
      (const void **)&a.x, (const void **)&a.nk, (const void **)&a.nks,
      (const void **)&a.nv, (const void **)&a.nvs, (const void **)&a.x8,
      (const void **)&a.xs, (const void **)&a.qkv, (const void **)&a.ao8,
      (const void **)&a.aos, (const void **)&a.gu, (const void **)&a.a8,
      (const void **)&a.sa, (const void **)&a.yp, (const void **)&a.bar};
  for (int i = 0; i < N_PTRS; ++i) *ptrs[i] = reinterpret_cast<const void *>(p[i]);
  int *ints[N_INTS] = {&a.B, &a.n_layers, &a.D, &a.H, &a.KVH,
                       &a.Ip, &a.bi, &a.L, &a.cache_index, &a.valid_blocks};
  for (int i = 0; i < N_INTS; ++i) *ints[i] = static_cast<int>(p[N_PTRS + i]);
  a.eps = eps;
  a.scale = scale;
  if (a.B < 1 || a.B > MAXB || a.KVH < 1 || a.H % a.KVH || a.D % SUB ||
      a.Ip % a.bi || a.bi % SUB || a.Ip / a.bi > MAXP || (a.H + NWARPS - 1) / NWARPS > MAXP ||
      a.L % BL || a.cache_index < 0 || a.cache_index >= a.L ||
      a.valid_blocks != (a.cache_index + BL - 1) / BL)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int rep = a.H / a.KVH;
  return w4 ? dispatch<true>(rep, a, st) : dispatch<false>(rep, a, st);
}
