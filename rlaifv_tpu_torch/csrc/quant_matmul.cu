// int8 weight-only matrix products for Hopper (sm_90a): the forward and
// the input gradient of y = x (q * s) with the weight q (K, N) kept int8 in
// device memory, its per-output-channel scales s (N,) fp32. bf16 in and out,
// int8 x int8 -> int32 on the tensor cores.
//
// Replaces, in rlaifv_tpu/ops/quant_matmul.py:
//   #7  _kernel             (int8_matmul):             x quantised per row in the kernel
//   #8  _dx_kernel          (int8_matmul_dx):          dy * s quantised per row, once (qdx)
//   #9  _prequant_kernel    (int8_matmul_prequant):    x quantised beforehand
//   #10 _prequant_dx_kernel (int8_matmul_dx_prequant): dy * s quantised beforehand
//
// The function, as the TPU kernels compute it:
//   forward  sx = max(max_k |x|, 1e-20) / 127, xq = clamp(rn(x / sx), +-127),
//            out = bf16((float(xq . q) * sx) * s)
//   dx       v = dy * s, sy = max(max_n |v|, 1e-20) / 127,
//            vq = clamp(rn(v / sy), +-127), dx = bf16(float(vq . q^T) * sy)
// The int32 sums are exact, the divisions IEEE (__fdiv_rn, rounding half to
// even with __float2int_rn) and the epilogue two fp32 multiplies in that
// order, so every kernel equals its plain PyTorch version bit for bit, and
// #7 equals #9 and #8 equals #10 on the same inputs (the prequant wrappers
// quantise with the same IEEE operations in torch).
//
// What bounds it on the H100: int8 tensor-core operations at the train
// step's shapes (M ~ 10^4 rows, K, N = 4096 / 11008: 2 M K N operations
// against K N + M (K + N) bytes), the weight bytes at small M (M < 128, each
// q byte is used by only M rows).
//
// What the design does about it (qmm_kernel: #7, #9 and #10 on rows TMA
// cannot map, #7 also above FWD_SPLIT_MAX_M; #8 and #10 in qdx below, #7 in
// qfwd, #9 in qpre): each CTA
// owns a 128 x 128 output tile and walks the contraction in 64-wide chunks
// through two shared-memory stages (cp.async for int8 operands), 8 warps
// each issuing mma.sync m16n8k32 s8 x s8 -> s32 on a 32 x 64 sub-tile. The
// int8 mma takes both operands contraction-contiguous (.row.col):
// - dx contracts over N, and a row of q (K, N) is already N-contiguous: q
//   tiles load as they lie, no q^T anywhere (#10 takes this kernel only on
//   rows a TMA tensor map cannot read: N % 16 != 0 or an unaligned base);
// - the forward contracts over K, so each (64 K-rows x 128 N) q tile is
//   staged as it lies (16-byte chunks XOR-swizzled across banks) and
//   transposed in shared memory with byte permutes into a K-contiguous
//   tile. Neither q^T nor a second copy of the weight exists in device
//   memory.
// The in-kernel-quantisation instance (#7's cp.async route) first takes
// each of its 128 rows' absolute maximum over the whole contraction (as the
// TPU kernel quantises its row stripe in every program), then quantises
// each bf16 chunk into shared memory as it arrives, loading the next chunk
// into registers while the current one multiplies. That costs an IEEE
// division per element in every column CTA, the TPU kernel's redundancy
// across N tiles, where the prequant pair divides once per element in
// torch. Ragged edges (M, N, K not a multiple of the tile, rows whose
// length is not a multiple of 16 bytes) read as zeros, which add exact
// zeros, and are never written.
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "int8_mma.cuh"

using bf16 = __nv_bfloat16;

namespace {

using namespace rlaifv;

constexpr int BM = 128;  // rows of x (or dy) a CTA owns
constexpr int BN = 128;  // output columns a CTA owns: N forward, K for dx
constexpr int BK = 64;   // contraction chunk: K forward, N for dx
constexpr int NTHREADS = 256;  // 8 warps, 4 along rows x 2 along columns
// byte row stride of contraction-contiguous int8 tiles: 80 bytes = 20 words
// puts the 8 rows x 4 words of a fragment load in 32 distinct banks and
// keeps rows 16-byte aligned for cp.async
constexpr int LDT = BK + 16;
constexpr int A_BYTES = BM * LDT;  // one stage of the x (dy) tile
constexpr int B_BYTES = BN * LDT;  // one stage of the K-contiguous q tile
constexpr int Q_BYTES = BK * BN;   // one stage of the forward's q tile as it lies
static_assert(BN == 128, "the q staging tile has 128-byte rows (swizzle128)");

// Transpose the staged (BK, BN) q tile (swizzle128 layout) into the
// K-contiguous (BN, LDT) tile the mma reads as its .col operand: 4 x 4 byte
// blocks, two per thread;
// a half warp takes the 16 K-blocks of one N-block, which makes a warp's
// 32-bit stores hit 32 distinct banks.
__device__ __forceinline__ void transpose_q(int8_t *dst, const int8_t *src) {
#pragma unroll
  for (int i = 0; i < (BK / 4) * (BN / 4) / NTHREADS; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    const int kb = idx % (BK / 4), nb = idx / (BK / 4);
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = ld32(src + swizzle128(kb * 4 + r, nb * 4));
    // w[r] byte j = q[k = 4 kb + r][n = 4 nb + j]; o[j] byte r = the same
    uint32_t o[4];
    transpose4x4(w, o);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t *>(dst + (nb * 4 + j) * LDT + kb * 4) = o[j];
  }
}

// FWD: out (M, N) = x (M, K) . q (K, N), contraction C = K, output columns K.
// !FWD: out (M, K) = dy (M, N) . q^T, contraction C = N, output columns K.
// PREQ: `a` is int8 (M, C) with row scales `arow` (M,); else `a` is bf16
// (M, C) and quantised here (the forward, #7; #8 quantises its rows in a
// pass of its own, qdx below). `ocol` (N,) scales the forward's output
// columns.
template <bool FWD, bool PREQ>
__global__ void __launch_bounds__(NTHREADS)
    qmm_kernel(const void *__restrict__ a, const float *__restrict__ arow,
               const int8_t *__restrict__ q, const float *__restrict__ ocol,
               bf16 *__restrict__ out, int M, int K, int N) {
  static_assert(FWD || PREQ, "the dx product takes prequantised rows");
  __shared__ __align__(16) int8_t sA[2][A_BYTES];
  __shared__ __align__(16) int8_t sB[FWD ? 1 : 2][B_BYTES];
  __shared__ __align__(16) int8_t sQ[FWD ? 2 : 1][FWD ? Q_BYTES : 16];
  __shared__ float srow[BM];

  const int C = FWD ? K : N, NO = FWD ? N : K;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nt = (C + BK - 1) / BK;
  const bool q_vec = (reinterpret_cast<uintptr_t>(q) & 15) == 0 && N % 16 == 0;
  const int8_t *a8 = static_cast<const int8_t *>(a);
  const bf16 *a16 = static_cast<const bf16 *>(a);
  const bool a_vec = PREQ ? (reinterpret_cast<uintptr_t>(a) & 15) == 0 && C % 16 == 0
                          : (reinterpret_cast<uintptr_t>(a) & 15) == 0 && C % 8 == 0;

  if constexpr (PREQ) {
    for (int r = threadIdx.x; r < BM; r += NTHREADS) srow[r] = m0 + r < M ? arow[m0 + r] : 1.f;
  } else {
    row_scales<BM, NTHREADS>(srow, a16, m0, M, C, a_vec);
  }
  __syncthreads();

  // int8 operand chunks of tile kt into stage st (asynchronous where aligned)
  auto stage_int8 = [&](int st, int kt) {
    const int c0 = kt * BK;
    if constexpr (PREQ) {
      for (int i = threadIdx.x; i < BM * (BK / 16); i += NTHREADS) {
        const int r = i / (BK / 16), c = i % (BK / 16);
        load16_i8(&sA[st][r * LDT + c * 16], a8, m0 + r, M, c0 + c * 16, C, a_vec);
      }
    }
    if constexpr (FWD) {  // q rows c0 .. c0 + BK, columns n0 .. n0 + BN, as they lie
      for (int i = threadIdx.x; i < BK * (BN / 16); i += NTHREADS) {
        const int r = i / (BN / 16), c = i % (BN / 16);
        load16_i8(&sQ[st][swizzle128(r, c * 16)], q, c0 + r, K, n0 + c * 16, N, q_vec);
      }
    } else {  // q rows n0 .. n0 + BN (output columns), columns c0 .. c0 + BK
      for (int i = threadIdx.x; i < BN * (BK / 16); i += NTHREADS) {
        const int r = i / (BK / 16), c = i % (BK / 16);
        load16_i8(&sB[st][r * LDT + c * 16], q, n0 + r, K, c0 + c * 16, N, q_vec);
      }
    }
  };
  // in-kernel quantisation: this thread's chunks of tile kt, loaded into
  // registers now and quantised into shared memory later
  constexpr int A_CHUNKS = BM * (BK / 8) / NTHREADS;
  float va[A_CHUNKS][8];
  auto fetch_bf16 = [&](int kt) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int idx = threadIdx.x + i * NTHREADS;
      const int r = idx / (BK / 8), c = kt * BK + (idx % (BK / 8)) * 8;
      load8_bf16(va[i], a16, m0 + r, M, c, C, a_vec);
    }
  };
  auto store_bf16 = [&](int st) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int idx = threadIdx.x + i * NTHREADS;
      const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
      // rows past M skip the 8 IEEE divisions (most of them at M < 128)
      *reinterpret_cast<uint2 *>(&sA[st][r * LDT + c]) =
          m0 + r < M ? quantize8(va[i], srow[r]) : make_uint2(0u, 0u);
    }
  };

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  stage_int8(0, 0);
  cp_async_commit();
  if constexpr (!PREQ) {
    fetch_bf16(0);
    store_bf16(0);
  }
  for (int kt = 0; kt < nt; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nt) {
      stage_int8(cur ^ 1, kt + 1);
      cp_async_commit();
      if (!PREQ) fetch_bf16(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t *tb = sB[FWD ? 0 : cur];
    if constexpr (FWD) {
      transpose_q(sB[0], sQ[cur]);
      __syncthreads();
    }
    const int8_t *ta = sA[cur];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4], bfrag[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t *p = ta + (wm * 32 + mt * 16 + g) * LDT + ks + t * 4;
        af[mt][0] = ld32(p);
        af[mt][1] = ld32(p + 8 * LDT);
        af[mt][2] = ld32(p + 16);
        af[mt][3] = ld32(p + 8 * LDT + 16);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int8_t *p = tb + (wn * 64 + j * 8 + g) * LDT + ks + t * 4;
        bfrag[j][0] = ld32(p);
        bfrag[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_s8(acc[mt][j], af[mt], bfrag[j]);
    }
    // stage cur ^ 1 was last read in iteration kt - 1, before this
    // iteration's first barrier
    if (!PREQ && kt + 1 < nt) store_bf16(cur ^ 1);
    __syncthreads();
  }

  // epilogue: bf16((float(acc) * row scale) * column scale)
  const bool pairs = NO % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * 32 + mt * 16 + g + h * 8;
      const int row = m0 + rl;
      if (row >= M) continue;
      const float rs = srow[rl];
      bf16 *orow = out + (long long)row * NO;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn * 64 + j * 8 + t * 2;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = __fmul_rn(__int2float_rn(acc[mt][j][h * 2 + e]), rs);
          if (FWD && col + e < NO) v[e] = __fmul_rn(v[e], ocol[col + e]);
        }
        if (pairs && col + 1 < NO) {
          *reinterpret_cast<__nv_bfloat162 *>(orow + col) = __floats2bfloat162_rn(v[0], v[1]);
        } else {
          if (col < NO) orow[col] = __float2bfloat16_rn(v[0]);
          if (col + 1 < NO) orow[col + 1] = __float2bfloat16_rn(v[1]);
        }
      }
    }
  }
}

template <bool FWD, bool PREQ>
int launch(const void *a, const void *arow, const void *q, const void *ocol, void *out,
           int M, int K, int N, void *stream) {
  const int NO = FWD ? N : K;
  const dim3 grid((NO + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_kernel<FWD, PREQ><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float *>(arow), static_cast<const int8_t *>(q),
      static_cast<const float *>(ocol), static_cast<bf16 *>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ #8, redesigned
//
// dx = Q(dy * s) . q^T at any M, built for the rows QLoRA's short suffix
// gives it (M < 128, where the weight's bytes bound it) in three launches:
// 1. dx_quant_rows: one CTA a row quantises v = dy * s once per call:
//    sy = max(max |v|, 1e-20) / 127 and rn(v / sy) (IEEE), the same
//    arithmetic as quantize8 / row_scales, into dyq (M, N) int8 and sy (M,),
//    where the TPU kernel quantises the stripe again in every column tile.
// 2. dx_product: dyq . q^T on wgmma m64n128k32 s8 x s8 -> s32, both operands
//    K-major as they lie in device memory (the contraction N is contiguous
//    in dyq's rows and in q's), fed by TMA through a 4-stage ring of
//    128-byte-swizzled tiles: one producer warp, NCONS consumer warpgroups
//    of 64 rows each (NCONS = 1 at M <= 64, so a tile holds the rows there
//    are). The N contraction is split into `split` slices of 128-wide
//    chunks, one CTA per (128 output columns, row tile, slice), so that at
//    M 64, K 4096, N 11008 some 288 CTAs (two per SM, 96 KB of ring each,
//    64 KB of weight in flight per CTA) stream disjoint slices of q. One
//    slice writes bf16(float(acc) * sy) itself; several write exact int32
//    partials (split, M, K);
// 3. dx_finish (split > 1 only): sums the partials in slice order (int32:
//    exact, |sum| <= 127^2 N < 2^31 for N < 133,000) and writes
//    bf16(float(sum) * sy).
// No atomics: every element is written by one thread in a fixed order, so
// reruns give the same bits. N not a multiple of 16 (rows TMA cannot map)
// takes #10's kernel on the quantised rows instead of step 2.
namespace qdx {

constexpr int TN = 128;      // output columns (rows of q) a CTA owns
constexpr int TC = 128;      // contraction bytes of a stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int ATOM = 1024;   // 8 rows of 128 bytes

template <int NCONS>
struct Tile {
  static constexpr int THREADS = NCONS * 128 + 32;
  static constexpr int A_BYTES = NCONS * 64 * TC;
  static constexpr int B_BYTES = TN * TC;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + ATOM;
};

__device__ __forceinline__ float block_max(float v, float *red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < blockDim.x / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// one CTA a row: dyq[m] = clamp(rn(v / sy), +-127) with v = dy[m] * s, or
// v = dy[m] where s is null (the prequant forward's rows on any K)
__global__ void __launch_bounds__(256)
    dx_quant_rows(const bf16 *__restrict__ dy, const float *__restrict__ s,
                  int8_t *__restrict__ dyq, float *__restrict__ sy, int N) {
  __shared__ float red[8];
  const long long m = blockIdx.x;
  const bf16 *row = dy + m * N;
  const auto value = [&](int n) {
    const float x = __bfloat162float(row[n]);
    return s != nullptr ? __fmul_rn(x, s[n]) : x;
  };
  float amax = 0.f;
  for (int n = threadIdx.x; n < N; n += 256) amax = fmaxf(amax, fabsf(value(n)));
  const float scale = __fdiv_rn(fmaxf(block_max(amax, red), 1e-20f), 127.0f);
  if (threadIdx.x == 0) sy[m] = scale;
  int8_t *out = dyq + m * N;
  for (int n = threadIdx.x; n < N; n += 256) {
    const int q = __float2int_rn(__fdiv_rn(value(n), scale));
    out[n] = static_cast<int8_t>(max(-127, min(127, q)));
  }
}

// chunks [c0, c1) of slice `slice` out of `split` over nc chunks
__device__ __forceinline__ void slice_range(int slice, int split, int nc, int &c0, int &c1) {
  c0 = static_cast<int>(static_cast<long long>(slice) * nc / split);
  c1 = static_cast<int>(static_cast<long long>(slice + 1) * nc / split);
}

// One CTA: output columns [k0, k0 + 128) of rows [m0, m0 + 64 NCONS), the
// contraction over chunk slice blockIdx.z. Warps 0 .. 4 NCONS - 1 are the
// consumer warpgroups (rows 64 wg .. 64 wg + 63 of the tile), the last warp
// the producer.
template <int NCONS>
__global__ void __launch_bounds__(Tile<NCONS>::THREADS)
    dx_product(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, const float *__restrict__ sy,
               bf16 *__restrict__ dx, int *__restrict__ part, int M, int K, int N) {
  using T = Tile<NCONS>;
  extern __shared__ __align__(1024) unsigned char smem_ring[];
  const uint32_t tiles = (saddr(smem_ring) + ATOM - 1) / ATOM * ATOM;
  const uint32_t full = tiles + STAGES * T::STAGE_BYTES;
  const uint32_t empty = full + STAGES * 8;
  const int k0 = blockIdx.x * TN, m0 = blockIdx.y * 64 * NCONS;
  const int slice = blockIdx.z, split = gridDim.z;
  int c0, c1;
  slice_range(slice, split, (N + TC - 1) / TC, c0, c1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, NCONS);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp == NCONS * 4) {  // the producer: one thread starts every load
    if (lane == 0) {
      for (int c = c0; c < c1; ++c) {
        const int i = c - c0, s = i % STAGES;
        if (i >= STAGES) bar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
        const uint32_t a = tiles + s * T::STAGE_BYTES, bar = full + 8 * s;
        bar_expect(bar, T::STAGE_BYTES);
        tma_load(a, &map_a, c * TC, m0, bar);
        tma_load(a + T::A_BYTES, &map_b, c * TC, k0, bar);
      }
    }
    return;
  }

  const int wg = warp / 4;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int c = c0; c < c1; ++c) {
    const int i = c - c0, s = i % STAGES;
    bar_wait(full + 8 * s, (i / STAGES) & 1);
    const uint32_t a = tiles + s * T::STAGE_BYTES + wg * 64 * TC;
    const uint32_t b = tiles + s * T::STAGE_BYTES + T::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC / 32; ++kk)  // the next 32 bytes lie 32 bytes on
      wgmma_s8_ss(acc, gmma_desc(a + kk * 32, 16, ATOM), gmma_desc(b + kk * 32, 16, ATOM));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (i > 0 && threadIdx.x % 128 == 0) bar_arrive(empty + 8 * ((i - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // register i: row r0 + 8 ((i >> 1) & 1), column cl + 8 (i >> 2) + (i & 1)
  const int r0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int cl = k0 + 2 * (lane % 4);
  const bool pairs = K % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= M) continue;
    const float rs = sy[r];
    bf16 *orow = dx + static_cast<long long>(r) * K;
    int *prow = part + (static_cast<long long>(slice) * M + r) * K;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int c = cl + 8 * j;
      const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (split > 1) {
        if (pairs && c + 1 < K) {
          *reinterpret_cast<int2 *>(prow + c) = make_int2(v0, v1);
        } else {
          if (c < K) prow[c] = v0;
          if (c + 1 < K) prow[c + 1] = v1;
        }
        continue;
      }
      const float f0 = __fmul_rn(__int2float_rn(v0), rs);
      const float f1 = __fmul_rn(__int2float_rn(v1), rs);
      if (pairs && c + 1 < K) {
        *reinterpret_cast<__nv_bfloat162 *>(orow + c) = __floats2bfloat162_rn(f0, f1);
      } else {
        if (c < K) orow[c] = __float2bfloat16_rn(f0);
        if (c + 1 < K) orow[c + 1] = __float2bfloat16_rn(f1);
      }
    }
  }
}

// dx = bf16(float(sum over slices of part) * sy[row]), the slices in order
__global__ void __launch_bounds__(256)
    dx_finish(const int *__restrict__ part, const float *__restrict__ sy,
              bf16 *__restrict__ dx, int M, int K, int split) {
  const long long MK = static_cast<long long>(M) * K;
  for (long long e = blockIdx.x * 256ll + threadIdx.x; e < MK; e += gridDim.x * 256ll) {
    int acc = 0;
    for (int s = 0; s < split; ++s) acc += part[s * MK + e];
    dx[e] = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), sy[e / K]));
  }
}

template <int NCONS>
int launch_product(const void *dyq, const void *sy, const void *q, void *dx, void *part,
                   int M, int K, int N, int split, cudaStream_t stream) {
  using T = Tile<NCONS>;
  CUtensorMap ma, mb;
  if (!tensor_map_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, dyq, M, N, N, TC, 64 * NCONS,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N, N, TC, TN,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void *>(dx_product<NCONS>),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((K + TN - 1) / TN, (M + 64 * NCONS - 1) / (64 * NCONS), split);
  dx_product<NCONS><<<grid, T::THREADS, T::SMEM, stream>>>(
      ma, mb, static_cast<const float *>(sy), static_cast<bf16 *>(dx),
      static_cast<int *>(part), M, K, N);
  return cudaGetLastError();
}

// dx_product over `split` slices, then (split > 1) dx_finish
int split_product(const void *dyq, const void *sy, const void *q, void *dx, void *part, int M,
                  int K, int N, int split, cudaStream_t st) {
  const int e = M <= 64 ? launch_product<1>(dyq, sy, q, dx, part, M, K, N, split, st)
                        : launch_product<2>(dyq, sy, q, dx, part, M, K, N, split, st);
  if (e != cudaSuccess || split == 1) return e;
  const long long MK = static_cast<long long>(M) * K;
  const int blocks = static_cast<int>(std::min<long long>((MK + 255) / 256, 4096));
  dx_finish<<<blocks, 256, 0, st>>>(static_cast<const int *>(part),
                                    static_cast<const float *>(sy), static_cast<bf16 *>(dx),
                                    M, K, split);
  return cudaGetLastError();
}

// ------------------------------------------------- #10's wide tile, large M
//
// dx_wide: dyq . q^T for rows enough to fill the card with 128 x 256 output
// tiles (QLoRA's prefix and suffix rows, M ~ 4-6k): 2 M K N int8 operations
// against M N + K N + 2 M K bytes, bound by the tensor cores, whose int8
// peak needs about 170 operations a byte moved into shared memory. A CTA of
// two consumer warpgroups owns rows [m0, m0 + 128) and output columns (rows
// of q) [k0, k0 + 256); each warpgroup runs wgmma m64n256k32 s8 x s8 -> s32
// on its 64 rows into a 128-register int32 accumulator, which reads 384
// bytes of the stage for 64 K operations of a warpgroup: 2x the operations a
// byte of the 128 x 128 tile. Both operands K-major as they lie (the
// contraction N is contiguous in dyq's rows and in q's), fed by TMA through
// a 4-stage ring of 128-byte-swizzled 128-byte contraction chunks (48 KB a
// stage). No producer warp: the warpgroup that releases a stage second
// refills it (a counter a stage), so every thread may hold 255 registers.
// The grid is rastered in groups of GROUP_M row tiles, column tiles inside
// a group, so the CTAs of a wave share their q tiles in L2. The epilogue is
// #8's: bf16(float(acc) * sy), rows past M and columns past K not written.
// Rows too few to fill the card with these tiles (one QLoRA pair's 768
// prefix rows at K 4096 give 96) take #8's split product and dx_finish on
// the prequantised rows instead (ops/quant_matmul.py:dx_prequant_plan).
constexpr int WM = 128;       // rows of dyq a CTA owns: 64 for each consumer warpgroup
constexpr int WN = 256;       // output columns (rows of q) a CTA owns
constexpr int WSTAGES = 4;
constexpr int WTHREADS = 256;
constexpr int GROUP_M = 16;   // row tiles of a raster group
constexpr int WA_BYTES = WM * TC;
constexpr int WSTAGE_BYTES = WA_BYTES + WN * TC;
constexpr int WSMEM = WSTAGES * WSTAGE_BYTES + WSTAGES * 8 + 4 * WSTAGES + ATOM;

__global__ void __launch_bounds__(WTHREADS, 1)
    dx_wide(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const float *__restrict__ sy, bf16 *__restrict__ dx, int M, int K, int N) {
  extern __shared__ __align__(1024) unsigned char smem_wide[];
  const uint32_t tiles = (saddr(smem_wide) + ATOM - 1) / ATOM * ATOM;
  const uint32_t full = tiles + WSTAGES * WSTAGE_BYTES;
  int *s_cnt = reinterpret_cast<int *>(smem_wide + (full + WSTAGES * 8 - saddr(smem_wide)));
  // the raster: groups of GROUP_M row tiles, the row tile fastest inside one
  const int tiles_m = (M + WM - 1) / WM, tiles_k = (K + WN - 1) / WN;
  const int group = blockIdx.x / (GROUP_M * tiles_k);
  const int first = group * GROUP_M, in = blockIdx.x % (GROUP_M * tiles_k);
  const int gm = min(GROUP_M, tiles_m - first);
  const int m0 = (first + in % gm) * WM, k0 = in / gm * WN;
  const int nc = (N + TC - 1) / TC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      bar_init(full + 8 * s, 1);
      s_cnt[s] = 0;
    }
    bar_init_fence();
  }
  __syncthreads();

  // contraction chunk c into its stage: dyq rows, then q rows
  auto load = [&](int c) {
    const int s = c % WSTAGES;
    const uint32_t a = tiles + s * WSTAGE_BYTES, bar = full + 8 * s;
    bar_expect(bar, WSTAGE_BYTES);
    tma_load(a, &map_a, c * TC, m0, bar);
    tma_load(a + WA_BYTES, &map_b, c * TC, k0, bar);
  };
  // this warpgroup is done with chunk c's stage: the second warpgroup to say
  // so refills it with chunk c + WSTAGES
  auto release = [&](int c) {
    if (threadIdx.x % 128 == 0 && (atomicAdd(s_cnt + c % WSTAGES, 1) & 1) && c + WSTAGES < nc)
      load(c + WSTAGES);
  };
  if (threadIdx.x == 0)
    for (int c = 0; c < min(WSTAGES, nc); ++c) load(c);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  for (int c = 0; c < nc; ++c) {
    const int s = c % WSTAGES;
    bar_wait(full + 8 * s, (c / WSTAGES) & 1);
    const uint32_t a = tiles + s * WSTAGE_BYTES + wg * 64 * TC;
    const uint32_t b = tiles + s * WSTAGE_BYTES + WA_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC / 32; ++kk)
      wgmma_s8_ss256(acc, gmma_desc(a + kk * 32, 16, ATOM), gmma_desc(b + kk * 32, 16, ATOM));
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's products are done: release its stage
    if (c > 0) release(c - 1);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // register i: row r0 + 8 ((i >> 1) & 1), column cl + 8 (i >> 2) + (i & 1)
  const int r0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int cl = k0 + 2 * (lane % 4);
  const bool pairs = K % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= M) continue;
    const float row_scale = sy[row];
    bf16 *orow = dx + static_cast<long long>(row) * K;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int col = cl + 8 * j;
      const float f0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), row_scale);
      const float f1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), row_scale);
      if (pairs && col + 1 < K) {
        *reinterpret_cast<__nv_bfloat162 *>(orow + col) = __floats2bfloat162_rn(f0, f1);
      } else {
        if (col < K) orow[col] = __float2bfloat16_rn(f0);
        if (col + 1 < K) orow[col + 1] = __float2bfloat16_rn(f1);
      }
    }
  }
}

int launch_wide(const void *dyq, const void *sy, const void *q, void *dx, int M, int K, int N,
                cudaStream_t stream) {
  CUtensorMap ma, mb;
  if (!tensor_map_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, dyq, M, N, N, TC, WM,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N, N, TC, WN,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void *>(dx_wide),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, WSMEM);
  if (err != cudaSuccess) return err;
  const int grid = (M + WM - 1) / WM * ((K + WN - 1) / WN);
  dx_wide<<<grid, WTHREADS, WSMEM, stream>>>(ma, mb, static_cast<const float *>(sy),
                                              static_cast<bf16 *>(dx), M, K, N);
  return cudaGetLastError();
}

}  // namespace qdx

// ------------------------------------------------------------ #7, redesigned
//
// out = bf16((float(xq . q) * sx) * s) at the rows decoding gives it (M <=
// FWD_SPLIT_MAX_M, ops/quant_matmul.py:fwd_plan), where the weight's K N
// bytes bound it: at M 8-64 each q byte feeds only M products. Two
// launches:
// 1. fwd_quant_rows: one CTA a row quantises x once per call, sx = max(max
//    |x|, 1e-20) / 127 and rn(x / sx) (IEEE, as quantize8 / row_scales),
//    into xq (M, K) int8 and sx (M,), where the TPU kernel quantises the
//    rows again in every column tile; it also zeroes the tile counters of
//    step 2, and lets step 2 launch at once (programmatic dependent launch:
//    step 2 streams its first q tiles while this pass runs and waits for
//    it only before it reads xq, sx and the counters);
// 2. fwd_product: the weight as the wide operand ("swap AB"): out^T (N x M)
//    = q^T . xq^T on mma.sync m16n8k32 s8 x s8 -> s32, so q's N fills the
//    16-row side of the product and the few rows of x its 8-wide side (M
//    rounded up to 8 x MT, no 128-row padding). A CTA owns 128 columns of q
//    and walks one slice of the K contraction (128-row chunks): as many
//    slices as keep (N tiles x K slices) within one CTA an SM, since a
//    slice's partial sums cost more than further CTAs win once the column
//    tiles alone fill most of the card (tools/split_sweep.py); so only the
//    narrow widths (N 4096-6144) split. One producer warp streams the q
//    tile (128 K-rows x 128 columns, as it lies, N-contiguous) and the xq
//    tile (8 MT rows x 128 K-bytes) by TMA through a 3-stage ring of
//    128-byte-swizzled tiles (48 KB of weight in flight a CTA). Eight
//    consumer warps, two for each 32 columns, each take half of a stage's K
//    steps: enough warps to hide the fragment loads and products of one CTA
//    an SM at 64 rows (above 64 rows four warps take all of them: eight
//    would not fit their accumulators in 288 threads' registers). The int8
//    mma takes A K-contiguous, so each thread builds its A fragments from
//    the staged natural tile: four 32-bit loads (4 K-rows x 4 columns) and
//    a 4 x 4 byte transpose give one K-group of four columns, which the
//    thread holds as rows g, g + 8 of two m16 tiles (the rows of out^T are
//    permuted so that a thread's fragment rows are four neighbouring
//    columns; its outputs are then 4 bf16 of a row of out). One slice
//    writes the epilogue itself; several write exact int32 partials (split,
//    M, N), and the CTA that finishes a column tile last (a counter a tile)
//    sums them, several slices' loads in flight at once (int32: exact,
//    |sum| <= 127^2 K < 2^31 for K < 133,000), and writes bf16((float(sum)
//    * sx) * s).
// The output equals qmm_kernel<true, false> (and #9 on the same rows) bit
// for bit whatever the split. Rows TMA cannot map (N or K not a multiple of
// 16, x or q off 16 bytes) and more rows than FWD_SPLIT_MAX_M take that
// kernel.
namespace qfwd {

constexpr int TN = 128;        // columns of q (output columns) a CTA owns
constexpr int TK = 128;        // contraction rows of a stage
constexpr int STAGES = 3;
constexpr int Q_BYTES = TK * TN;
constexpr int ATOM = 1024;

template <int MT>  // MT row tiles of 8: x's rows rounded up
struct Tile {
  // consumer warps: 4 column groups x HALVES halves of a stage's K steps
  // (one half above 64 rows, whose accumulators would not fit 288 threads'
  // registers), and the producer warp
  static constexpr int HALVES = MT <= 8 ? 2 : 1;
  static constexpr int WARPS = 4 * HALVES;
  static constexpr int THREADS = WARPS * 32 + 32;
  static constexpr int X_BYTES = 8 * MT * TK;
  static constexpr int STAGE_BYTES = Q_BYTES + X_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 16 + ATOM;
};

// named barriers of the consumer warps: all of them (id 1), or the 4 that
// write the tile (id 2)
template <int WARPS>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WARPS * 32) : "memory");
}
__device__ __forceinline__ void writers_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// one CTA a row: xq[m] = clamp(rn(x[m] / sx), +-127), sx = max(max |x[m]|,
// 1e-20) / 127; the CTAs also zero the `tiles` counters of fwd_product. K is
// a multiple of 8 and x 16-byte aligned.
__global__ void __launch_bounds__(256)
    fwd_quant_rows(const bf16 *__restrict__ x, int8_t *__restrict__ xq, float *__restrict__ sx,
                   int *__restrict__ cnt, int tiles, int K) {
  __shared__ float red[8];
  grid_launch_dependents();  // fwd_product may start streaming q now
  const long long m = blockIdx.x;
  const bf16 *row = x + m * K;
  float amax = 0.f;
  for (int c = threadIdx.x * 8; c < K; c += 256 * 8) {
    float v[8];
    bf16x8_to_float(load16(row + c), v);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
  const float scale = __fdiv_rn(fmaxf(qdx::block_max(amax, red), 1e-20f), 127.0f);
  if (threadIdx.x == 0) sx[m] = scale;
  for (int c = threadIdx.x * 8; c < K; c += 256 * 8) {
    float v[8];
    bf16x8_to_float(load16(row + c), v);
    *reinterpret_cast<uint2 *>(xq + m * K + c) = quantize8(v, scale);
  }
  for (int i = blockIdx.x * 256 + threadIdx.x; i < tiles; i += gridDim.x * 256) cnt[i] = 0;
}

// One CTA: output columns [n0, n0 + 128) of every row, the contraction over
// chunk slice blockIdx.y. Warps 0 .. WARPS - 1 consume (warp w: columns n0
// + 32 (w % 4) .. + 31, the K steps of its half w / 4 of every stage; the
// second half's sums join the first's through shared memory at the end),
// warp WARPS produces.
template <int MT>
__global__ void __launch_bounds__(Tile<MT>::THREADS)
    fwd_product(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_x, const float *__restrict__ sx,
                const float *__restrict__ s, bf16 *__restrict__ out, int *__restrict__ part,
                int *__restrict__ cnt, int M, int K, int N) {
  using T = Tile<MT>;
  constexpr int WARPS = T::WARPS;
  extern __shared__ __align__(1024) unsigned char smem_fwd[];
  const uint32_t base = saddr(smem_fwd);
  const uint32_t off = (base + ATOM - 1) / ATOM * ATOM - base;  // first tile, 1024-aligned
  const uint32_t full = base + off + STAGES * T::STAGE_BYTES;
  const uint32_t empty = full + STAGES * 8;
  int *s_last = reinterpret_cast<int *>(smem_fwd + off + STAGES * T::STAGE_BYTES + 2 * STAGES * 8);
  const int n0 = blockIdx.x * TN, slice = blockIdx.y, split = gridDim.y;
  int c0, c1;
  qdx::slice_range(slice, split, (K + TK - 1) / TK, c0, c1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      bar_init(full + 8 * st, 1);
      bar_init(empty + 8 * st, WARPS);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp == WARPS) {  // the producer: one thread starts every load
    if (lane == 0) {
      // the first stages' q tiles go out before the row pass has finished
      // (a programmatic launch: fwd_quant_rows may still run); their xq
      // tiles, and every later stage, after it
      const int first = min(c1 - c0, STAGES);
      for (int i = 0; i < first; ++i) {
        const uint32_t dst = base + off + i * T::STAGE_BYTES, bar = full + 8 * i;
        bar_expect(bar, T::STAGE_BYTES);
        tma_load(dst, &map_q, n0, (c0 + i) * TK, bar);
      }
      grid_dependency_wait();
      for (int i = 0; i < first; ++i)
        tma_load(base + off + i * T::STAGE_BYTES + Q_BYTES, &map_x, (c0 + i) * TK, 0,
                 full + 8 * i);
      for (int c = c0 + first; c < c1; ++c) {
        const int i = c - c0, st = i % STAGES;
        bar_wait(empty + 8 * st, (i / STAGES - 1) & 1);
        const uint32_t dst = base + off + st * T::STAGE_BYTES, bar = full + 8 * st;
        bar_expect(bar, T::STAGE_BYTES);
        tma_load(dst, &map_q, n0, c * TK, bar);
        tma_load(dst + Q_BYTES, &map_x, c * TK, 0, bar);
      }
    }
    return;
  }
  grid_dependency_wait();  // sx and the counters come from the row pass

  const int g = lane / 4, t = lane % 4, half = warp / 4;
  // this thread's four neighbouring columns: a byte offset in a q row
  const int qcol = 32 * (warp % 4) + 4 * g, qchunk = qcol >> 4, qbyte = qcol & 15;
  // acc[u][j][e]: column n0 + qcol + 2 u + (e >> 1), row 8 j + 2 t + (e & 1)
  int acc[2][MT][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][j][e] = 0;

  for (int c = c0; c < c1; ++c) {
    const int i = c - c0, st = i % STAGES;
    bar_wait(full + 8 * st, (i / STAGES) & 1);
    const int8_t *qs = reinterpret_cast<const int8_t *>(smem_fwd + off + st * T::STAGE_BYTES);
    const int8_t *xs = qs + Q_BYTES;
#pragma unroll
    for (int kk = 0; kk < TK / 32 / T::HALVES; ++kk) {
      const int ks = TK / 32 / T::HALVES * half + kk;  // this half's 32-row K steps
      // A: rows g, g + 8 of tile u are columns qcol + 2 u, qcol + 2 u + 1;
      // K-group h holds contraction rows 32 ks + 16 h + 4 t + (0..3)
      uint32_t a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[4], o[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // 128-byte swizzle: chunk c at c ^ (row % 8)
          const int k = 32 * ks + 16 * h + 4 * t + r;  // k % 8 == 4 (t % 2) + r
          w[r] = ld32(qs + k * 128 + (((qchunk ^ (4 * (t & 1) + r)) << 4) | qbyte));
        }
        transpose4x4(w, o);  // o[j] byte r: q[row 32 ks + 16 h + 4 t + r][column qcol + j]
        a[0][2 * h] = o[0];
        a[0][2 * h + 1] = o[1];
        a[1][2 * h] = o[2];
        a[1][2 * h + 1] = o[3];
      }
      // B: xq row 8 j + g (swizzled by g), bytes 32 ks + 4 t and + 16
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int8_t *xr = xs + (8 * j + g) * 128 + 4 * t;
        const uint32_t b[2] = {ld32(xr + (((2 * ks) ^ g) << 4)),
                               ld32(xr + (((2 * ks + 1) ^ g) << 4))};
        mma_s8(acc[0][j], a[0], b);
        mma_s8(acc[1][j], a[1], b);
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty + 8 * st);
  }

  // the second half's sums into the first's, through the ring (every
  // stage has been read: all consumers passed the last full barrier)
  if constexpr (T::HALVES == 2) {
    int *red = reinterpret_cast<int *>(smem_fwd + off);
    const int slot = (warp % 4) * 32 + lane;
    consumers_sync<WARPS>();
    if (half == 1) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[((u * MT + j) * 4 + e) * 128 + slot] = acc[u][j][e];
    }
    consumers_sync<WARPS>();
    if (half == 1) return;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][j][e] += red[((u * MT + j) * 4 + e) * 128 + slot];
  }

  const int col = n0 + qcol;  // N % 16 == 0: col < N covers col + 3
  if (split > 1) {
    // every slice stores its exact partial; the tile's last CTA adds the
    // others' to its own
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 8 * j + 2 * t + e;
        if (row < M && col < N)
          *reinterpret_cast<int4 *>(part + (static_cast<long long>(slice) * M + row) * N + col) =
              make_int4(acc[0][j][e], acc[0][j][2 + e], acc[1][j][e], acc[1][j][2 + e]);
      }
    __threadfence();
    writers_sync();
    if (threadIdx.x == 0) *s_last = atomicAdd(cnt + blockIdx.x, 1) == split - 1;
    writers_sync();
    if (!*s_last) return;
    __threadfence();
    // U slices at a time, all of their loads in flight together
    constexpr int U = MT <= 2 ? 4 : MT <= 4 ? 2 : 1;
    for (int s0 = 0; s0 < split; s0 += U) {
      int4 p[U][MT][2];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int sl = s0 + u, row = 8 * j + 2 * t + e;
            p[u][j][e] = sl < split && sl != slice && row < M && col < N
                             ? __ldcg(reinterpret_cast<const int4 *>(
                                   part + (static_cast<long long>(sl) * M + row) * N + col))
                             : make_int4(0, 0, 0, 0);
          }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            acc[0][j][e] += p[u][j][e].x;
            acc[0][j][2 + e] += p[u][j][e].y;
            acc[1][j][e] += p[u][j][e].z;
            acc[1][j][2 + e] += p[u][j][e].w;
          }
    }
  }
  if (col >= N) return;
  float cs[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) cs[e] = s[col + e];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = 8 * j + 2 * t + e;
      if (row >= M) continue;
      const float rs = sx[row];
      const int v[4] = {acc[0][j][e], acc[0][j][2 + e], acc[1][j][e], acc[1][j][2 + e]};
      float f[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) f[u] = __fmul_rn(__fmul_rn(__int2float_rn(v[u]), rs), cs[u]);
      *reinterpret_cast<uint2 *>(out + static_cast<long long>(row) * N + col) =
          make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
    }
}

template <int MT>
int launch_product(const void *xq, const void *sx, const void *q, const void *s, void *out,
                   void *part, void *cnt, int M, int K, int N, int split, cudaStream_t stream) {
  using T = Tile<MT>;
  CUtensorMap mq, mx;
  if (!tensor_map_2d(&mq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N, N, TN, TK,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, K, TK, 8 * MT,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  static bool smem_set = false;  // once a process: a decode step calls this 128 times
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void *>(fwd_product<MT>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  // launched while the row pass still runs: it waits for that pass's
  // results (griddepcontrol.wait) only where it reads them
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + TN - 1) / TN, split);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fwd_product<MT>, mq, mx, static_cast<const float *>(sx),
                            static_cast<const float *>(s), static_cast<bf16 *>(out),
                            static_cast<int *>(part), static_cast<int *>(cnt), M, K, N);
}

// fwd_product's instance for `rows` (8 MT: 8, 16, 24, 32, 48, 64, 96 or
// 128 rows); cudaErrorInvalidValue for another count
int product_by_rows(int rows, const void *xq, const void *sx, const void *q, const void *s,
                    void *out, void *part, void *cnt, int M, int K, int N, int split,
                    cudaStream_t st) {
#define RLAIFV_FWD_CASE(R, MT) \
  case R: return launch_product<MT>(xq, sx, q, s, out, part, cnt, M, K, N, split, st);
  switch (rows) {
    RLAIFV_FWD_CASE(8, 1)
    RLAIFV_FWD_CASE(16, 2)
    RLAIFV_FWD_CASE(24, 3)
    RLAIFV_FWD_CASE(32, 4)
    RLAIFV_FWD_CASE(48, 6)
    RLAIFV_FWD_CASE(64, 8)
    RLAIFV_FWD_CASE(96, 12)
    RLAIFV_FWD_CASE(128, 16)
    default: return cudaErrorInvalidValue;
  }
#undef RLAIFV_FWD_CASE
}

}  // namespace qfwd

// ------------------------------------------------------------ #9, redesigned
//
// out = bf16((float(xq . q) * sx) * s) on prequantised rows at the row
// counts of a prefill or a QLoRA step (M ~ 10^2 - 10^4): 2 M K N int8
// operations against M K + K N + 2 M N bytes, bound by the tensor cores.
// The contraction K is the row axis of q, which lies N-contiguous, and int8
// wgmma takes both operands K-major with no transpose flag, so the weight is
// the A operand ("swap AB": out^T = q^T . xq^T) and q^T is built in
// registers, where int8 wgmma accepts A; B = xq is K-major as it lies.
// fwd_wide: a CTA of two consumer warpgroups (no producer warp) owns rows
// [m0, m0 + 128) of xq and columns [n0, n0 + 256) of q, each warpgroup 128 of
// the columns as two m64n128k32 s8 x s8 -> s32 products (two 64-register
// int32 accumulators) sharing one B tile. A 4-stage TMA ring of
// 128-byte-swizzled tiles (two 128 x 128 boxes of q as it lies, one 128 x 128
// box of xq: 48 KB a stage); the warpgroup that releases a stage second
// refills it. Each thread builds its A fragments from the staged natural q
// tile as qfwd::fwd_product does (four 32-bit loads of 4 K-rows x 4 columns
// and a 4 x 4 byte transpose give one K-group of four neighbouring columns;
// the rows of out^T are permuted so that those four columns are the rows
// of the thread's two products' fragments), the rows a load reads permuted
// by lane so that one load instruction hits no bank twice. The fragments of
// the next KS 32-row K steps are built while the products of earlier steps
// run (NBUF sets of 8 KS registers), so the transposes hide under the tensor
// cores.
// The grid is rastered in groups of GROUP_M row tiles, as #10's wide tile. A
// thread's outputs are 4 neighbouring columns of a row: one 8-byte store
// each. The tile takes any row count: a K split for rows too few to fill the
// card (the tile's last CTA summing int32 partials) read slower than the
// unsplit tile at M 128 on the H100, so none is made.
namespace qpre {

constexpr int TM = 128;         // rows of xq a CTA owns
constexpr int TN = 256;         // columns of q a CTA owns: 128 a warpgroup
constexpr int TK = 128;         // contraction rows of a stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int GROUP_M = 16;     // row tiles of a raster group
constexpr int BOX_BYTES = TK * 128;  // one 128-column box of q, or the xq tile
constexpr int STAGE_BYTES = 3 * BOX_BYTES;
constexpr int ATOM = 1024;
constexpr int SMEM = STAGES * STAGE_BYTES + STAGES * 8 + 4 * STAGES + ATOM;

constexpr int KS = 2;              // 32-row K steps a fragment set holds
constexpr int SETS = TK / 32 / KS;  // fragment sets a stage
constexpr int NBUF = 2;            // fragment sets in registers: NBUF - 1 in flight
static_assert(SETS % NBUF == 0, "every stage starts on the first fragment set");

// this thread's A fragments of KS K steps: a[ks][u] for product u (columns
// qcol + 2 u, qcol + 2 u + 1 as its rows g, g + 8)
using Frags = uint32_t[KS][2][4];

// A fragments of set `set` from the stage's q box (128 K-rows x 128
// columns, 128-byte swizzle: row k's chunk c at chunk c ^ (k % 8)). A warp's
// load reads 2 neighbouring chunks of 4 rows, one a lane group t, whose
// swizzle phases 4 (t % 2) + r would repeat for t and t + 2 (a 2-way bank
// conflict): load i of lanes t >= 2 reads row r = i ^ 2 of its 4-row group
// instead, which puts the 4 rows' chunk pairs on 8 distinct chunks, and the
// words are swapped back.
__device__ __forceinline__ void build_frags(Frags &a, const int8_t *qs, int set, int t,
                                            int qchunk, int qbyte) {
  const int rot = 2 * (t >> 1);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v[4], w[4], o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i ^ rot;
        const int k = 32 * (set * KS + ks) + 16 * h + 4 * t + r;  // k % 8 == 4 (t % 2) + r
        v[i] = ld32(qs + k * 128 + (((qchunk ^ (4 * (t & 1) + r)) << 4) | qbyte));
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) w[r] = rot ? v[r ^ 2] : v[r];
      transpose4x4(w, o);  // o[j] byte r: q[row 32 kk + 16 h + 4 t + r][column qcol + j]
      a[ks][0][2 * h] = o[0];
      a[ks][0][2 * h + 1] = o[1];
      a[ks][1][2 * h] = o[2];
      a[ks][1][2 * h + 1] = o[3];
    }
}

// One CTA: tile blockIdx.x (rastered).
__global__ void __launch_bounds__(THREADS, 1)
    fwd_wide(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_x,
             const float *__restrict__ sx, const float *__restrict__ s, bf16 *__restrict__ out,
             int M, int K, int N) {
  extern __shared__ __align__(1024) unsigned char smem_pre[];
  const uint32_t base = saddr(smem_pre);
  const uint32_t off = (base + ATOM - 1) / ATOM * ATOM - base;
  const uint32_t tiles = base + off;
  const uint32_t full = tiles + STAGES * STAGE_BYTES;
  int *s_cnt = reinterpret_cast<int *>(smem_pre + off + STAGES * STAGE_BYTES + STAGES * 8);
  const int tiles_m = (M + TM - 1) / TM, tiles_n = (N + TN - 1) / TN;
  const int group = blockIdx.x / (GROUP_M * tiles_n);
  const int first = group * GROUP_M, in = blockIdx.x % (GROUP_M * tiles_n);
  const int gm = min(GROUP_M, tiles_m - first);
  const int m0 = (first + in % gm) * TM, n0 = in / gm * TN;
  const int chunks = (K + TK - 1) / TK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      bar_init(full + 8 * st, 1);
      s_cnt[st] = 0;
    }
    bar_init_fence();
  }
  __syncthreads();

  // chunk c into its stage: q columns n0 .. + 127, n0 + 128 .. + 255, xq rows
  auto load = [&](int c) {
    const uint32_t dst = tiles + (c % STAGES) * STAGE_BYTES, bar = full + 8 * (c % STAGES);
    bar_expect(bar, STAGE_BYTES);
    tma_load(dst, &map_q, n0, c * TK, bar);
    tma_load(dst + BOX_BYTES, &map_q, n0 + 128, c * TK, bar);
    tma_load(dst + 2 * BOX_BYTES, &map_x, c * TK, m0, bar);
  };
  // this warpgroup is done with chunk c's stage: the second to say so
  // refills it with chunk c + STAGES
  auto release = [&](int c) {
    if (threadIdx.x % 128 == 0 && (atomicAdd(s_cnt + c % STAGES, 1) & 1) && c + STAGES < chunks)
      load(c + STAGES);
  };
  if (threadIdx.x == 0)
    for (int c = 0; c < min(STAGES, chunks); ++c) load(c);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  // this thread's four neighbouring columns: a byte offset in a q box row
  const int qcol = 32 * (warp % 4) + 4 * g, qchunk = qcol >> 4, qbyte = qcol & 15;
  int acc[2][64];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[u][i] = 0;
  fence_acc(acc[0]);
  fence_acc(acc[1]);

  auto stage_q = [&](int c) {
    return reinterpret_cast<const int8_t *>(smem_pre + off + (c % STAGES) * STAGE_BYTES +
                                            wg * BOX_BYTES);
  };
  // fragment set `set` of chunk c: the two products of each of its K
  // steps; B: the xq tile, K-major, the step's 32 bytes
  auto issue = [&](const Frags &a, int c, int set) {
    const uint32_t xs = tiles + (c % STAGES) * STAGE_BYTES + 2 * BOX_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        wgmma_s8_rs(acc[u], a[ks][u], gmma_desc(xs + (set * KS + ks) * 32, 16, ATOM));
    wgmma_commit();
  };
  // NBUF fragment sets: while the products of NBUF - 1 sets read theirs,
  // the next set is built into the last; wgmma_wait<NBUF - 1> frees the one
  // read NBUF sets back
  Frags fr[NBUF];
  bar_wait(full, 0);
  build_frags(fr[0], stage_q(0), 0, t, qchunk, qbyte);
  for (int c = 0; c < chunks; ++c) {
    const int8_t *qs = stage_q(c);
#pragma unroll
    for (int set = 0; set < SETS; ++set) {
      issue(fr[set % NBUF], c, set);
      wgmma_wait<NBUF - 1>();  // the set NBUF - 1 before this one is done
      if (set == NBUF - 2 && c > 0) release(c - 1);  // ... chunk c - 1's last
      if (set + 1 < SETS) {
        build_frags(fr[(set + 1) % NBUF], qs, set + 1, t, qchunk, qbyte);
      } else if (c + 1 < chunks) {
        bar_wait(full + 8 * ((c + 1) % STAGES), ((c + 1) / STAGES) & 1);
        build_frags(fr[0], stage_q(c + 1), 0, t, qchunk, qbyte);
      }
    }
  }
  wgmma_wait<0>();
  fence_acc(acc[0]);
  fence_acc(acc[1]);

  // register i of product u: column n0 + 128 wg + qcol + 2 u + ((i >> 1) & 1),
  // row m0 + 8 (i >> 2) + 2 t + (i & 1)
  const int col = n0 + 128 * wg + qcol;  // N % 16 == 0: col < N covers col + 3
  if (col >= N) return;
  float colscale[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) colscale[e] = s[col + e];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t + e;
      if (m >= M) continue;
      const float rowscale = sx[m];
      const int v[4] = {acc[0][4 * j + e], acc[0][4 * j + 2 + e], acc[1][4 * j + e],
                        acc[1][4 * j + 2 + e]};
      float f[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        f[u] = __fmul_rn(__fmul_rn(__int2float_rn(v[u]), rowscale), colscale[u]);
      *reinterpret_cast<uint2 *>(out + static_cast<long long>(m) * N + col) =
          make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
    }
}

int launch_wide(const void *xq, const void *sx, const void *q, const void *s, void *out, int M,
                int K, int N, cudaStream_t stream) {
  CUtensorMap mq, mx;
  if (!tensor_map_2d(&mq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N, N, 128, TK,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, K, TK, TM,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void *>(fwd_wide), cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int grid = (M + TM - 1) / TM * ((N + TN - 1) / TN);
  fwd_wide<<<grid, THREADS, SMEM, stream>>>(mq, mx, static_cast<const float *>(sx),
                                            static_cast<const float *>(s),
                                            static_cast<bf16 *>(out), M, K, N);
  return cudaGetLastError();
}

}  // namespace qpre

}  // namespace

// #7: x (M, K) bf16, q (K, N) int8, s (N,) fp32 -> out (M, N) bf16 by the
// route ops/quant_matmul.py:fwd_plan picks: 0 the cp.async kernel (rows TMA
// cannot map, more rows than the split product takes), 1 the row pass and
// the split product over `rows` (M rounded up to 8, 16, 24, 32, 48, 64, 96
// or 128) and `split` slices of the K contraction. Scratch from the wrapper
// for route 1: xq (M, K) int8, sx (M,) fp32 and, with split > 1, part
// (split, M, N) int32 and cnt (ceil(N / 128),) int32. A route TMA cannot
// take, or a split out of [1, ceil(K / 128)], is refused.
extern "C" int int8_matmul_bf16(const void *x, const void *q, const void *s, void *xq,
                                void *sx, void *part, void *cnt, void *out, int M, int K,
                                int N, int route, int rows, int split, void *stream) {
  if (M <= 0 || K <= 0 || N <= 0 || route < 0 || route > 1) return cudaErrorInvalidValue;
  if (route == 0) return launch<true, false>(x, nullptr, q, s, out, M, K, N, stream);
  const auto aligned = [](const void *p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (N % 16 != 0 || K % 16 != 0 || !aligned(x) || !aligned(q) || !aligned(xq) ||
      sx == nullptr || rows < M || split < 1 || split > (K + qfwd::TK - 1) / qfwd::TK ||
      (split > 1 && (part == nullptr || cnt == nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (N + qfwd::TN - 1) / qfwd::TN;
  qfwd::fwd_quant_rows<<<M, 256, 0, st>>>(static_cast<const bf16 *>(x),
                                          static_cast<int8_t *>(xq), static_cast<float *>(sx),
                                          static_cast<int *>(cnt), split > 1 ? tiles : 0, K);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return qfwd::product_by_rows(rows, xq, sx, q, s, out, part, cnt, M, K, N, split, st);
}

// #8: dy (M, N) bf16, q (K, N) int8, s (N,) fp32 -> dx (M, K) bf16. Scratch
// from the wrapper: dyq (M, N) int8, sy (M,) fp32 and, with split > 1,
// part (split, M, K) int32; split in [1, ceil(N / 128)], 1 where N % 16 != 0.
extern "C" int int8_matmul_dx_bf16(const void *dy, const void *q, const void *s,
                                   void *dyq, void *sy, void *part, void *dx, int M, int K,
                                   int N, int split, void *stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tma = N % 16 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  if (M <= 0 || K <= 0 || N <= 0 || split < 1 || split > (N + qdx::TC - 1) / qdx::TC ||
      (split > 1 && (part == nullptr || !tma)))
    return cudaErrorInvalidValue;
  qdx::dx_quant_rows<<<M, 256, 0, st>>>(static_cast<const bf16 *>(dy),
                                       static_cast<const float *>(s),
                                       static_cast<int8_t *>(dyq), static_cast<float *>(sy), N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (!tma)  // rows TMA cannot map: the cp.async kernel on the quantised rows
    return launch<false, true>(dyq, sy, q, nullptr, dx, M, K, N, stream);
  return qdx::split_product(dyq, sy, q, dx, part, M, K, N, split, st);
}

// #9: xq (M, K) int8, sx (M,) fp32, q (K, N) int8, s (N,) fp32 -> out (M, N)
// bf16 by the route ops/quant_matmul.py:fwd_prequant_plan picks: 0 the
// cp.async kernel (rows TMA cannot map: N or K not a multiple of 16, xq or q
// off 16 bytes), 1 the wide tile. A route TMA cannot take is refused.
extern "C" int int8_matmul_prequant_bf16(const void *xq, const void *sx, const void *q,
                                         const void *s, void *out, int M, int K, int N,
                                         int route, void *stream) {
  const auto aligned = [](const void *p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool tma = N % 16 == 0 && K % 16 == 0 && aligned(q) && aligned(xq);
  if (M <= 0 || K <= 0 || N <= 0 || route < 0 || route > 1 || (route == 1 && !tma))
    return cudaErrorInvalidValue;
  if (route == 0) return launch<true, true>(xq, sx, q, s, out, M, K, N, stream);
  return qpre::launch_wide(xq, sx, q, s, out, M, K, N, static_cast<cudaStream_t>(stream));
}

// The prequant wrappers' row passes (#7's and #8's, bit for bit
// quantize_rows): x (M, K) bf16 -> xq (M, K) int8, sx (M,) fp32; with s
// (N,) fp32 given, v = x * s is quantised instead (#10's dy * s). One CTA a
// row.
extern "C" int int8_quant_rows_bf16(const void *x, const void *s, void *xq, void *sx, int M,
                                    int K, void *stream) {
  if (M <= 0 || K <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s == nullptr && K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0)
    qfwd::fwd_quant_rows<<<M, 256, 0, st>>>(static_cast<const bf16 *>(x),
                                            static_cast<int8_t *>(xq), static_cast<float *>(sx),
                                            nullptr, 0, K);
  else
    qdx::dx_quant_rows<<<M, 256, 0, st>>>(static_cast<const bf16 *>(x),
                                         static_cast<const float *>(s), static_cast<int8_t *>(xq),
                                         static_cast<float *>(sx), K);
  return cudaGetLastError();
}

// #10: dyq (M, N) int8, sy (M,) fp32, q (K, N) int8 -> dx (M, K) bf16 by
// the route ops/quant_matmul.py:dx_prequant_plan picks: 0 the cp.async
// kernel (rows TMA cannot map: N % 16 != 0, or dyq or q off 16 bytes), 1
// the wide tile (split 1), 2 #8's product over `split` slices of the N
// contraction (part (split, M, K) int32 scratch with split > 1) and the sum
// of their partials. A route TMA cannot take, or a split out of [1, ceil(N /
// 128)], is refused.
extern "C" int int8_matmul_dx_prequant_bf16(const void *dyq, const void *sy, const void *q,
                                            void *part, void *dx, int M, int K, int N,
                                            int route, int split, void *stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tma = N % 16 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(dyq) & 15) == 0;
  if (M <= 0 || K <= 0 || N <= 0 || route < 0 || route > 2 || (route > 0 && !tma) ||
      split < 1 || split > (N + qdx::TC - 1) / qdx::TC || (route != 2 && split != 1) ||
      (split > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (route == 0) return launch<false, true>(dyq, sy, q, nullptr, dx, M, K, N, stream);
  if (route == 1) return qdx::launch_wide(dyq, sy, q, dx, M, K, N, st);
  return qdx::split_product(dyq, sy, q, dx, part, M, K, N, split, st);
}
