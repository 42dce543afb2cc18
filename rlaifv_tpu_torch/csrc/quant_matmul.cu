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
// What the design does about it (#7, #9, #10; #8 in qdx below): each CTA
// owns a 128 x 128 output tile and walks the contraction in 64-wide chunks
// through two shared-memory stages
// (cp.async for int8 operands), 8 warps each issuing mma.sync m16n8k32
// s8 x s8 -> s32 on a 32 x 64 sub-tile. The int8 mma takes both operands
// contraction-contiguous (.row.col):
// - dx contracts over N, and a row of q (K, N) is already N-contiguous: q
//   tiles load as they lie, no q^T anywhere;
// - the forward contracts over K, so each (64 K-rows x 128 N) q tile is
//   staged as it lies (16-byte chunks XOR-swizzled across banks) and
//   transposed in shared memory with byte permutes into a K-contiguous
//   tile. Neither q^T nor a second copy of the weight exists in device
//   memory.
// The in-kernel-quantisation kernel (#7) first takes each of its 128 rows'
// absolute maximum over the whole contraction (as the TPU kernel quantises
// its row stripe in every program), then quantises each bf16 chunk into
// shared memory as it arrives, loading the next chunk into registers while
// the current one multiplies. That costs an IEEE division per element in
// every column CTA, the TPU kernel's redundancy across N tiles, where the
// prequant pair divides once per element in torch. Ragged edges (M, N, K
// not a multiple of the tile, rows whose length is not a multiple of 16
// bytes) read as zeros, which add exact zeros, and are never written.
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

// one CTA a row: dyq[m] = clamp(rn(v / sy), +-127) with v = dy[m] * s
__global__ void __launch_bounds__(256)
    dx_quant_rows(const bf16 *__restrict__ dy, const float *__restrict__ s,
                  int8_t *__restrict__ dyq, float *__restrict__ sy, int N) {
  __shared__ float red[8];
  const long long m = blockIdx.x;
  const bf16 *row = dy + m * N;
  float amax = 0.f;
  for (int n = threadIdx.x; n < N; n += 256)
    amax = fmaxf(amax, fabsf(__fmul_rn(__bfloat162float(row[n]), s[n])));
  const float scale = __fdiv_rn(fmaxf(block_max(amax, red), 1e-20f), 127.0f);
  if (threadIdx.x == 0) sy[m] = scale;
  int8_t *out = dyq + m * N;
  for (int n = threadIdx.x; n < N; n += 256) {
    const int q = __float2int_rn(__fdiv_rn(__fmul_rn(__bfloat162float(row[n]), s[n]), scale));
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

}  // namespace qdx

}  // namespace

// #7: x (M, K) bf16, q (K, N) int8, s (N,) fp32 -> out (M, N) bf16
extern "C" int int8_matmul_bf16(const void *x, const void *q, const void *s, void *out,
                                int M, int K, int N, void *stream) {
  return launch<true, false>(x, nullptr, q, s, out, M, K, N, stream);
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
  if (!tma)  // rows TMA cannot map: #10's kernel on the quantised rows
    return launch<false, true>(dyq, sy, q, nullptr, dx, M, K, N, stream);
  const int e = M <= 64 ? qdx::launch_product<1>(dyq, sy, q, dx, part, M, K, N, split, st)
                        : qdx::launch_product<2>(dyq, sy, q, dx, part, M, K, N, split, st);
  if (e != cudaSuccess || split == 1) return e;
  const long long MK = static_cast<long long>(M) * K;
  const int blocks = static_cast<int>(std::min<long long>((MK + 255) / 256, 4096));
  qdx::dx_finish<<<blocks, 256, 0, st>>>(static_cast<const int *>(part),
                                        static_cast<const float *>(sy),
                                        static_cast<bf16 *>(dx), M, K, split);
  return cudaGetLastError();
}

// #9: xq (M, K) int8, sx (M,) fp32, q (K, N) int8, s (N,) fp32 -> out (M, N) bf16
extern "C" int int8_matmul_prequant_bf16(const void *xq, const void *sx, const void *q,
                                         const void *s, void *out, int M, int K, int N,
                                         void *stream) {
  return launch<true, true>(xq, sx, q, s, out, M, K, N, stream);
}

// #10: dyq (M, N) int8, sy (M,) fp32, q (K, N) int8 -> dx (M, K) bf16
extern "C" int int8_matmul_dx_prequant_bf16(const void *dyq, const void *sy, const void *q,
                                            void *dx, int M, int K, int N, void *stream) {
  return launch<false, true>(dyq, sy, q, nullptr, dx, M, K, N, stream);
}
