// int8 weight-only matrix products for Hopper (sm_90a): the forward and
// the input gradient of y = x (q * s) with the weight q (K, N) kept int8 in
// device memory, its per-output-channel scales s (N,) fp32. bf16 in and out,
// int8 x int8 -> int32 on the tensor cores.
//
// Replaces, in rlaifv_tpu/ops/quant_matmul.py:
//   #7  _kernel             (int8_matmul):             x quantised per row in the kernel
//   #8  _dx_kernel          (int8_matmul_dx):          dy * s quantised per row in the kernel
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
// What the design does about it: each CTA owns a 128 x 128 output tile and
// walks the contraction in 64-wide chunks through two shared-memory stages
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
// The in-kernel-quantisation kernels (#7, #8) first take each of their 128
// rows' absolute maximum over the whole contraction (as the TPU kernel
// quantises its row stripe in every program), then quantise each bf16
// chunk into shared memory as it arrives, loading the next chunk into
// registers while the current one multiplies. That costs an IEEE division
// per element in every column CTA, the TPU kernel's redundancy across N
// tiles, where the prequant pair divides once per element in torch. Ragged edges (M, N, K not a
// multiple of the tile, rows whose length is not a multiple of 16 bytes)
// read as zeros, which add exact zeros, and are never written. wgmma, TMA
// and larger tiles are left for a later change.
#include <stdint.h>

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
// (M, C), multiplied by `acol` (C,) first when !FWD, and quantised here.
// `ocol` (N,) scales the forward's output columns.
template <bool FWD, bool PREQ>
__global__ void __launch_bounds__(NTHREADS)
    qmm_kernel(const void *__restrict__ a, const float *__restrict__ arow,
               const float *__restrict__ acol, const int8_t *__restrict__ q,
               const float *__restrict__ ocol, bf16 *__restrict__ out, int M, int K,
               int N) {
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
    row_scales<!FWD, BM, NTHREADS>(srow, a16, acol, m0, M, C, a_vec);
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
      if constexpr (!FWD) scale_cols(va[i], acol, c, C);
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
int launch(const void *a, const void *arow, const void *acol, const void *q,
           const void *ocol, void *out, int M, int K, int N, void *stream) {
  const int NO = FWD ? N : K;
  const dim3 grid((NO + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_kernel<FWD, PREQ><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float *>(arow), static_cast<const float *>(acol),
      static_cast<const int8_t *>(q), static_cast<const float *>(ocol),
      static_cast<bf16 *>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// #7: x (M, K) bf16, q (K, N) int8, s (N,) fp32 -> out (M, N) bf16
extern "C" int int8_matmul_bf16(const void *x, const void *q, const void *s, void *out,
                                int M, int K, int N, void *stream) {
  return launch<true, false>(x, nullptr, nullptr, q, s, out, M, K, N, stream);
}

// #8: dy (M, N) bf16, q (K, N) int8, s (N,) fp32 -> dx (M, K) bf16
extern "C" int int8_matmul_dx_bf16(const void *dy, const void *q, const void *s,
                                   void *dx, int M, int K, int N, void *stream) {
  return launch<false, false>(dy, nullptr, s, q, nullptr, dx, M, K, N, stream);
}

// #9: xq (M, K) int8, sx (M,) fp32, q (K, N) int8, s (N,) fp32 -> out (M, N) bf16
extern "C" int int8_matmul_prequant_bf16(const void *xq, const void *sx, const void *q,
                                         const void *s, void *out, int M, int K, int N,
                                         void *stream) {
  return launch<true, true>(xq, sx, nullptr, q, s, out, M, K, N, stream);
}

// #10: dyq (M, N) int8, sy (M,) fp32, q (K, N) int8 -> dx (M, K) bf16
extern "C" int int8_matmul_dx_prequant_bf16(const void *dyq, const void *sy, const void *q,
                                            void *dx, int M, int K, int N, void *stream) {
  return launch<false, true>(dyq, sy, nullptr, q, nullptr, dx, M, K, N, stream);
}
