// int4 weight-only matrix products for Hopper (sm_90a): the forward and the
// input gradient of y = x W with W (K, N) kept nibble-packed in device memory,
// qp (K/2, N) int8, and its group scales gs (K/G, N) fp32, G a multiple of
// 128 (128 on every model the package builds). bf16 in and out, int8 x int8
// -> int32 on the tensor cores.
//
// Replaces, in rlaifv_tpu/ops/int4_matmul.py:
//   #11 _kernel    (:135, int4_matmul):    the rows of x quantised beforehand
//   #12 _dx_kernel (:240, int4_matmul_dx): dy * gs[j] quantised per row, for
//                                          each output group j, in the kernel
//
// The layout (pack_int4): within group i, byte row r of qp holds weight row
// i G + r in its low nibble and row i G + G/2 + r in its high nibble, so 64
// byte rows of one group are 128 weight rows, two runs of 64.
//
// The function, as the TPU kernels compute it (every rounding separate:
// __fmul_rn / __fadd_rn, which nvcc's default -fmad=true does not contract):
//   forward  out = bf16((sum over groups g in order of
//                        float(xq . w4[g]) * gs[g]) * sx)
//   dx       for each group j: v = dy * gs[j], sy = max(max_n |v|, 1e-20) / 127,
//            vq = clamp(rn(v / sy), +-127),
//            dx[:, group j] = bf16(float(vq . w4[group j]^T) * sy)
// Each int32 sum is exact and below 2^24 (127 x 8 x 128 for a group of the
// forward, 127 x 8 x N for dx up to N = 16512), so float() is exact, and the
// divisions are IEEE (__fdiv_rn, __float2int_rn rounding half to even): every
// kernel equals its plain PyTorch twin bit for bit.
//
// What bounds it on the H100: int8 tensor-core operations, 2 M K N at 1,979
// TOP/s. At the 8-pair QLoRA step's prefix (M = 6144) that is 0.280 ms for
// the forward at K = 4096, N = 11008 and for dx at down_proj (N = 4096,
// K = 11008); the bytes (xq or dy, qp, gs, the output) take ~0.06 ms.
//
// What the design does about it (simple first: mma.sync, no wgmma or TMA):
// - forward: a CTA owns a 128 x 128 output tile and walks K in steps of 128
//   weight rows = 64 packed byte rows, the groups in order, through two
//   cp.async stages. Each step's packed (64 x 128) tile is staged as it lies
//   (swizzled), its nibbles sign-extended four bytes at a time and
//   transposed with byte permutes into a K-contiguous (128 x 128) int8 tile,
//   the B operand of mma.sync m16n8k32 s8 (.col). 8 warps each hold a 32 x 64
//   int32 sum for the group and a fp32 sum over the groups; at a group's end
//   the int32 sum is scaled by gs[g] and added in. No unpacked or transposed
//   weight exists in device memory.
// - dx: a CTA owns 128 rows of dy and the 128 output columns of 64 packed
//   byte rows (one half of each run of a group). It first takes each row's
//   max |dy * gs[j]| over all N (sy), then walks N in 64-wide chunks,
//   quantising dy * gs[j] into shared memory as the A operand; the packed
//   rows are already N-contiguous, so the B operand is read as it lies and
//   each warp sign-extends the nibbles of its half (low or high) in
//   registers. Every column CTA repeats the row pass and the IEEE divisions
//   over the dy stripe (K / 64 times at down_proj), the TPU kernel's per-group
//   quantisation; dy stays in L2 across the column CTAs of a row stripe.
#include <stdint.h>

#include "int8_mma.cuh"

using bf16 = __nv_bfloat16;

namespace {

using namespace rlaifv;

constexpr int BM = 128;        // rows of x (or dy) a CTA owns
constexpr int BN = 128;        // output columns a CTA owns
constexpr int NTHREADS = 256;  // 8 warps, 4 along rows x 2 along columns
constexpr int HG = 64;         // packed byte rows a step (forward) or a CTA (dx)

// forward: a step is 2 HG = 128 weight rows; rows of 144 bytes (36 words)
// put a fragment load's 8 rows x 4 words in 32 distinct banks and keep
// rows 16-byte aligned for cp.async
constexpr int KS = 2 * HG;
constexpr int LDF = KS + 16;
constexpr int FA_BYTES = BM * LDF;  // one stage of the xq tile
constexpr int FP_BYTES = HG * BN;   // one stage of the packed tile as it lies
constexpr int FB_BYTES = BN * LDF;  // the unpacked, K-contiguous weight tile
constexpr int FWD_SMEM = 2 * FA_BYTES + 2 * FP_BYTES + FB_BYTES;  // 71,680 bytes
static_assert(BN == 128, "the packed staging tile has 128-byte rows (swizzle128)");

// dx: N chunks of 64, rows of 80 bytes (as in quant_matmul.cu)
constexpr int BK = 64;
constexpr int LDT = BK + 16;

__global__ void __launch_bounds__(NTHREADS, 1)
    int4_fwd_kernel(const int8_t *__restrict__ xq, const float *__restrict__ sx,
                    const int8_t *__restrict__ qp, const float *__restrict__ gs,
                    bf16 *__restrict__ out, int M, int K, int N, int G) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t *sA = smem;                  // [2][FA_BYTES]
  int8_t *sP = smem + 2 * FA_BYTES;   // [2][FP_BYTES]
  int8_t *sB = sP + 2 * FP_BYTES;     // [FB_BYTES]

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int steps = K / KS, per_group = G / KS;
  // K and N are multiples of 128: rows are 16-byte aligned when the base is
  const bool a_vec = (reinterpret_cast<uintptr_t>(xq) & 15) == 0;
  const bool q_vec = (reinterpret_cast<uintptr_t>(qp) & 15) == 0;

  // step s: packed rows s HG .. s HG + 64 (group g, offset c in its G/2 byte
  // rows) and the xq columns of their weight rows, low run then high run
  auto stage = [&](int st, int s) {
    const int g = s / per_group, c = (s % per_group) * HG;
    for (int i = threadIdx.x; i < BM * (KS / 16); i += NTHREADS) {
      const int r = i / (KS / 16), ch = i % (KS / 16);
      const int col = g * G + (ch < HG / 16 ? c : G / 2 + c) + (ch % (HG / 16)) * 16;
      load16_i8(sA + st * FA_BYTES + r * LDF + ch * 16, xq, m0 + r, M, col, K, a_vec);
    }
    for (int i = threadIdx.x; i < HG * (BN / 16); i += NTHREADS) {
      const int r = i / (BN / 16), ch = i % (BN / 16);
      load16_i8(sP + st * FP_BYTES + swizzle128(r, ch * 16), qp, s * HG + r, K / 2,
                n0 + ch * 16, N, q_vec);
    }
  };
  // the staged packed tile -> sB row n: the step's 64 low-nibble weights,
  // then its 64 high-nibble ones; 4 x 4 byte blocks, two per thread, a half
  // warp on the 16 K-blocks of one N-block (32 distinct banks a store)
  auto unpack = [&](const int8_t *src) {
#pragma unroll
    for (int i = 0; i < (HG / 4) * (BN / 4) / NTHREADS; ++i) {
      const int idx = threadIdx.x + i * NTHREADS;
      const int kb = idx % (HG / 4), nb = idx / (HG / 4);
      uint32_t lo[4], hi[4], o[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t w = ld32(src + swizzle128(kb * 4 + r, nb * 4));
        lo[r] = lo_nibbles(w);
        hi[r] = hi_nibbles(w);
      }
      transpose4x4(lo, o);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t *>(sB + (nb * 4 + j) * LDF + kb * 4) = o[j];
      transpose4x4(hi, o);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t *>(sB + (nb * 4 + j) * LDF + HG + kb * 4) = o[j];
    }
  };

  const int lane = threadIdx.x % 32, g8 = lane / 4, t = lane % 4;
  const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;
  int iacc[2][8][4];   // this group's exact int32 sums
  float acc[2][8][4];  // the fp32 sum over the groups so far
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        iacc[i][j][e] = 0;
        acc[i][j][e] = 0.f;
      }

  stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) {
      stage(cur ^ 1, s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    unpack(sP + cur * FP_BYTES);
    __syncthreads();
    const int8_t *ta = sA + cur * FA_BYTES;
#pragma unroll
    for (int ks = 0; ks < KS; ks += 32) {
      uint32_t af[2][4], bfrag[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t *p = ta + (wm * 32 + mt * 16 + g8) * LDF + ks + t * 4;
        af[mt][0] = ld32(p);
        af[mt][1] = ld32(p + 8 * LDF);
        af[mt][2] = ld32(p + 16);
        af[mt][3] = ld32(p + 8 * LDF + 16);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int8_t *p = sB + (wn * 64 + j * 8 + g8) * LDF + ks + t * 4;
        bfrag[j][0] = ld32(p);
        bfrag[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_s8(iacc[mt][j], af[mt], bfrag[j]);
    }
    if ((s + 1) % per_group == 0) {  // the group's end: acc += float(iacc) * gs[g]
      const float *grow = gs + (long long)(s / per_group) * N + n0 + wn * 64 + t * 2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float s0 = grow[j * 8], s1 = grow[j * 8 + 1];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float part = __fmul_rn(__int2float_rn(iacc[mt][j][e]), e % 2 ? s1 : s0);
            acc[mt][j][e] = __fadd_rn(acc[mt][j][e], part);
            iacc[mt][j][e] = 0;
          }
      }
    }
    __syncthreads();  // sA / sP of this stage and sB are read before the next writes
  }

  // epilogue: bf16(acc * sx[row]); N is even, so column pairs store as one word
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + mt * 16 + g8 + h * 8;
      if (row >= M) continue;
      const float rs = sx[row];
      bf16 *orow = out + (long long)row * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn * 64 + j * 8 + t * 2;
        *reinterpret_cast<__nv_bfloat162 *>(orow + col) = __floats2bfloat162_rn(
            __fmul_rn(acc[mt][j][h * 2], rs), __fmul_rn(acc[mt][j][h * 2 + 1], rs));
      }
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
    int4_dx_kernel(const bf16 *__restrict__ dy, const int8_t *__restrict__ qp,
                   const float *__restrict__ gs, bf16 *__restrict__ dx, int M, int K,
                   int N, int G) {
  __shared__ __align__(16) int8_t sA[2][BM * LDT];  // quantised dy * gs[j]
  __shared__ __align__(16) int8_t sP[2][HG * LDT];  // packed rows, N-contiguous
  __shared__ float srow[BM];                        // sy

  const int p0 = blockIdx.x * HG, m0 = blockIdx.y * BM;
  const int j = p0 / (G / 2), c = p0 % (G / 2);  // the output group, the run offset
  const float *gcol = gs + (long long)j * N;
  const int nt = N / BK;
  const bool a_vec = (reinterpret_cast<uintptr_t>(dy) & 15) == 0;
  const bool q_vec = (reinterpret_cast<uintptr_t>(qp) & 15) == 0;

  row_scales<true, BM, NTHREADS>(srow, dy, gcol, m0, M, N, a_vec);
  __syncthreads();

  auto stage_q = [&](int st, int kt) {
    for (int i = threadIdx.x; i < HG * (BK / 16); i += NTHREADS) {
      const int r = i / (BK / 16), ch = i % (BK / 16);
      load16_i8(&sP[st][r * LDT + ch * 16], qp, p0 + r, K / 2, kt * BK + ch * 16, N, q_vec);
    }
  };
  // this thread's chunks of dy * gs[j] for chunk kt, loaded into registers
  // now and quantised into shared memory later
  constexpr int A_CHUNKS = BM * (BK / 8) / NTHREADS;
  float va[A_CHUNKS][8];
  auto fetch = [&](int kt) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int idx = threadIdx.x + i * NTHREADS;
      const int r = idx / (BK / 8), col = kt * BK + (idx % (BK / 8)) * 8;
      load8_bf16(va[i], dy, m0 + r, M, col, N, a_vec);
      scale_cols(va[i], gcol, col, N);
    }
  };
  auto store = [&](int st) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int idx = threadIdx.x + i * NTHREADS;
      const int r = idx / (BK / 8), cc = (idx % (BK / 8)) * 8;
      *reinterpret_cast<uint2 *>(&sA[st][r * LDT + cc]) =
          m0 + r < M ? quantize8(va[i], srow[r]) : make_uint2(0u, 0u);
    }
  };

  const int lane = threadIdx.x % 32, g8 = lane / 4, t = lane % 4;
  const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;  // wn: low or high run
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0;

  stage_q(0, 0);
  cp_async_commit();
  fetch(0);
  store(0);
  for (int kt = 0; kt < nt; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nt) {
      stage_q(cur ^ 1, kt + 1);
      cp_async_commit();
      fetch(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4], bfrag[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t *p = &sA[cur][(wm * 32 + mt * 16 + g8) * LDT + ks + t * 4];
        af[mt][0] = ld32(p);
        af[mt][1] = ld32(p + 8 * LDT);
        af[mt][2] = ld32(p + 16);
        af[mt][3] = ld32(p + 8 * LDT + 16);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int8_t *p = &sP[cur][(jj * 8 + g8) * LDT + ks + t * 4];
        const uint32_t w0 = ld32(p), w1 = ld32(p + 16);
        bfrag[jj][0] = wn ? hi_nibbles(w0) : lo_nibbles(w0);
        bfrag[jj][1] = wn ? hi_nibbles(w1) : lo_nibbles(w1);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) mma_s8(acc[mt][jj], af[mt], bfrag[jj]);
    }
    // stage cur ^ 1 was last read in iteration kt - 1, before this
    // iteration's first barrier
    if (kt + 1 < nt) store(cur ^ 1);
    __syncthreads();
  }

  // epilogue: bf16(float(acc) * sy[row]) into the run's 64 columns
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * 32 + mt * 16 + g8 + h * 8;
      const int row = m0 + rl;
      if (row >= M) continue;
      const float rs = srow[rl];
      bf16 *orow = dx + (long long)row * K + j * G + (wn ? G / 2 : 0) + c;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        *reinterpret_cast<__nv_bfloat162 *>(orow + jj * 8 + t * 2) = __floats2bfloat162_rn(
            __fmul_rn(__int2float_rn(acc[mt][jj][h * 2]), rs),
            __fmul_rn(__int2float_rn(acc[mt][jj][h * 2 + 1]), rs));
      }
    }
  }
}

}  // namespace

// #11: xq (M, K) int8, sx (M,) fp32, qp (K/2, N) int8, gs (K/G, N) fp32 ->
// out (M, N) bf16; G a multiple of 128 dividing K, N a multiple of 128
extern "C" int int4_matmul_bf16(const void *xq, const void *sx, const void *qp,
                                const void *gs, void *out, int M, int K, int N, int G,
                                void *stream) {
  cudaError_t err = cudaFuncSetAttribute(
      int4_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  int4_fwd_kernel<<<grid, NTHREADS, FWD_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t *>(xq), static_cast<const float *>(sx),
      static_cast<const int8_t *>(qp), static_cast<const float *>(gs),
      static_cast<bf16 *>(out), M, K, N, G);
  return static_cast<int>(cudaGetLastError());
}

// #12: dy (M, N) bf16, qp (K/2, N) int8, gs (K/G, N) fp32 -> dx (M, K) bf16
extern "C" int int4_matmul_dx_bf16(const void *dy, const void *qp, const void *gs,
                                   void *dx, int M, int K, int N, int G, void *stream) {
  const dim3 grid(K / 2 / HG, (M + BM - 1) / BM);
  int4_dx_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16 *>(dy), static_cast<const int8_t *>(qp),
      static_cast<const float *>(gs), static_cast<bf16 *>(dx), M, K, N, G);
  return static_cast<int>(cudaGetLastError());
}
