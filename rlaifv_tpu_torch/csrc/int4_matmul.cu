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
// quotients are IEEE ones rounded half to even (the forward's divisions
// happen in torch; dx's are reproduced exactly without a division per
// element, see q4dx below): every kernel equals its plain PyTorch twin bit
// for bit.
//
// What bounds it on the H100: int8 tensor-core operations, 2 M K N at 1,979
// TOP/s. At the 8-pair QLoRA step's prefix (M = 6144) that is 0.280 ms for
// the forward at K = 4096, N = 11008 and for dx at down_proj (N = 4096,
// K = 11008); the bytes (xq or dy, qp, gs, the output) take ~0.06 ms. dx
// also quantises dy * gs[j] once per output group: M N K / G elements
// (2.2e9 at down_proj), a few fp32 instructions each, on the SMs' ALUs.
//
// The forward (simple first: mma.sync, no wgmma or TMA): a CTA owns a
// 128 x 128 output tile and walks K in steps of 128 weight rows = 64 packed
// byte rows, the groups in order, through two cp.async stages. Each step's
// packed (64 x 128) tile is staged as it lies (swizzled), its nibbles
// sign-extended four bytes at a time and transposed with byte permutes into
// a K-contiguous (128 x 128) int8 tile, the B operand of mma.sync m16n8k32
// s8 (.col). 8 warps each hold a 32 x 64 int32 sum for the group and a fp32
// sum over the groups; at a group's end the int32 sum is scaled by gs[g]
// and added in. No unpacked or transposed weight exists in device memory.
// dx: TMA, warp specialisation and wgmma with A from registers (q4dx).
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "int8_mma.cuh"

using bf16 = __nv_bfloat16;

namespace {

using namespace rlaifv;

constexpr int BM = 128;        // rows of x a CTA owns (forward)
constexpr int BN = 128;        // output columns a CTA owns
constexpr int NTHREADS = 256;  // 8 warps, 4 along rows x 2 along columns
constexpr int HG = 64;         // packed byte rows a step

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

// ---------------------------------------------------------------- #12, dx
//
// dx[:, group j] = bf16(float(Q_j(dy * gs[j]) . w4[group j]^T) * sy[:, j]),
// three kinds of work per output group: the quantisation of dy * gs[j]
// (M N of them per group, 2.2e9 a call at M 6144, N 4096, K 11008), the
// nibble unpack of the group's packed rows and the int8 products.
//
// 1. dx_amax: max_n |dy[m, n] gs[j, n]| for every row and group in one pass
//    over dy, into an (M, J) table (dx_groups turns each into sy). It
//    replaces the per-group amax pass over the dy stripe that every column
//    CTA made before.
// 2. dx_groups: a CTA owns 128 rows of dy and 128 packed rows (two 64-row
//    units: two groups of 128, or half of one of 256), and walks N in
//    64-column stages, its warps specialised:
//    - warp 0 keeps a 4-stage ring of TMA loads in flight: the dy tile
//      (bf16, 128-byte swizzle), the packed tile (64-byte swizzle) and the
//      units' two gs rows;
//    - warps 1-3 unpack each packed tile into a K-major int8 tile (low
//      nibbles, then high ones: a 16-byte unit keeps its offset within its
//      64-byte swizzled row), three tiles deep;
//    - two consumer warpgroups (64 rows each) quantise dy * gs[j] straight
//      into wgmma's A fragment registers and run wgmma m64n128k32 s8 x s8
//      -> s32 on them and the unpacked tile, one int32 accumulator tile per
//      unit. A warpgroup's products end before it writes the next stage's
//      fragments; the other warpgroup quantises meanwhile.
//    mbarriers count the ring's bytes in and its readers out, the unpacked
//    tiles' writers and (after wgmma.wait) their readers; setmaxnreg moves
//    registers from the loading warpgroup to the consumers. Measured on an
//    H100 (PERF.md): the consumers' shared-memory traffic and the dy tile's
//    reads from L2 (once per unit pair: M N 2 K / 256 bytes) bound it, not
//    the tensor cores; a variant with the A operand in shared memory, and
//    one with four consumer warpgroups, were slower.
//
// Exact rounding without a division per element. The plain twin's int8 is
// rint(rn(v / sy)) (IEEE quotient, ties to even), v = rn(dy gs[j]). With
// r = rn(1 / sy), r1 = rn(r (1 - 2^-20)) and r2 = rn(r (1 + 2^-20)):
// r1 sy <= (1 + 2^-24)^2 (1 - 2^-20) < 1 - 2^-21 and r2 sy > 1 + 2^-21,
// while q = rn(v / sy) lies within a factor (1 +- 2^-24) of v / sy. So for
// v > 0, v r1 < q < v r2 (reversed for v < 0; all 0 for v = 0). Each fma
// u = fma(v, r1, 1.5 2^23) rounds the exact product once, to the integer
// nearest it (ties to even; |v r1| < 128), held in u's low mantissa bits.
// rint is monotonic, so when the two brackets round to the same integer,
// rint(q) is that integer: no division, no conversion instruction (the
// int8 is u's low byte). Where they differ, a half-integer lies within
// 2^-20 |v / sy| <= 2^-13 of v / sy and the element takes __fdiv_rn,
// about once in 10^4 elements for Gaussian rows. |v / sy| <= 127 (1 +
// 2^-23), so no clamp is needed: rint(q) is within [-127, 127].
namespace q4dx {

constexpr int TC = 64;        // N columns a stage: 64 packed bytes, 64 bf16 of dy
constexpr int STAGES = 4;
constexpr int NBUF = 3;       // unpacked B tiles
constexpr int NCONS = 2;      // consumer warpgroups: 128 rows of dy
constexpr int NUNPACK = 3;    // unpacking warps, beside the producer warp
constexpr int THREADS = (NCONS + 1) * 128;
constexpr int D_BYTES = NCONS * 64 * TC * 2;  // dy tile, 128-byte rows
constexpr int P_BYTES = 128 * TC;             // packed tile: 2 units x 64 rows
constexpr int G_BYTES = 2 * TC * 4;           // the units' two gs rows
constexpr int STAGE_BYTES = 25 * 1024;        // D, P, G, padded to a 1 KB multiple
constexpr int U_BYTES = 128 * TC;             // one unit's unpacked tile: 128 rows
constexpr int B_BYTES = 2 * U_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + NBUF * B_BYTES + 2 * 128 * 4 +
                     2 * (STAGES + NBUF) * 8 + 1024;
static_assert(D_BYTES + P_BYTES + G_BYTES <= STAGE_BYTES, "stage layout");
constexpr float MAGIC = 12582912.0f;          // 1.5 2^23
constexpr float BRACKET_LO = 1.0f - 0x1p-20f;
constexpr float BRACKET_HI = 1.0f + 0x1p-20f;

// ---- 1. the (M, J) table of row maxima

constexpr int SC = 32;  // N columns a chunk
constexpr int SR = 256; // most rows a CTA
constexpr int SJ = 64;  // most groups a CTA

// Rows [m0, m0 + 4 nrb) x groups [j0, j0 + jt) x columns [n0, n1): thread
// (rb, gb) keeps the 4 x 4 maxima of |dy| |gs| over its rows and groups,
// chunks of 32 columns staged (|.| as fp32, column-major) in two shared
// buffers while the next chunk's loads are in flight; the column slices
// combine with atomicMax on the bits of the non-negative maxima (exact, in
// any order) into amax (M, J), zeroed beforehand.
__global__ void __launch_bounds__(256)
    dx_amax(const bf16 *__restrict__ dy, const float *__restrict__ gs,
            unsigned *__restrict__ amax, int M, int N, int J, int jt, int ngb, int nrb,
            int slice) {
  extern __shared__ __align__(16) float sm[];
  const int rows = 4 * nrb, ld_d = rows + 4, ld_g = 4 * ngb + 4;
  float *sd = sm;                      // [2][SC][ld_d]
  float *sg = sm + 2 * SC * ld_d;      // [2][SC][ld_g]
  const int m0 = blockIdx.x * rows, j0 = blockIdx.y * jt;
  const int nj = min(jt, J - j0);
  const int n0 = blockIdx.z * slice, n1 = min(N, n0 + slice);
  const int gb = threadIdx.x % ngb, rb = threadIdx.x / ngb;
  const int nch = (n1 - n0) / SC;

  // this thread's loads of a chunk: dy (row r, columns c8 .. c8 + 7), one
  // row a lane; gs (group j, columns c4 .. c4 + 3), one group a lane
  constexpr int DL = SR * SC / 8 / 256, GL = SJ * SC / 4 / 256;
  uint4 rd[DL];
  float4 rg[GL];
  auto fetch = [&](int n) {
#pragma unroll
    for (int k = 0; k < DL; ++k) {
      const int i = threadIdx.x + 256 * k, r = i % rows, c8 = i / rows;
      rd[k] = c8 < SC / 8 && m0 + r < M
                  ? *reinterpret_cast<const uint4 *>(dy + (long long)(m0 + r) * N + n + 8 * c8)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < GL; ++k) {
      const int i = threadIdx.x + 256 * k, j = i % (4 * ngb), c4 = i / (4 * ngb);
      rg[k] = c4 < SC / 4 && j < nj
                  ? *reinterpret_cast<const float4 *>(gs + (long long)(j0 + j) * N + n + 4 * c4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int k = 0; k < DL; ++k) {
      const int i = threadIdx.x + 256 * k, r = i % rows, c8 = i / rows;
      if (c8 >= SC / 8) continue;
      float f[8];
      bf16x8_to_float(rd[k], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) sd[(buf * SC + 8 * c8 + e) * ld_d + r] = fabsf(f[e]);
    }
#pragma unroll
    for (int k = 0; k < GL; ++k) {
      const int i = threadIdx.x + 256 * k, j = i % (4 * ngb), c4 = i / (4 * ngb);
      if (c4 >= SC / 4) continue;
      const float g[4] = {rg[k].x, rg[k].y, rg[k].z, rg[k].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) sg[(buf * SC + 4 * c4 + e) * ld_g + j] = fabsf(g[e]);
    }
  };

  float acc[4][4] = {};
  if (nch > 0) {
    fetch(n0);
    stage(0);
  }
  __syncthreads();
  for (int i = 0; i < nch; ++i) {
    if (i + 1 < nch) fetch(n0 + (i + 1) * SC);
    if (rb < nrb) {
      const float *d = sd + (i & 1) * SC * ld_d + 4 * rb;
      const float *g = sg + (i & 1) * SC * ld_g + 4 * gb;
#pragma unroll 8
      for (int c = 0; c < SC; ++c) {
        const float4 a = *reinterpret_cast<const float4 *>(d + c * ld_d);
        const float4 b = *reinterpret_cast<const float4 *>(g + c * ld_g);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = fmaxf(acc[x][y], __fmul_rn(av[x], bv[y]));
      }
    }
    if (i + 1 < nch) stage((i + 1) & 1);
    __syncthreads();
  }
  if (rb >= nrb) return;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int m = m0 + 4 * rb + x;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int j = 4 * gb + y;
      if (m < M && j < nj)
        atomicMax(amax + (long long)m * J + j0 + j, __float_as_uint(acc[x][y]));
    }
  }
}

// ---- 2. the product

// v = rn(d g) and the bits of fma(v, r1, MAGIC), fma(v, r2, MAGIC): the
// brackets' integers in the low mantissa bits. Inline asm keeps the slow
// path's recomputation from being merged with these (which would hold 16
// flags and products live across its branch).
__device__ __forceinline__ void bracket(float d, float g, float r1, float r2, uint32_t &q1,
                                        uint32_t &q2) {
  asm("{\n.reg .f32 v;\n"
      "mul.rn.f32 v, %2, %3;\n"
      "fma.rn.f32 %0, v, %4, 0f4B400000;\n"
      "fma.rn.f32 %1, v, %5, 0f4B400000;\n}\n"
      : "=r"(q1), "=r"(q2)
      : "f"(d), "f"(g), "f"(r1), "f"(r2));
}

// 4 bf16 (8 bytes of shared memory) -> floats
__device__ __forceinline__ void load4_bf16(float *f, uint32_t addr) {
  uint32_t w0, w1;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(w0), "=r"(w1) : "r"(addr));
  f[0] = __uint_as_float(w0 << 16);
  f[1] = __uint_as_float(w0 & 0xffff0000u);
  f[2] = __uint_as_float(w1 << 16);
  f[3] = __uint_as_float(w1 & 0xffff0000u);
}

__device__ __forceinline__ void load4_f32(float *f, uint32_t addr) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(f[0]), "=f"(f[1]), "=f"(f[2]), "=f"(f[3])
               : "r"(addr));
}

// Rows [m0, m0 + 128) x packed rows [p0, p0 + 128) of dx. G: the group
// (a multiple of 128); J = K / G groups. Warps 0-3 load and unpack, warps
// 4-11 consume.
__global__ void __launch_bounds__(THREADS, 1)
    dx_groups(const __grid_constant__ CUtensorMap map_dy,
              const __grid_constant__ CUtensorMap map_qp,
              const __grid_constant__ CUtensorMap map_gs, const float *__restrict__ amax,
              bf16 *__restrict__ dx, int M, int K, int N, int G) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (saddr(smem_raw) + 1023) / 1024 * 1024;
  const uint32_t bufs = ring + STAGES * STAGE_BYTES;  // unpacked tiles
  const uint32_t sy_s = bufs + NBUF * B_BYTES;        // [unit][128 rows] fp32
  const uint32_t full = sy_s + 2 * 128 * 4;           // a stage's bytes have landed
  const uint32_t empty = full + STAGES * 8;           // its readers are done
  const uint32_t ufull = empty + STAGES * 8;          // an unpacked tile is written
  const uint32_t ufree = ufull + NBUF * 8;            // its products have retired
  const int J = K / G, hg = G / 2;
  const int p0 = blockIdx.x * 128, m0 = blockIdx.y * 128;
  const int j0 = p0 / hg;
  // the second unit lies inside the weight; past it, its packed rows read
  // as zeros (TMA) and its quantised rows as zeros (r1 = r2 = 0)
  const bool two = p0 + 64 < K / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc = N / TC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, NCONS * 4 + NUNPACK);  // one arrival a reading warp
    }
    for (int b = 0; b < NBUF; ++b) {
      bar_init(ufull + 8 * b, NUNPACK);
      bar_init(ufree + 8 * b, NCONS);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (warp == 0) {  // the producer: one thread starts every load
      if (lane == 0) {
        for (int c = 0; c < nc; ++c) {
          const int s = c % STAGES;
          if (c >= STAGES) bar_wait(empty + 8 * s, (c / STAGES - 1) & 1);
          const uint32_t st = ring + s * STAGE_BYTES, bar = full + 8 * s;
          bar_expect(bar, D_BYTES + P_BYTES + G_BYTES);
          tma_load(st, &map_dy, c * TC, m0, bar);
          tma_load(st + D_BYTES, &map_qp, c * TC, p0, bar);
          tma_load(st + D_BYTES + P_BYTES, &map_gs, c * TC, j0, bar);
        }
      }
    } else {  // the unpackers: 512 16-byte units of a packed tile over 96 threads
      for (int c = 0; c < nc; ++c) {
        const int s = c % STAGES, b = c % NBUF;
        const uint32_t st = ring + s * STAGE_BYTES + D_BYTES, bt = bufs + b * B_BYTES;
        bar_wait(full + 8 * s, (c / STAGES) & 1);
        if (c >= NBUF) bar_wait(ufree + 8 * b, (c / NBUF - 1) & 1);
        // unit u's byte o lands at u U_BYTES + o (low nibbles) and 64 rows
        // further (high nibbles), the same offset within a swizzled row
#pragma unroll 1
        for (int i = threadIdx.x - 32; i < P_BYTES / 16; i += 32 * NUNPACK) {
          const int o = i * 16, u = o / (64 * TC), w = o % (64 * TC);
          uint32_t v[4];
          asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                       : "r"(st + o));
          const uint32_t lo = bt + u * U_BYTES + w, hi = lo + 64 * TC;
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo),
                       "r"(lo_nibbles(v[0])), "r"(lo_nibbles(v[1])), "r"(lo_nibbles(v[2])),
                       "r"(lo_nibbles(v[3])));
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(hi),
                       "r"(hi_nibbles(v[0])), "r"(hi_nibbles(v[1])), "r"(hi_nibbles(v[2])),
                       "r"(hi_nibbles(v[3])));
        }
        fence_async_smem();
        __syncwarp();
        if (lane == 0) {
          bar_arrive(ufull + 8 * b);
          bar_arrive(empty + 8 * s);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int wg = warp / 4 - 1, g8 = lane / 4, t = lane % 4;
    const int rw = (warp % 4) * 16 + g8;  // this thread's rows rw, rw + 8 of its 64
    const int rl = wg * 64 + rw;          // ... of the CTA's 128
    // the units' groups, as rows of the stage's two gs rows
    const int ju[2] = {0, (p0 + 64) / hg - j0};
    float r1[2][2], r2[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + rl + 8 * h;
        const bool live = m < M && (u == 0 || two);
        // sy = max(max |v|, 1e-20) / 127, as quantize_rows
        const float scale =
            live ? __fdiv_rn(fmaxf(amax[(long long)m * J + j0 + ju[u]], 1e-20f), 127.0f) : 1.f;
        const float r = __frcp_rn(scale);
        r1[u][h] = live ? __fmul_rn(r, BRACKET_LO) : 0.f;
        r2[u][h] = live ? __fmul_rn(r, BRACKET_HI) : 0.f;
        if (t == 0) {
          const uint32_t a = sy_s + (u * 128 + rl + 8 * h) * 4;
          asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(scale));
        }
      }
    __syncwarp();

    int acc[2][64];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[u][i] = 0;

    for (int c = 0; c < nc; ++c) {
      const int s = c % STAGES, b = c % NBUF;
      const uint32_t st = ring + s * STAGE_BYTES;
      // a[kk][u]: the stage's wgmma A fragments (rows rl, rl + 8; columns
      // 32 kk + 4 t + (0..3) and + 16), quantised here
      uint32_t a[TC / 32][2][4];
      bar_wait(full + 8 * s, (c / STAGES) & 1);
#pragma unroll
      for (int kk = 0; kk < TC / 32; ++kk) {
        // dy rows rl, rl + 8, columns 32 kk + 4 t + (0..3) and + 16: 16-byte
        // chunk 4 kk + (t >> 1) (and + 2) of a 128-byte row, swizzled by row % 8
        float f[2][8];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int chunk = (4 * kk + 2 * half + (t >> 1)) ^ g8;
            load4_bf16(&f[h][4 * half], st + (rl + 8 * h) * 128 + chunk * 16 + (t & 1) * 8);
          }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float gv[8];
          const uint32_t ga = st + D_BYTES + P_BYTES + ju[u] * TC * 4 + (32 * kk + 4 * t) * 4;
          load4_f32(gv, ga);
          load4_f32(gv + 4, ga + 64);
          // w[h][half]: the int8 of row rl + 8 h, columns 32 kk + 16 half + 4 t
          // + (0..3), as wgmma's A fragment holds them
          uint32_t w[2][2], diff[2][2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              uint32_t q[4];
              diff[h][half] = 0u;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                uint32_t q2;
                bracket(f[h][4 * half + e], gv[4 * half + e], r1[u][h], r2[u][h], q[e], q2);
                diff[h][half] |= q[e] ^ q2;
              }
              w[h][half] = __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                                       __byte_perm(q[2], q[3], 0x0040), 0x5410);
            }
          if ((diff[0][0] | diff[0][1] | diff[1][0] | diff[1][1]) != 0u) {
            // a bracket holds a half-integer: the IEEE quotient there
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float scale;
              asm volatile("ld.shared.f32 %0, [%1];\n"
                           : "=f"(scale)
                           : "r"(sy_s + (u * 128 + rl + 8 * h) * 4));
#pragma unroll
              for (int x = 0; x < 8; ++x) {
                const float v = __fmul_rn(f[h][x], gv[x]);
                if (__fmaf_rn(v, r1[u][h], MAGIC) != __fmaf_rn(v, r2[u][h], MAGIC)) {
                  const uint32_t q8 = __float2int_rn(__fdiv_rn(v, scale)) & 0xffu;
                  const int sh = 8 * (x % 4);
                  w[h][x / 4] = (w[h][x / 4] & ~(0xffu << sh)) | (q8 << sh);
                }
              }
            }
          }
          a[kk][u][0] = w[0][0];
          a[kk][u][1] = w[1][0];
          a[kk][u][2] = w[0][1];
          a[kk][u][3] = w[1][1];
        }
      }
      // this warp has read the stage's dy and gs bytes: release it
      __syncwarp();
      if (lane == 0) bar_arrive(empty + 8 * s);
      bar_wait(ufull + 8 * b, (c / NBUF) & 1);
      const uint32_t bt = bufs + b * B_BYTES;
      // A from registers: every fragment is written before the products
      // start, which end (wgmma.wait) before the next stage writes them
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC / 32; ++kk)
#pragma unroll
        for (int u = 0; u < 2; ++u)  // K-major, 64-byte swizzle: 32 bytes on
          wgmma_s8_rs(acc[u], a[kk][u], gmma_desc(bt + u * U_BYTES + kk * 32, 16, 512, 2));
      wgmma_commit();
      wgmma_wait<0>();  // this stage's products have retired: free its tile
      if (threadIdx.x % 128 == 0) bar_arrive(ufree + 8 * b);
    }
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);

    // register i: row rl + 8 ((i >> 1) & 1), unpacked column 8 (i >> 2) + 2 t
    // + (i & 1): packed row p0 + 64 u + (col % 64), nibble col / 64
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !two) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + rl + 8 * h;
        if (m >= M) continue;
        float scale;
        asm volatile("ld.shared.f32 %0, [%1];\n"
                     : "=f"(scale)
                     : "r"(sy_s + (u * 128 + rl + 8 * h) * 4));
        bf16 *orow = dx + (long long)m * K;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 8 * j + 2 * t;
          const int p = p0 + 64 * u + (col % 64);
          const int k = (p / hg) * G + (col / 64) * hg + p % hg;
          *reinterpret_cast<__nv_bfloat162 *>(orow + k) = __floats2bfloat162_rn(
              __fmul_rn(__int2float_rn(acc[u][4 * j + 2 * h]), scale),
              __fmul_rn(__int2float_rn(acc[u][4 * j + 2 * h + 1]), scale));
        }
      }
    }
  }
}

}  // namespace q4dx

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

// #12: dy (M, N) bf16, qp (K/2, N) int8, gs (K/G, N) fp32 -> dx (M, K) bf16;
// amax (M, K/G) fp32 scratch from the wrapper. G a multiple of 128 dividing
// K, N a multiple of 128, dy, qp and gs 16-byte aligned.
extern "C" int int4_matmul_dx_bf16(const void *dy, const void *qp, const void *gs,
                                   void *amax, void *dx, int M, int K, int N, int G,
                                   void *stream) {
  using namespace q4dx;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || G <= 0 || G % 128 || K % G || N % 128) return cudaErrorInvalidValue;
  const int J = K / G;
  CUtensorMap md, mq, mg;
  if (!tensor_map_2d(&md, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dy, M, N, 2ll * N, TC, 128,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_2d(&mq, CU_TENSOR_MAP_DATA_TYPE_UINT8, qp, K / 2, N, N, TC, 128,
                     CU_TENSOR_MAP_SWIZZLE_64B) ||
      !tensor_map_2d(&mg, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, gs, J, N, 4ll * N, TC, 2,
                     CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  // 1. the maxima: balanced tiles of at most 64 groups, 4 x 4 a thread, and
  // enough column slices for eight CTAs an SM (measured on an H100: 0.14
  // ms less than two at M 6144, K 11008, N 4096)
  const int jtiles = (J + SJ - 1) / SJ, jt = (J + jtiles - 1) / jtiles;
  const int ngb = (jt + 3) / 4, nrb = std::min(256 / ngb, SR / 4);
  const int mtiles = (M + 4 * nrb - 1) / (4 * nrb);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int nslice = std::max(1, std::min(N / SC, (8 * sms + mtiles * jtiles - 1) /
                                                      (mtiles * jtiles)));
  const int slice = (N / SC + nslice - 1) / nslice * SC;
  const int smem = 2 * SC * (4 * nrb + 4 + 4 * ngb + 4) * 4;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(float) * M * J, st);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(reinterpret_cast<const void *>(dx_amax),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dx_amax<<<dim3(mtiles, jtiles, (N + slice - 1) / slice), 256, smem, st>>>(
      static_cast<const bf16 *>(dy), static_cast<const float *>(gs),
      static_cast<unsigned *>(amax), M, N, J, jt, ngb, nrb, slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 2. the product
  err = cudaFuncSetAttribute(reinterpret_cast<const void *>(dx_groups),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  dx_groups<<<dim3((K / 2 + 127) / 128, (M + 127) / 128), THREADS, SMEM, st>>>(
      md, mq, mg, static_cast<const float *>(amax), static_cast<bf16 *>(dx), M, K, N, G);
  return cudaGetLastError();
}
