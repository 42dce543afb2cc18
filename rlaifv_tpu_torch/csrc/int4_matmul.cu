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
// #11, the forward (q4fwd below): a CTA owns a 128 x 128 output tile and
// walks K in steps of 64 packed byte rows (128 weight rows, two runs of 64:
// the low nibbles, then the high ones), the groups in order, its warps
// specialised:
// - warp 0's first lane keeps a ring of TMA loads in flight, 3 steps ahead
//   of the unpacking: the step's two xq boxes (K-major, 64-byte swizzle),
//   the packed tile (64 x 128 bytes as it lies, 128-byte swizzle) and the
//   group's gs row;
// - warps 0-3 unpack each packed tile into a K-major int8 tile in wgmma's
//   64-byte-swizzled layout (int8 wgmma takes both operands K-major only,
//   and the packed weight is N-contiguous, so this is a transpose): 4 x 4
//   byte blocks transposed once with byte permutes, each nibble then moved
//   to the high half of its byte, a signed int8 of 16 times the weight (one
//   or two logic operations a word, no sign-extension arithmetic). Within
//   each 16 columns the tile's rows are permuted (column i of chunk c at
//   row i ^ c, low three bits), so that a warp's stores hit 32 distinct
//   banks; the epilogue reads the columns back through the same
//   permutation;
// - two consumer warpgroups (64 rows each) run wgmma m64n128k32 s8 x s8 ->
//   s32 on the xq boxes and the unpacked tile; a group's first product
//   clears the accumulator (wgmma's scale-d), and at the group's end the
//   exact int32 sum is scaled by gs[g] (read from the ring) and added into
//   the fp32 sum, while the other warpgroup's products run. The epilogue
//   multiplies by the row scale and by 1/16 and rounds to bf16 once.
// The factor 16 is exact all the way: |16 w| <= 128 fits int8, a group's
// int32 sum stays below 2^24 (16 x 127 x 8 x G, G <= 1024), and rounding
// commutes with scaling by a power of two, so every fp32 value is 16 times
// the twin's until the exact 1/16.
// mbarriers count the ring's bytes in and its readers out, the unpacked
// tiles' writers and (after wgmma.wait) their readers. No unpacked or
// transposed weight exists in device memory. One int32 accumulator: ptxas
// caps every thread at 168 registers (384 threads), so a second one beside
// the fp32 sum spills, and it serialises a warpgroup's products whenever
// that warpgroup reads accumulators while any of its own are in flight.
// Measured on an H100 (PERF.md; tools/int4_fwd_ablate.py): ~490
// TOP/s at M 6144, about a microsecond a step, of which no single part
// accounts for most: without the rescale a third less, without the
// unpacking a sixth, with a quarter of the products an eighth; a deeper
// load lookahead or dropping the proxy fence moves it by under 4%.
// dx: TMA, warp specialisation and wgmma with A from registers (q4dx).
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "int8_mma.cuh"

using bf16 = __nv_bfloat16;

namespace {

using namespace rlaifv;

namespace q4fwd {

constexpr int BN = 128;       // output columns a CTA owns: one m64n128k32
constexpr int HG = 64;        // packed byte rows a step: 128 weight rows
constexpr int STAGES = 7;
constexpr int NBUF = 3;       // unpacked tiles
// loads run this many steps ahead of the unpacking: the slot a load takes
// was read by the unpackers and retired by the consumers before the
// unpacking of the current step can start (STAGES - NBUF - 1), so the load
// never waits there
constexpr int AHEAD = STAGES - NBUF - 1;
constexpr int NCONS = 2;      // consumer warpgroups: 128 rows of x
constexpr int THREADS = (NCONS + 1) * 128;
constexpr int P_BYTES = HG * BN;       // the packed tile, 128-byte rows
constexpr int RUN_BYTES = 128 * HG;    // an xq box: 128 rows x one run of 64
constexpr int G_BYTES = BN * 4;        // the group's gs row
constexpr int P_OFF = 0, A_OFF = P_BYTES, G_OFF = A_OFF + 2 * RUN_BYTES;
constexpr int STAGE_BYTES = 25 * 1024;  // P, A, G, padded to a 1 KB multiple
constexpr int EXPECT = P_BYTES + 2 * RUN_BYTES + G_BYTES;
constexpr int U_RUN = BN * HG;         // one run of an unpacked tile
constexpr int U_BYTES = 2 * U_RUN;
constexpr int SMEM = STAGES * STAGE_BYTES + NBUF * U_BYTES + 2 * (STAGES + NBUF) * 8 + 1024;
static_assert(G_OFF + G_BYTES <= STAGE_BYTES, "stage layout");

// The unpacked tile row that holds packed column n (0..127): within each
// 16 columns (chunk c = n / 16), column i sits at row i ^ c (low three
// bits), so that the 8 chunks a warp stores at once land in 8 distinct
// 4-bank groups
__device__ __forceinline__ int unpacked_row(int n) {
  return (n & ~7) | ((n & 7) ^ ((n >> 4) & 7));
}

// The byte offsets in an unpacked run where thread (c, kb) stores its 16
// words: word kb (weight rows 4 kb .. 4 kb + 3 of the run) of the rows
// that hold columns 16 c .. 16 c + 15, in wgmma's 64-byte swizzle (16-byte
// chunk q of row R at q ^ ((R >> 1) & 3))
__device__ __forceinline__ void unpack_offsets(uint32_t (&off)[16], int c, int kb) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int R = unpacked_row(16 * c + i);
    off[i] = R * HG + ((((kb >> 2) ^ ((R >> 1) & 3)) << 4) | ((kb & 3) << 2));
  }
}

// The staged packed tile (64 rows of 128 bytes, TMA's 128-byte swizzle:
// 16-byte chunk q of row r at q ^ (r & 7)) -> the unpacked tile's two runs.
// Thread (c, kb) of warps 0-3 takes packed rows 4 kb .. 4 kb + 3 x columns
// 16 c .. 16 c + 15: a quarter warp reads one whole row (8 chunks). Each 4
// x 4 byte block is transposed once with byte permutes (o[b]: column 4 w +
// b, rows 4 kb .. 4 kb + 3), and each nibble lands in the high half of its
// byte, which makes it a signed int8 of 16 times its value: (o << 4) &
// 0xf0 per byte for the low nibbles, o & 0xf0 for the high ones (per-byte
// operations commute with the transpose).
__device__ __forceinline__ void unpack(uint32_t p, uint32_t u, const uint32_t (&off)[16],
                                       int c, int kb) {
  uint32_t v[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * kb + r;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[r][0]), "=r"(v[r][1]), "=r"(v[r][2]), "=r"(v[r][3])
                 : "r"(p + row * BN + ((c ^ (row & 7)) << 4)));
  }
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t q[4] = {v[0][w], v[1][w], v[2][w], v[3][w]};
    uint32_t o[4];
    transpose4x4(q, o);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t lo = (o[b] << 4) & 0xf0f0f0f0u, hi = o[b] & 0xf0f0f0f0u;
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(u + off[4 * w + b]), "r"(lo));
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(u + U_RUN + off[4 * w + b]), "r"(hi));
    }
  }
}

// One step's products into acc: the low run, then the high one, two k32
// products each (K-major, 64-byte swizzle: 32 bytes on); keep = 0 clears
// acc with the first (a group's first step)
__device__ __forceinline__ void products(int (&acc)[64], uint32_t a, uint32_t u, int keep) {
  wgmma_fence();
#pragma unroll
  for (int run = 0; run < 2; ++run)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_s8_ss(acc, gmma_desc(a + run * RUN_BYTES + kk * 32, 16, 512, 2),
                  gmma_desc(u + run * U_RUN + kk * 32, 16, 512, 2),
                  run == 0 && kk == 0 ? keep : 1);
  wgmma_commit();
}

// A finished group into the fp32 sum: sum += float(acc) * gs[g], two
// roundings, in group order. gsm: the group's gs row in the ring. Register
// i's column (see unpacked_row) is 8 jj + ((2 t + e) ^ c), jj = i / 4,
// e = i % 2, c = jj / 2: the pair's columns nb, nb + 1 with nb = 8 jj +
// (2 t ^ (c & 6)), swapped when c is odd.
__device__ __forceinline__ void rescale(float (&sum)[64], int (&acc)[64], uint32_t gsm, int t) {
  fence_acc(acc);
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int c = jj / 2;
    float g[2];
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(g[0]), "=f"(g[1])
                 : "r"(gsm + (8 * jj + ((2 * t) ^ (c & 6))) * 4));
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * jj + 2 * h + e;
        sum[i] = __fadd_rn(sum[i], __fmul_rn(__int2float_rn(acc[i]), g[e ^ (c & 1)]));
      }
  }
}

// Rows [m0, m0 + 128) x columns [n0, n0 + 128) of out. Warps 0-3 load and
// unpack, warps 4-11 consume.
__global__ void __launch_bounds__(THREADS, 1)
    fwd_groups(const __grid_constant__ CUtensorMap map_xq,
               const __grid_constant__ CUtensorMap map_qp,
               const __grid_constant__ CUtensorMap map_gs, const float *__restrict__ sx,
               bf16 *__restrict__ out, int M, int K, int N, int G) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (saddr(smem_raw) + 1023) / 1024 * 1024;
  const uint32_t bufs = ring + STAGES * STAGE_BYTES;  // unpacked tiles
  const uint32_t full = bufs + NBUF * U_BYTES;        // a stage's bytes have landed
  const uint32_t empty = full + STAGES * 8;           // its readers are done
  const uint32_t ufull = empty + STAGES * 8;          // an unpacked tile is written
  const uint32_t ufree = ufull + NBUF * 8;            // its products have retired
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * 128;
  const int per_group = G / (2 * HG), J = K / G, nsteps = K / (2 * HG);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, 4 + NCONS);  // the unpacking warps, the consumers
    }
    for (int b = 0; b < NBUF; ++b) {
      bar_init(ufull + 8 * b, 4);
      bar_init(ufree + 8 * b, NCONS);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp < 4) {
    // step i: packed rows [64 i, 64 i + 64) of group g = i / per_group, at
    // offset c of its G/2 rows; the xq columns of their weight rows, the low
    // run then the high one; the group's gs row
    auto load = [&](int i) {
      const int s = i % STAGES, g = i / per_group, c = (i % per_group) * HG;
      if (i >= STAGES) bar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
      const uint32_t st = ring + s * STAGE_BYTES, bar = full + 8 * s;
      bar_expect(bar, EXPECT);
      tma_load(st + P_OFF, &map_qp, n0, i * HG, bar);
      tma_load(st + A_OFF, &map_xq, g * G + c, m0, bar);
      tma_load(st + A_OFF + RUN_BYTES, &map_xq, g * G + G / 2 + c, m0, bar);
      tma_load(st + G_OFF, &map_gs, n0, g, bar);
    };
    const bool producer = warp == 0 && lane == 0;
    const int c = lane & 7, kb = 4 * warp + (lane >> 3);  // this thread's unpacking block
    uint32_t off[16];
    unpack_offsets(off, c, kb);
    if (producer)
      for (int i = 0; i < AHEAD && i < nsteps; ++i) load(i);
    for (int i = 0; i < nsteps; ++i) {
      if (producer && i + AHEAD < nsteps) load(i + AHEAD);
      const int s = i % STAGES, b = i % NBUF;
      bar_wait(full + 8 * s, (i / STAGES) & 1);
      if (i >= NBUF) bar_wait(ufree + 8 * b, (i / NBUF - 1) & 1);
      unpack(ring + s * STAGE_BYTES + P_OFF, bufs + b * U_BYTES, off, c, kb);
      fence_async_smem();
      __syncwarp();
      if (lane == 0) {
        bar_arrive(ufull + 8 * b);
        bar_arrive(empty + 8 * s);
      }
    }
  } else {
    const int wg = warp / 4 - 1, t = lane % 4;
    // A group's first product overwrites acc (keep = 0). ptxas serialises a
    // warpgroup's products if it reads accumulators while any of its own
    // products are in flight, so each step's products retire before the
    // rescale, which overlaps the other warpgroup's products.
    int acc[64];
    float sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    const uint32_t a_wg = A_OFF + wg * 64 * HG;  // this warpgroup's rows of the xq boxes
    for (int i = 0; i < nsteps; ++i) {
      const int s = i % STAGES, b = i % NBUF, keep = i % per_group != 0;
      const uint32_t st = ring + s * STAGE_BYTES;
      bar_wait(full + 8 * s, (i / STAGES) & 1);
      bar_wait(ufull + 8 * b, (i / NBUF) & 1);
      products(acc, st + a_wg, bufs + b * U_BYTES, keep);
      wgmma_wait<0>();
      if ((i + 1) % per_group == 0) rescale(sum, acc, st + G_OFF, t);  // the group's end
      if (threadIdx.x % 128 == 0) {  // step i is done with
        bar_arrive(empty + 8 * s);
        bar_arrive(ufree + 8 * b);
      }
    }

    // epilogue: bf16(sum * sx[row]), the weights' factor 16 taken out
    // exactly; column pairs as rescale maps them
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * h;
      if (row >= M) continue;
      const float rs = sx[row];
      bf16 *orow = out + static_cast<long long>(row) * N + n0;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int c = jj / 2, i = 4 * jj + 2 * h;
        const float lo = sum[i + (c & 1)], hi = sum[i + 1 - (c & 1)];
        *reinterpret_cast<__nv_bfloat162 *>(orow + 8 * jj + ((2 * t) ^ (c & 6))) =
            __floats2bfloat162_rn(__fmul_rn(__fmul_rn(lo, rs), 0.0625f),
                                  __fmul_rn(__fmul_rn(hi, rs), 0.0625f));
      }
    }
  }
}

}  // namespace q4fwd

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
// out (M, N) bf16; G a multiple of 128 dividing K, at most 1024 (the int32
// group sums of 16 times the weights stay exact in fp32), N a multiple of
// 128, xq, qp and gs 16-byte aligned
extern "C" int int4_matmul_bf16(const void *xq, const void *sx, const void *qp,
                                const void *gs, void *out, int M, int K, int N, int G,
                                void *stream) {
  using namespace q4fwd;
  if (M <= 0 || G <= 0 || G % 128 || G > 1024 || K % G || N % 128) return cudaErrorInvalidValue;
  CUtensorMap mx, mq, mg;
  if (!tensor_map_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, K, HG, 128,
                     CU_TENSOR_MAP_SWIZZLE_64B) ||
      !tensor_map_2d(&mq, CU_TENSOR_MAP_DATA_TYPE_UINT8, qp, K / 2, N, N, BN, HG,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_2d(&mg, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, gs, K / G, N, 4ll * N, BN, 1,
                     CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void *>(fwd_groups),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  fwd_groups<<<dim3(N / BN, (M + 127) / 128), THREADS, SMEM,
               static_cast<cudaStream_t>(stream)>>>(mx, mq, mg, static_cast<const float *>(sx),
                                                    static_cast<bf16 *>(out), M, K, N, G);
  return cudaGetLastError();
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
