// Fused LM head for Hopper (sm_90a): target-token log-probabilities and
// their gradients without the (M, V) logits in device memory. bf16 in,
// fp32 inside.
//
// The function: s = x W^T over the vocabulary (x (M, H), W (V, H), the
// torch lm_head weight), lse = logsumexp(s), logp = s[y] - lse; backward
// dl = g (onehot(y) - exp(s - lse)), rounded to bf16 before its products
// (as _bwd_dx_kernel rounds it), dx = dl W and dW = dl^T x, each summed in
// fp32 and rounded to bf16 once.
//
// One mainloop serves four epilogues. A CTA computes (128 rows, 256
// columns) tiles of a product over its whole contraction: a ring of STAGES
// shared-memory stages that one producer warp fills with TMA loads of
// 128-byte-swizzled tiles (mbarriers count the bytes in and the consumers'
// releases out) while two consumer warpgroups run wgmma.mma_async
// m64n256k16 (bf16 x bf16 -> fp32 registers) on the stages that have
// arrived. Operands are read as they lie: x and the W rows are K-major for
// the scores, W_c is MN-major for dx, dl_c^T and x are MN-major for dW;
// wgmma transposes 16-bit operands itself (its transpose immediates), so
// no transpose pass exists. Tensor maps are encoded in the C entry points
// (the encoder looked up through the CUDA runtime, no -lcuda); their
// out-of-bounds boxes zero-fill rows at or past M, columns at or past the
// vocabulary's (or the chunk's) width and H tails, and the epilogues mask
// what they read and store. No atomics: every output element is written by
// one CTA in a fixed order, so reruns give the same bits.
//
// Forward (FWD). Replaces rlaifv_tpu/ops/fused_head.py:_fwd_kernel (the
// pallas_call of _fwd, H <= 2048) and _fwd_kernel_hblocked (of
// _fwd_hblocked, H > 2048): the H contraction is the mainloop, at any H. A
// CTA owns 128 rows and one vocabulary split and walks the split's 256-wide
// tiles; the producer's ring runs straight on from one tile's last k-stage
// into the next tile's first, so the next tile's loads overlap this tile's
// epilogue (x's rows are read again per tile, from L2). The epilogue keeps
// an online (max, sum of exp(s - max), target logit) per row in each
// thread's registers (2 rows x 64 columns of the tile a thread): columns at
// or past V are out of the max and the sum, the running sum is rescaled
// when the max rises, and the label's column adds its score. At the split's
// end the 4 threads of a row combine their states and write the row's
// (max, sum, target) partials (3, nsplit, M); a second, small kernel
// combines the splits: lse = max + log(max(sum, 1e-30)), logp = target -
// lse, as the TPU kernels. What bounds it: the product 2 M H V at the
// tensor cores' rate (0.542 ms at M = 2046, H = 4096, V = 32000); the
// M V exponentials take a few microseconds of the SFUs. The wrapper
// (ops/fused_head.py:fwd_splits) picks the splits so that one wave of CTAs,
// one an SM, fills the card.
//
// Backward. Replaces _bwd_dx_kernel and _bwd_dw_kernel (the two
// pallas_calls of _bwd, both built on _dl_tile) with three epilogues that
// the wrapper (ops/fused_head.py) runs once per vocabulary chunk of vc
// columns, in order:
// - DL: S_c = x W_c^T over all of H for a (128 rows, 256 columns) tile of
//   the chunk; the epilogue forms dl from the accumulator registers (the
//   row's label, lse and g against column c0 + j) and writes dl_c (M, vc)
//   bf16 once. The scores are formed once per backward (the two TPU
//   kernels each recompute them);
// - DX: dx (+)= dl_c W_c, K = vc. One chunk writes bf16 dx from the
//   registers; several accumulate into one fp32 (M, H) buffer in chunk
//   order (written by the first, read and rewritten by each later one, the
//   last casting to bf16), the only read-modify-write left;
// - DW: dW[c0:c1] = dl_c^T x, K = M: every element written once, in bf16,
//   from an fp32 register sum over all M rows.
// What bounds them: three bf16 products of 2 M H V at the tensor cores'
// rate (989 TFLOP/s dense), 1.627 ms at M = 2046, H = 4096, V = 32000,
// plus M vc 2 bytes of dl written and read twice a chunk, which the
// products hide. Scratch: M vc 2 bytes of dl (vc chosen by the wrapper so
// that this stays within 256 MiB) plus, with more than one chunk, M H 4
// bytes of fp32 dx.
//
// H must be a multiple of 64 (the wrapper checks).
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

using namespace rlaifv;

constexpr int TM = 128;  // output rows of a CTA tile: two consumer warpgroups of 64
constexpr int TN = 256;  // output columns of a CTA tile: one m64n256k16 per warpgroup
constexpr int TK = 64;   // contraction depth of a stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int NCONS = 2;                   // consumer warpgroups
constexpr int THREADS = NCONS * 128 + 32;  // and one producer warp
constexpr int ATOM = 1024;                 // a 128-byte swizzle atom: 8 rows of 128 bytes
constexpr int BOX = 64 * TK * 2;           // a 64 x 64 bf16 box, 8 KB
constexpr int A_BYTES = TM * TK * 2;
constexpr int B_BYTES = TN * TK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// the ring, its 2 x STAGES barriers and the slack that aligns it to an atom
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + ATOM;
enum Epi { DL = 0, DX = 1, DW = 2, FWD = 3 };
constexpr int FIRST = 1, LAST = 2;  // the dx epilogue's place in the chunk walk
constexpr float kNegInf = -1e30f;   // the forward's empty max: exp(kNegInf - s) is 0

// d (64 x 256, fp32, this warpgroup's registers) = A (64 x 16) B (16 x 256) +
// (d, or 0 when keep is 0), bf16 from shared memory; TA / TB: the operand is
// MN-major (transposed)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da, uint64_t db,
                                          int keep) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(keep), "n"(TA), "n"(TB));
}

struct Params {
  const int *y;      // dl, fwd: labels (M,), in [0, V)
  const float *lse;  // dl: the saved row logsumexp (M,)
  const float *g;    // dl: the upstream gradient (M,)
  bf16 *out;         // dl_c, dx or the chunk's rows of dW
  float *acc32;      // dx: the fp32 sum over chunks (M, H)
  float *part;       // fwd: (3, nsplit, M) partials: max, sum, target
  int rows, cols;    // the output's extent (fwd: M, V): what lies outside is masked
  int ldo;           // the output's row stride in elements (acc32's too)
  int c0;            // dl: the chunk's first vocabulary column
  int mode;          // dx and dW: FIRST | LAST
  int ktiles;        // TK-deep stages along the contraction
  int nsplit;        // fwd: vocabulary splits
};

// dl = g (onehot(y) - exp(s - lse)) of this thread's scores into dl_c (bf16).
// Register i of a thread holds row r0 + 8 ((i >> 1) & 1) and column
// cl + 8 (i >> 2) + (i & 1) of the tile (wgmma's accumulator layout).
__device__ __forceinline__ void epi_dl(const float (&acc)[128], const Params &p, int r0,
                                       int cl) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= p.rows) continue;
    const int yc = p.y[r] - p.c0;  // the label's column in this chunk, if it lies there
    const float lse = p.lse[r], g = p.g[r];
    bf16 *out = p.out + static_cast<long long>(r) * p.ldo;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int c = cl + 8 * j;
      const float d0 = g * ((c == yc ? 1.f : 0.f) - expf(acc[4 * j + 2 * h] - lse));
      const float d1 = g * ((c + 1 == yc ? 1.f : 0.f) - expf(acc[4 * j + 2 * h + 1] - lse));
      if (c + 1 < p.cols)
        *reinterpret_cast<__nv_bfloat162 *>(out + c) = __floats2bfloat162_rn(d0, d1);
      else if (c < p.cols)
        out[c] = __float2bfloat16(d0);
    }
  }
}

// dx and dW: the fp32 sum into bf16 (LAST), into the fp32 buffer (not LAST),
// after the buffer's earlier chunks (not FIRST). cols is a multiple of 64,
// so a column pair never straddles it.
__device__ __forceinline__ void epi_store(const float (&acc)[128], const Params &p, int r0,
                                          int cl) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= p.rows) continue;
    bf16 *out = p.out + static_cast<long long>(r) * p.ldo;
    float *buf = p.acc32 + static_cast<long long>(r) * p.ldo;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int c = cl + 8 * j;
      if (c >= p.cols) continue;
      float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (!(p.mode & FIRST)) {
        const float2 prev = *reinterpret_cast<const float2 *>(buf + c);
        v = make_float2(prev.x + v.x, prev.y + v.y);
      }
      if (p.mode & LAST)
        *reinterpret_cast<__nv_bfloat162 *>(out + c) = __floats2bfloat162_rn(v.x, v.y);
      else
        *reinterpret_cast<float2 *>(buf + c) = v;
    }
  }
}

// The forward's running state of this thread's two rows (labels y0, y1),
// over the columns it holds (2 (lane % 4) + 8 j + {0, 1} of every tile)
struct Online {
  float m[2], s[2], t[2];
};

// One score tile into the running state: the tile's max over the live
// columns, the running sum rescaled to the new max, the tile's exps added,
// and the label's score where the label lies in this thread's columns.
// Register i holds row r0 + 8 ((i >> 1) & 1), column cl + 8 (i >> 2) + (i & 1).
__device__ __forceinline__ void epi_fwd(const float (&acc)[128], const Params &p, int n0,
                                        int y0, int y1, Online &st) {
  const int cl = n0 + 2 * (threadIdx.x % 4);
  const bool whole = n0 + TN <= p.cols;  // no column past V
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (whole || cl + 8 * j + e < p.cols) mx = fmaxf(mx, acc[4 * j + 2 * h + e]);
    const float m_new = fmaxf(st.m[h], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (whole || cl + 8 * j + e < p.cols) sum += __expf(acc[4 * j + 2 * h + e] - m_new);
    st.s[h] = st.s[h] * __expf(st.m[h] - m_new) + sum;
    st.m[h] = m_new;
    const int d = (h ? y1 : y0) - cl;  // the label's offset from this thread's first column
    if (d >= 0 && d < TN && (d & 6) == 0) {
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + e == d) st.t[h] += acc[4 * j + 2 * h + e];
    }
  }
}

// The 4 threads of each row combine their states; the first writes the
// row's partials of this split
__device__ __forceinline__ void fwd_partials(Online &st, const Params &p, int r0, int split) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, st.m[h], o);
      const float s_o = __shfl_xor_sync(0xffffffffu, st.s[h], o);
      const float t_o = __shfl_xor_sync(0xffffffffu, st.t[h], o);
      const float m = fmaxf(st.m[h], m_o);
      st.s[h] = st.s[h] * __expf(st.m[h] - m) + s_o * __expf(m_o - m);
      st.t[h] += t_o;
      st.m[h] = m;
    }
    const int r = r0 + 8 * h;
    if (threadIdx.x % 4 == 0 && r < p.rows) {
      const long long o = static_cast<long long>(split) * p.rows + r;
      const long long plane = static_cast<long long>(p.nsplit) * p.rows;
      p.part[o] = st.m[h];
      p.part[plane + o] = st.s[h];
      p.part[2 * plane + o] = st.t[h];
    }
  }
}

// logp and lse of each row from its splits' partials (3, nsplit, M)
__global__ void fwd_combine(const float *__restrict__ part, int nsplit, int M,
                            float *__restrict__ logp, float *__restrict__ lse) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  const long long plane = static_cast<long long>(nsplit) * M;
  float m = kNegInf;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part[static_cast<long long>(s) * M + r]);
  float sum = 0.f, t = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long long o = static_cast<long long>(s) * M + r;
    sum += part[plane + o] * expf(part[o] - m);
    t += part[2 * plane + o];
  }
  const float l = m + logf(fmaxf(sum, 1e-30f));
  lse[r] = l;
  logp[r] = t - l;
}

// The mainloop. A (TM x K) is K-major (TM rows of K elements) or, for dW,
// MN-major (K rows of TM elements); B (K x TN) is K-major (TN rows of K
// elements) for the scores (FWD, DL) and MN-major (K rows of TN elements)
// for dx and dW. Each stage holds A as one TMA box of 128 rows (K-major) or
// two 64 x 64 boxes (MN-major), and B as one box of 256 rows or four 64 x
// 64 boxes. Warps 0-7 are the two consumer warpgroups (rows 0-63 and
// 64-127 of the tile), warp 8 the producer. A CTA computes the output
// column tiles [t0, t1) of its rows in turn: one for DL, DX and DW; its
// split's vocabulary tiles for FWD.
template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
head_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, const Params p) {
  constexpr int TA = EPI == DW;
  constexpr int TB = EPI == DX || EPI == DW;
  extern __shared__ __align__(1024) unsigned char smem_ring[];
  const uint32_t tiles = (saddr(smem_ring) + ATOM - 1) / ATOM * ATOM;
  const uint32_t full = tiles + STAGES * STAGE_BYTES;  // a stage's bytes have landed
  const uint32_t empty = full + STAGES * 8;            // both consumers are done with it
  // FWD: the splits of one row tile are adjacent in launch order; DL walks
  // the rows fastest (the CTAs at work share W tiles, x stays in L2); DX
  // and DW walk the output columns fastest (they share A tiles)
  int m0, t0, t1, split = 0;
  if (EPI == FWD) {
    split = blockIdx.x % p.nsplit;
    m0 = blockIdx.x / p.nsplit * TM;
    const int n_vt = (p.cols + TN - 1) / TN;
    t0 = static_cast<int>(static_cast<long long>(split) * n_vt / p.nsplit);
    t1 = static_cast<int>(static_cast<long long>(split + 1) * n_vt / p.nsplit);
  } else {
    m0 = (EPI == DL ? blockIdx.x : blockIdx.y) * TM;
    t0 = EPI == DL ? blockIdx.y : blockIdx.x;
    t1 = t0 + 1;
  }
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
      int it = 0;  // stages filled so far, across the CTA's tiles
      for (int t = t0; t < t1; ++t) {
        const int n0 = t * TN;
        for (int kt = 0; kt < p.ktiles; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) bar_wait(empty + 8 * s, (it / STAGES - 1) & 1);
          const uint32_t a = tiles + s * STAGE_BYTES, b = a + A_BYTES, bar = full + 8 * s;
          const int k0 = kt * TK;
          bar_expect(bar, STAGE_BYTES);
          if (TA) {
#pragma unroll
            for (int j = 0; j < TM / 64; ++j) tma_load(a + j * BOX, &map_a, m0 + 64 * j, k0, bar);
          } else {
            tma_load(a, &map_a, k0, m0, bar);
          }
          if (TB) {
#pragma unroll
            for (int j = 0; j < TN / 64; ++j) tma_load(b + j * BOX, &map_b, n0 + 64 * j, k0, bar);
          } else {
            tma_load(b, &map_b, k0, n0, bar);
          }
        }
      }
    }
    return;
  }

  const int wg = warp / 4;  // this warpgroup's 64 rows start one BOX into A
  const int r0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  Online st{{kNegInf, kNegInf}, {0.f, 0.f}, {0.f, 0.f}};
  int y0 = -1, y1 = -1;
  if (EPI == FWD) {
    if (r0 < p.rows) y0 = p.y[r0];
    if (r0 + 8 < p.rows) y1 = p.y[r0 + 8];
  }
  float acc[128];  // a tile's first product overwrites it (keep = 0)
  int it = 0;      // stages consumed so far, across the CTA's tiles
  for (int t = t0; t < t1; ++t) {
    const int n0 = t * TN;
    for (int kt = 0; kt < p.ktiles; ++kt, ++it) {
      const int s = it % STAGES;
      bar_wait(full + 8 * s, (it / STAGES) & 1);
      const uint32_t a = tiles + s * STAGE_BYTES + wg * BOX;
      const uint32_t b = tiles + s * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        // K-major: the next 16 elements lie 32 bytes on along the swizzled
        // row; MN-major: the next 16 rows lie two atoms on, the next 64
        // columns one BOX on (the leading byte offset)
        const uint64_t da = TA ? gmma_desc(a + kk * 2 * ATOM, BOX, ATOM)
                               : gmma_desc(a + kk * 32, 16, ATOM);
        const uint64_t db = TB ? gmma_desc(b + kk * 2 * ATOM, BOX, ATOM)
                               : gmma_desc(b + kk * 32, 16, ATOM);
        wgmma_256<TA, TB>(acc, da, db, kt > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (kt > 0 && threadIdx.x % 128 == 0) bar_arrive(empty + 8 * ((it - 1) % STAGES));
    }
    wgmma_wait<0>();
    if (threadIdx.x % 128 == 0) bar_arrive(empty + 8 * ((it - 1) % STAGES));
    fence_acc(acc);

    if (EPI == FWD)
      epi_fwd(acc, p, n0, y0, y1, st);
    else if (EPI == DL)
      epi_dl(acc, p, r0, n0 + 2 * (lane % 4));
    else
      epi_store(acc, p, r0, n0 + 2 * (lane % 4));
  }
  if (EPI == FWD) fwd_partials(st, p, r0, split);
}

// a tensor map over the row-major bf16 (rows, cols) matrix at base, row
// stride ld elements, read in boxes of box_rows x 64 columns (128 bytes,
// swizzled); boxes read zeros outside the matrix
bool tensor_map(CUtensorMap *map, const void *base, int rows, int cols, int ld,
                int box_rows) {
  return tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rows, cols,
                       static_cast<long long>(ld) * 2, 64, box_rows,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int EPI>
int launch(const CUtensorMap &a, const CUtensorMap &b, const Params &p, dim3 grid,
           void *stream) {
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void *>(head_kernel<EPI>),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  head_kernel<EPI><<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(a, b, p);
  return cudaGetLastError();
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// the chunk [c0, c0 + vw) of a V-row head, its dl rows of stride ldl >= vw
bool bad_chunk(int M, int H, int V, int c0, int vw, int ldl) {
  return M <= 0 || H <= 0 || H % TK != 0 || c0 < 0 || vw <= 0 || c0 + vw > V || ldl < vw ||
         ldl % 8 != 0;
}

}  // namespace

// x (M, H) and w (V, H) bf16 row-major contiguous, y (M,) int32 in [0, V);
// part (3, nsplit, M) fp32 scratch: each vocabulary split's running max,
// sum of exp(s - max) and target logit (0 where y lies in another split);
// writes logp and lse (M,) fp32. H a multiple of 64, 1 <= nsplit <= the
// number of 256-wide vocabulary tiles. Two launches: the tiles, then the
// combine.
extern "C" int fused_head_fwd_bf16(const void *x, const void *w, const void *y, void *part,
                                   void *logp, void *lse, int M, int H, int V, int nsplit,
                                   void *stream) {
  if (M <= 0 || V <= 0 || H <= 0 || H % TK != 0 || nsplit < 1 || nsplit > cdiv(V, TN))
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, x, M, H, H, TM) || !tensor_map(&mb, w, V, H, H, TN))
    return cudaErrorInvalidValue;
  Params p{};
  p.y = static_cast<const int *>(y);
  p.part = static_cast<float *>(part);
  p.rows = M;
  p.cols = V;
  p.ktiles = cdiv(H, TK);
  p.nsplit = nsplit;
  int err = launch<FWD>(ma, mb, p, dim3(cdiv(M, TM) * nsplit), stream);
  if (err != cudaSuccess) return err;
  fwd_combine<<<cdiv(M, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float *>(part), nsplit, M, static_cast<float *>(logp),
      static_cast<float *>(lse));
  return cudaGetLastError();
}

// One vocabulary chunk's dl: x (M, H) and w (V, H) bf16 row-major
// contiguous, y (M,) int32 in [0, V), lse and g (M,) fp32; the chunk is
// w's rows [c0, c0 + vw). Writes dl (M, ldl) bf16 at columns [0, vw): dl =
// g (onehot(y - c0) - exp(x w_c^T - lse)). H a multiple of 64, ldl >= vw a
// multiple of 8.
extern "C" int fused_head_dl_bf16(const void *x, const void *w, const void *y,
                                  const void *lse, const void *g, void *dl, int M, int H,
                                  int V, int c0, int vw, int ldl, void *stream) {
  if (bad_chunk(M, H, V, c0, vw, ldl)) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, x, M, H, H, TM) ||
      !tensor_map(&mb, static_cast<const bf16 *>(w) + static_cast<long long>(c0) * H, vw, H,
                  H, TN))
    return cudaErrorInvalidValue;
  Params p{};
  p.y = static_cast<const int *>(y);
  p.lse = static_cast<const float *>(lse);
  p.g = static_cast<const float *>(g);
  p.out = static_cast<bf16 *>(dl);
  p.rows = M;
  p.cols = vw;
  p.ldo = ldl;
  p.c0 = c0;
  p.ktiles = cdiv(H, TK);
  return launch<DL>(ma, mb, p, dim3(cdiv(M, TM), cdiv(vw, TN)), stream);
}

// That chunk's share of dx = dl W: dl (M, ldl) bf16 as the dl entry point
// leaves it, w as above. mode: FIRST (1), LAST (2), both or neither. The
// first chunk writes the fp32 buffer dx32 (M, H), later ones add to it in
// order, the last writes dx (M, H) bf16 from the sum; a single chunk (mode
// 3) writes dx from its registers and needs no buffer.
extern "C" int fused_head_dx_bf16(const void *dl, const void *w, void *dx32, void *dx,
                                  int M, int H, int V, int c0, int vw, int ldl, int mode,
                                  void *stream) {
  if (bad_chunk(M, H, V, c0, vw, ldl) || mode < 0 || mode > 3 ||
      (mode != (FIRST | LAST) && dx32 == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, dl, M, vw, ldl, TM) ||
      !tensor_map(&mb, static_cast<const bf16 *>(w) + static_cast<long long>(c0) * H, vw, H,
                  H, TK))
    return cudaErrorInvalidValue;
  Params p{};
  p.out = static_cast<bf16 *>(dx);
  p.acc32 = static_cast<float *>(dx32);
  p.rows = M;
  p.cols = H;
  p.ldo = H;
  p.mode = mode;
  p.ktiles = cdiv(vw, TK);
  return launch<DX>(ma, mb, p, dim3(cdiv(H, TN), cdiv(M, TM)), stream);
}

// That chunk's rows of dW = dl^T x: dl (M, ldl) as above, x (M, H) bf16;
// dw points at the chunk's first row of the (V, H) bf16 gradient and
// receives vw rows, each element written once.
extern "C" int fused_head_dw_bf16(const void *dl, const void *x, void *dw, int M, int H,
                                  int vw, int ldl, void *stream) {
  if (bad_chunk(M, H, vw, 0, vw, ldl)) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, dl, M, vw, ldl, TK) || !tensor_map(&mb, x, M, H, H, TK))
    return cudaErrorInvalidValue;
  Params p{};
  p.out = static_cast<bf16 *>(dw);
  p.rows = vw;
  p.cols = H;
  p.ldo = H;
  p.mode = FIRST | LAST;
  p.ktiles = cdiv(M, TK);
  return launch<DW>(ma, mb, p, dim3(cdiv(H, TN), cdiv(vw, TM)), stream);
}
