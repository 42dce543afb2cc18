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
// Forward. Replaces rlaifv_tpu/ops/fused_head.py:_fwd_kernel (the
// pallas_call of _fwd, H <= 2048) and _fwd_kernel_hblocked (of
// _fwd_hblocked, H > 2048) with one kernel: one CTA per (64 rows,
// vocabulary split) walks its split's 64-wide vocabulary tiles and keeps
// each row's online (max, sumexp, target logit) in registers (two threads
// a row); the wrapper combines the few splits with a torch logsumexp.
// Every score tile is a 64 x 64 x H product on WMMA (16x16x16 bf16
// fragments) over operand tiles that cp.async streams through shared
// memory in two stages; the H contraction is its inner K-loop, which is the
// TPU's row-14 H-blocking in its natural form. Vocabulary columns at or
// past V score -1e30 (out of the max and the sum); lse = max +
// log(max(sumexp, 1e-30)), as the TPU kernels. What bounds it: the product
// 2 M H V at the tensor cores' rate, which WMMA reaches a tenth of.
//
// Backward. Replaces _bwd_dx_kernel and _bwd_dw_kernel (the two
// pallas_calls of _bwd, both built on _dl_tile) with three kernels that
// the wrapper (ops/fused_head.py) runs once per vocabulary chunk of vc
// columns, in order:
// - dl: S_c = x W_c^T over all of H for a (128 rows, 256 columns) tile of
//   the chunk; the epilogue forms dl from the accumulator registers (the
//   row's label, lse and g against column c0 + j) and writes dl_c (M, vc)
//   bf16 once. The scores are formed once per backward (the two TPU
//   kernels each recompute them);
// - dx: dx (+)= dl_c W_c, K = vc. One chunk writes bf16 dx from the
//   registers; several accumulate into one fp32 (M, H) buffer in chunk
//   order (written by the first, read and rewritten by each later one, the
//   last casting to bf16), the only read-modify-write left;
// - dW: dW[c0:c1] = dl_c^T x, K = M: every element written once, in bf16,
//   from an fp32 register sum over all M rows.
// What bounds them: three bf16 products of 2 M H V at the tensor cores'
// rate (989 TFLOP/s dense), 1.627 ms at M = 2046, H = 4096, V = 32000,
// plus M vc 2 bytes of dl written and read twice a chunk, which the
// products hide. What the design does about it: the three kernels share
// one mainloop, a ring of STAGES shared-memory stages that one producer
// warp fills with TMA loads of 128-byte-swizzled tiles (mbarriers count the
// bytes in and the consumers' releases out) while two consumer warpgroups
// run wgmma.mma_async m64n256k16 (bf16 x bf16 -> fp32 registers) on the
// stages that have arrived. Operands are read as they lie: x and the W
// rows are K-major for the scores, W_c is MN-major for dx, dl_c^T and x are
// MN-major for dW; wgmma transposes 16-bit operands itself (its
// transpose immediates), so no transpose pass exists. The epilogues are
// separate from the mainloop, so the forward can take it next with an
// online-softmax epilogue. Tensor maps are encoded in the C entry points
// (the encoder looked up through the CUDA runtime, no -lcuda); their
// out-of-bounds boxes zero-fill rows at or past M, columns at or past the
// chunk's width and H tails, and the epilogues mask their stores. No atomics: every
// output element is written by one CTA in a fixed order, so reruns give
// the same bits. Scratch: M vc 2 bytes of dl (vc chosen by the wrapper so
// that this stays within 256 MiB) plus, with more than one chunk, M H 4
// bytes of fp32 dx.
//
// H must be a multiple of 64 (the wrapper checks).
#include <math.h>
#include <mma.h>

#include "common.cuh"
#include "hopper.cuh"

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 64;  // rows (or vocabulary rows, for dW) of a tile
constexpr int BN = 64;  // vocabulary columns of a score tile
constexpr int BK = 64;  // H columns of an operand chunk
constexpr int NWARPS = 4;  // each warp owns 16 rows of a 64-row tile
constexpr int NTHREADS = NWARPS * 32;
constexpr float kNegInf = -1e30f;

constexpr int LDT = BK + 8;  // bf16 row stride of 64 x 64 operand tiles
constexpr int LDS = BN + 4;  // fp32 row stride of the score tile
constexpr int LDP = BN + 8;  // bf16 row stride of the former dl tile (below)

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

constexpr int TILE_BYTES = align128(64 * LDT * 2);
constexpr int OFF_A = 0;                             // 2 stages of x chunks
constexpr int OFF_B = OFF_A + 2 * TILE_BYTES;        // 2 stages of W chunks
constexpr int OFF_S = OFF_B + 2 * TILE_BYTES;        // fp32 score tile
// The former WMMA backward kept a bf16 dl tile here. The forward does not
// use the region; keeping it keeps the forward's shared memory, and so its
// occupancy and measured times, as they were
constexpr int OFF_DL = OFF_S + align128(BM * LDS * 4);
constexpr int SMEM_BYTES = OFF_DL + align128(BM * LDP * 2);

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// start copying rows [r0, r0 + 64) x columns [k0, k0 + 64) of a row-major
// (rows, ld) bf16 matrix into a shared tile; rows at or past `rows` zero
__device__ __forceinline__ void stage(bf16 *dst, const bf16 *src, int r0,
                                      int rows, int ld, int k0) {
  for (int i = threadIdx.x; i < 64 * (BK / 8); i += NTHREADS) {
    const int r = i / (BK / 8), c = i % (BK / 8);
    const bool ok = r0 + r < rows;
    const bf16 *g = ok ? src + (long long)(r0 + r) * ld + k0 + c * 8 : src;
    cp_async16(dst + r * LDT + c * 8, g, ok);
  }
}

// acc (this warp's 16 rows x 64 columns) = x[m0 .. m0+64) . W[v0 .. v0+64)^T
// over all of H, two cp.async stages deep; returns with every warp done
// reading the staging buffers
__device__ void score_tile(FragAcc (&acc)[4], unsigned char *smem,
                           const bf16 *__restrict__ x, int m0, int M,
                           const bf16 *__restrict__ w, int v0, int V, int H) {
  bf16 *sA = reinterpret_cast<bf16 *>(smem + OFF_A);
  bf16 *sB = reinterpret_cast<bf16 *>(smem + OFF_B);
  constexpr int STAGE = TILE_BYTES / 2;  // bf16 elements between stages
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
  const int nk = H / BK;
  stage(sA, x, m0, M, H, 0);
  stage(sB, w, v0, V, H, 0);
  cp_async_commit();
  for (int kb = 0; kb < nk; ++kb) {
    const int cur = kb & 1;
    if (kb + 1 < nk) {
      stage(sA + (cur ^ 1) * STAGE, x, m0, M, H, (kb + 1) * BK);
      stage(sB + (cur ^ 1) * STAGE, w, v0, V, H, (kb + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16 *a = sA + cur * STAGE + warp * 16 * LDT;
    const bf16 *b = sB + cur * STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, a + kk, LDT);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, b + n * 16 * LDT + kk, LDT);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      }
    }
    __syncthreads();  // the stage is consumed before the next one reuses it
  }
}

// the score tile of this warp's 16 rows into shared memory (fp32)
__device__ __forceinline__ void store_scores(float *sS, FragAcc (&acc)[4]) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(sS + warp * 16 * LDS + n * 16, acc[n], LDS,
                            wmma::mem_row_major);
  __syncwarp();
}

// vocabulary tiles [t0, t1) of split `s` out of `nsplit` over n_vt tiles
__device__ __forceinline__ void split_range(int s, int nsplit, int n_vt,
                                            int &t0, int &t1) {
  t0 = (int)((long long)s * n_vt / nsplit);
  t1 = (int)((long long)(s + 1) * n_vt / nsplit);
}

__global__ void __launch_bounds__(NTHREADS)
fused_head_fwd_kernel(const bf16 *__restrict__ x, const bf16 *__restrict__ w,
                      const int *__restrict__ y, float *__restrict__ part_m,
                      float *__restrict__ part_s, float *__restrict__ part_t,
                      int M, int H, int V) {
  extern __shared__ __align__(128) unsigned char smem[];
  float *sS = reinterpret_cast<float *>(smem + OFF_S);
  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // lanes 2i and 2i+1 share row warp*16 + i, 32 interleaved columns each
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int mi = m0 + row;
  const int yr = mi < M ? y[mi] : -1;

  int t0, t1;
  split_range(split, nsplit, (V + BN - 1) / BN, t0, t1);
  float m_run = kNegInf, s_run = 0.f, t_run = 0.f;
  FragAcc acc[4];
  for (int t = t0; t < t1; ++t) {
    const int v0 = t * BN;
    score_tile(acc, smem, x, m0, M, w, v0, V, H);
    store_scores(sS, acc);
    const float *srow = sS + row * LDS;
    float tile_max = kNegInf;
#pragma unroll 8
    for (int j = 0; j < BN / 2; ++j) {
      const int c = 2 * j + half;
      if (v0 + c < V) tile_max = fmaxf(tile_max, srow[c]);
    }
    const float m_new = fmaxf(m_run, tile_max);
    float sum = 0.f;
#pragma unroll 8
    for (int j = 0; j < BN / 2; ++j) {
      const int c = 2 * j + half;
      if (v0 + c < V) {
        sum += expf(srow[c] - m_new);
        if (v0 + c == yr) t_run += srow[c];
      }
    }
    s_run = s_run * expf(m_run - m_new) + sum;
    m_run = m_new;
    __syncwarp();  // the row is read before the next tile's store
  }
  // the two halves of the row
  const float m_o = __shfl_xor_sync(0xffffffffu, m_run, 1);
  const float s_o = __shfl_xor_sync(0xffffffffu, s_run, 1);
  const float t_o = __shfl_xor_sync(0xffffffffu, t_run, 1);
  const float m = fmaxf(m_run, m_o);
  const float s = s_run * expf(m_run - m) + s_o * expf(m_o - m);
  if (half == 0 && mi < M) {
    const long long o = (long long)split * M + mi;
    part_m[o] = m;
    part_s[o] = s;
    part_t[o] = t_run + t_o;
  }
}

cudaError_t set_smem(const void *kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

bool bad_shape(int M, int H, int V) {
  return M <= 0 || V <= 0 || H <= 0 || H % BK != 0;
}

// ------------------------------------------------------------------ backward

namespace bwd {

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
enum Epi { DL = 0, DX = 1, DW = 2 };
constexpr int FIRST = 1, LAST = 2;  // the dx epilogue's place in the chunk walk

// keeps the compiler from moving reads of the accumulators across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, fp32, this warpgroup's registers) += A (64 x 16) B (16 x 256),
// bf16 from shared memory; TA / TB: the operand is MN-major (transposed)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da, uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

struct Params {
  const int *y;      // dl: labels (M,), in [0, V)
  const float *lse;  // dl: the saved row logsumexp (M,)
  const float *g;    // dl: the upstream gradient (M,)
  bf16 *out;         // dl_c, dx or the chunk's rows of dW
  float *acc32;      // dx: the fp32 sum over chunks (M, H)
  int rows, cols;    // the output's extent: stores outside it are masked
  int ldo;           // the output's row stride in elements (acc32's too)
  int c0;            // dl: the chunk's first vocabulary column
  int mode;          // dx and dW: FIRST | LAST
  int ktiles;        // TK-deep stages along the contraction
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

// One CTA computes a TM x TN tile of C = A B over the whole contraction.
// A (TM x K) is K-major (TM rows of K elements) or, for dW, MN-major (K rows
// of TM elements); B (K x TN) is K-major (TN rows of K elements) for dl and
// MN-major (K rows of TN elements) for dx and dW. Each stage holds A as one
// TMA box of 128 rows (K-major) or two 64 x 64 boxes (MN-major), and B as one
// box of 256 rows or four 64 x 64 boxes. Warps 0-7 are the two consumer
// warpgroups (rows 0-63 and 64-127 of the tile), warp 8 the producer.
template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
bwd_kernel(const __grid_constant__ CUtensorMap map_a,
           const __grid_constant__ CUtensorMap map_b, const Params p) {
  constexpr int TA = EPI == DW;
  constexpr int TB = EPI != DL;
  extern __shared__ __align__(1024) unsigned char smem_ring[];
  const uint32_t tiles = (saddr(smem_ring) + ATOM - 1) / ATOM * ATOM;
  const uint32_t full = tiles + STAGES * STAGE_BYTES;  // a stage's bytes have landed
  const uint32_t empty = full + STAGES * 8;            // both consumers are done with it
  // dl walks the rows fastest (the CTAs at work share W tiles, x stays in
  // L2); dx and dW walk the output columns fastest (they share A tiles)
  const int m0 = (EPI == DL ? blockIdx.x : blockIdx.y) * TM;
  const int n0 = (EPI == DL ? blockIdx.y : blockIdx.x) * TN;
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
      for (int kt = 0; kt < p.ktiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) bar_wait(empty + 8 * s, (kt / STAGES - 1) & 1);
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
    return;
  }

  const int wg = warp / 4;  // this warpgroup's 64 rows start one BOX into A
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < p.ktiles; ++kt) {
    const int s = kt % STAGES;
    bar_wait(full + 8 * s, (kt / STAGES) & 1);
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
      wgmma_256<TA, TB>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (kt > 0 && threadIdx.x % 128 == 0) bar_arrive(empty + 8 * ((kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  const int r0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int cl = n0 + 2 * (lane % 4);
  if (EPI == DL)
    epi_dl(acc, p, r0, cl);
  else
    epi_store(acc, p, r0, cl);
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
int launch(const CUtensorMap &a, const CUtensorMap &b, const Params &p, int grid_x,
           int grid_y, void *stream) {
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void *>(bwd_kernel<EPI>),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  bwd_kernel<EPI><<<dim3(grid_x, grid_y), THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      a, b, p);
  return cudaGetLastError();
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// the chunk [c0, c0 + vw) of a V-row head, its dl rows of stride ldl >= vw
bool bad_chunk(int M, int H, int V, int c0, int vw, int ldl) {
  return M <= 0 || H <= 0 || H % TK != 0 || c0 < 0 || vw <= 0 || c0 + vw > V || ldl < vw ||
         ldl % 8 != 0;
}

}  // namespace bwd

}  // namespace

// x (M, H) and w (V, H) bf16 row-major contiguous, y (M,) int32 in [0, V);
// part_m, part_s, part_t (nsplit, M) fp32: each vocabulary split's running
// max, sum of exp(s - max) and target logit (0 where y lies in another
// split). H a multiple of 64.
extern "C" int fused_head_fwd_bf16(const void *x, const void *w, const void *y,
                                   void *part_m, void *part_s, void *part_t,
                                   int M, int H, int V, int nsplit,
                                   void *stream) {
  const int n_vt = (V + BN - 1) / BN;
  if (bad_shape(M, H, V) || nsplit < 1 || nsplit > n_vt) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(reinterpret_cast<const void *>(fused_head_fwd_kernel));
  if (err != cudaSuccess) return err;
  dim3 grid((M + BM - 1) / BM, nsplit);
  fused_head_fwd_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16 *>(x), static_cast<const bf16 *>(w),
      static_cast<const int *>(y), static_cast<float *>(part_m),
      static_cast<float *>(part_s), static_cast<float *>(part_t), M, H, V);
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
  using namespace bwd;
  if (bad_chunk(M, H, V, c0, vw, ldl)) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, x, M, H, H, TM) ||
      !tensor_map(&mb, static_cast<const bf16 *>(w) + static_cast<long long>(c0) * H, vw, H,
                  H, TN))
    return cudaErrorInvalidValue;
  const Params p{static_cast<const int *>(y), static_cast<const float *>(lse),
                 static_cast<const float *>(g), static_cast<bf16 *>(dl), nullptr,
                 M, vw, ldl, c0, 0, cdiv(H, TK)};
  return launch<DL>(ma, mb, p, cdiv(M, TM), cdiv(vw, TN), stream);
}

// That chunk's share of dx = dl W: dl (M, ldl) bf16 as the dl entry point
// leaves it, w as above. mode: FIRST (1), LAST (2), both or neither. The
// first chunk writes the fp32 buffer dx32 (M, H), later ones add to it in
// order, the last writes dx (M, H) bf16 from the sum; a single chunk (mode
// 3) writes dx from its registers and needs no buffer.
extern "C" int fused_head_dx_bf16(const void *dl, const void *w, void *dx32, void *dx,
                                  int M, int H, int V, int c0, int vw, int ldl, int mode,
                                  void *stream) {
  using namespace bwd;
  if (bad_chunk(M, H, V, c0, vw, ldl) || mode < 0 || mode > 3 ||
      (mode != (FIRST | LAST) && dx32 == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, dl, M, vw, ldl, TM) ||
      !tensor_map(&mb, static_cast<const bf16 *>(w) + static_cast<long long>(c0) * H, vw, H,
                  H, TK))
    return cudaErrorInvalidValue;
  const Params p{nullptr, nullptr, nullptr, static_cast<bf16 *>(dx),
                 static_cast<float *>(dx32), M, H, H, 0, mode, cdiv(vw, TK)};
  return launch<DX>(ma, mb, p, cdiv(H, TN), cdiv(M, TM), stream);
}

// That chunk's rows of dW = dl^T x: dl (M, ldl) as above, x (M, H) bf16;
// dw points at the chunk's first row of the (V, H) bf16 gradient and
// receives vw rows, each element written once.
extern "C" int fused_head_dw_bf16(const void *dl, const void *x, void *dw, int M, int H,
                                  int vw, int ldl, void *stream) {
  using namespace bwd;
  if (bad_chunk(M, H, vw, 0, vw, ldl)) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, dl, M, vw, ldl, TK) || !tensor_map(&mb, x, M, H, H, TK))
    return cudaErrorInvalidValue;
  const Params p{nullptr, nullptr, nullptr, static_cast<bf16 *>(dw), nullptr,
                 vw, H, H, 0, FIRST | LAST, cdiv(M, TK)};
  return launch<DW>(ma, mb, p, cdiv(H, TN), cdiv(vw, TM), stream);
}
