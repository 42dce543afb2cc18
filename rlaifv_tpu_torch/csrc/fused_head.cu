// Fused LM head for Hopper (sm_90a): target-token log-probabilities and
// their gradients without the (M, V) logits in device memory. bf16 in,
// fp32 inside.
//
// Replaces: rlaifv_tpu/ops/fused_head.py:_fwd_kernel (the pallas_call of
// _fwd, H <= 2048) and _fwd_kernel_hblocked (the pallas_call of
// _fwd_hblocked, H > 2048) with one forward kernel, and _bwd_dx_kernel and
// _bwd_dw_kernel (the two pallas_calls of _bwd) with the dx and dW kernels.
//
// The function: s = x W^T over the vocabulary (x (M, H), W (V, H), the
// torch lm_head weight), lse = logsumexp(s), logp = s[y] - lse; backward
// dl = g (onehot(y) - exp(s - lse)), dx = dl W, dW = dl^T x.
//
// What bounds it on the H100: tensor-core FLOPs. Every score tile is a
// 64 x 64 x H product (H = 4096 at 7B) that reuses each byte it reads 64
// times, and the backward recomputes the scores in both kernels (the TPU
// kernels' trick: the logits never leave the chip), so the head costs five
// products of 2 M H V FLOP where the plain version costs three.
//
// What the design does about it: the products run on the tensor cores
// (WMMA bf16 x bf16 -> fp32, 16x16x16 fragments) over 64 x 64 operand tiles
// that cp.async streams through shared memory in two stages, so the next H
// chunk loads while the current one multiplies. One score routine serves
// all three kernels; the H contraction is its inner K-loop, which is the
// TPU's row-14 H-blocking in its natural form here, so one forward kernel
// covers both TPU rows 13 and 14.
//
// - forward: one CTA per (64 rows, vocabulary split). It walks its split's
//   64-wide vocabulary tiles and keeps the online (max, sumexp, target
//   logit) of each row in registers (two threads a row). Splitting the
//   vocabulary fills the card at the train step's M ~ 2k (32 row blocks
//   alone would leave 100 of 132 SMs idle); each split writes its partial
//   (max, sumexp, target) and the wrapper combines the few splits with a
//   torch logsumexp, as it computes flash attention's delta.
// - dx: one CTA per (64 rows, vocabulary split). Per vocabulary tile it
//   recomputes the scores, forms dl (rounded to bf16 before its product, as
//   _bwd_dx_kernel does) and adds dl W_tile to an fp32 slab of 64 x H in
//   device memory that only it touches: the (BM, H) fp32 block the TPU kept
//   in VMEM is 1 MB at H = 4096, far above a block's 227 KB of shared
//   memory. The splits' slabs are summed by the wrapper.
// - dW: one CTA per 64 vocabulary rows (500 CTAs at V = 32000). It loops
//   over the row tiles, recomputes the scores and adds dl^T x_tile to its own
//   fp32 slab of 64 x H; the wrapper casts.
// No atomics: every slab element is written by one CTA in a fixed order,
// so reruns give the same bits. wgmma, TMA and warp specialisation are left
// for a later change.
//
// Masking: rows at or past M load as zeros, get dl = 0 and are never
// written; vocabulary columns at or past V score -1e30 in the forward (out
// of the max and the sum) and get dl = 0 in the backward; the W rows past V
// load as zeros. lse = max + log(max(sumexp, 1e-30)), as the TPU kernels.
// H must be a multiple of 64 (the wrapper checks).
#include <math.h>
#include <mma.h>

#include "common.cuh"

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
constexpr int LDP = BN + 8;  // bf16 row stride of the dl tile

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

constexpr int TILE_BYTES = align128(64 * LDT * 2);
constexpr int OFF_A = 0;                             // 2 stages of x chunks
constexpr int OFF_B = OFF_A + 2 * TILE_BYTES;        // 2 stages of W chunks
constexpr int OFF_S = OFF_B + 2 * TILE_BYTES;        // fp32 score tile
constexpr int OFF_DL = OFF_S + align128(BM * LDS * 4);  // bf16 dl tile
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

// dl = g (onehot(y) - exp(s - lse)) of the score tile in sS into the bf16
// tile sDL (rows of this warp); 0 for rows past M and columns past V
__device__ __forceinline__ void form_dl(const float *sS, bf16 *sDL, int m0,
                                        int M, int v0, int V,
                                        const int *__restrict__ y,
                                        const float *__restrict__ lse,
                                        const float *__restrict__ g) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int mi = m0 + row;
  const bool row_ok = mi < M;
  const int yr = row_ok ? y[mi] : -1;
  const float lse_r = row_ok ? lse[mi] : 0.f;
  const float g_r = row_ok ? g[mi] : 0.f;
  const float *srow = sS + row * LDS;
  bf16 *drow = sDL + row * LDP;
#pragma unroll 8
  for (int j = 0; j < BN / 2; ++j) {
    const int c = 2 * j + half;
    const int v = v0 + c;
    float dl = 0.f;
    if (row_ok && v < V)
      dl = g_r * ((v == yr ? 1.f : 0.f) - expf(srow[c] - lse_r));
    drow[c] = __float2bfloat16(dl);
  }
}

__global__ void __launch_bounds__(NTHREADS)
fused_head_dx_kernel(const bf16 *__restrict__ x, const bf16 *__restrict__ w,
                     const int *__restrict__ y, const float *__restrict__ lse,
                     const float *__restrict__ g, float *__restrict__ dx_part,
                     int M, int H, int V, int Mpad) {
  extern __shared__ __align__(128) unsigned char smem[];
  float *sS = reinterpret_cast<float *>(smem + OFF_S);
  bf16 *sDL = reinterpret_cast<bf16 *>(smem + OFF_DL);
  bf16 *sB = reinterpret_cast<bf16 *>(smem + OFF_B);
  constexpr int STAGE = TILE_BYTES / 2;
  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int warp = threadIdx.x / 32;
  // this warp's 16 rows of the split's fp32 slab (Mpad x H)
  float *slab = dx_part + ((long long)split * Mpad + m0 + warp * 16) * H;

  int t0, t1;
  split_range(split, nsplit, (V + BN - 1) / BN, t0, t1);
  FragAcc acc[4];
  const int nh = H / BK;
  for (int t = t0; t < t1; ++t) {
    const int v0 = t * BN;
    score_tile(acc, smem, x, m0, M, w, v0, V, H);
    store_scores(sS, acc);
    form_dl(sS, sDL, m0, M, v0, V, y, lse, g);
    __syncwarp();
    // slab[:, h chunk] += dl (16 x 64 vocabulary) . W[v0 .. v0+64, h chunk]
    stage(sB, w, v0, V, H, 0);
    cp_async_commit();
    for (int hb = 0; hb < nh; ++hb) {
      const int cur = hb & 1;
      if (hb + 1 < nh) {
        stage(sB + (cur ^ 1) * STAGE, w, v0, V, H, (hb + 1) * BK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16 *b = sB + cur * STAGE;
      FragAcc out[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (t == t0)
          wmma::fill_fragment(out[n], 0.f);
        else
          wmma::load_matrix_sync(out[n], slab + hb * BK + n * 16, H,
                                 wmma::mem_row_major);
      }
#pragma unroll
      for (int kk = 0; kk < BN; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sDL + warp * 16 * LDP + kk, LDP);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, b + kk * LDT + n * 16, LDT);
          wmma::mma_sync(out[n], fa, fb, out[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(slab + hb * BK + n * 16, out[n], H,
                                wmma::mem_row_major);
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
fused_head_dw_kernel(const bf16 *__restrict__ x, const bf16 *__restrict__ w,
                     const int *__restrict__ y, const float *__restrict__ lse,
                     const float *__restrict__ g, float *__restrict__ dw32,
                     int M, int H, int V) {
  extern __shared__ __align__(128) unsigned char smem[];
  float *sS = reinterpret_cast<float *>(smem + OFF_S);
  bf16 *sDL = reinterpret_cast<bf16 *>(smem + OFF_DL);
  bf16 *sA = reinterpret_cast<bf16 *>(smem + OFF_A);
  constexpr int STAGE = TILE_BYTES / 2;
  const int v0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  // this warp's 16 vocabulary rows of the fp32 slab (Vpad x H)
  float *slab = dw32 + ((long long)v0 + warp * 16) * H;

  FragAcc acc[4];
  const int nh = H / BK;
  const int n_mt = (M + BM - 1) / BM;
  for (int mt = 0; mt < n_mt; ++mt) {
    const int m0 = mt * BM;
    score_tile(acc, smem, x, m0, M, w, v0, V, H);
    store_scores(sS, acc);
    form_dl(sS, sDL, m0, M, v0, V, y, lse, g);
    // slab[:, h chunk] += dl^T (16 vocabulary x 64 rows) . x[m0 .., h chunk]
    stage(sA, x, m0, M, H, 0);
    cp_async_commit();
    for (int hb = 0; hb < nh; ++hb) {
      const int cur = hb & 1;
      if (hb + 1 < nh) {
        stage(sA + (cur ^ 1) * STAGE, x, m0, M, H, (hb + 1) * BK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // also: every warp's dl rows are in sDL
      const bf16 *b = sA + cur * STAGE;
      FragAcc out[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (mt == 0)
          wmma::fill_fragment(out[n], 0.f);
        else
          wmma::load_matrix_sync(out[n], slab + hb * BK + n * 16, H,
                                 wmma::mem_row_major);
      }
#pragma unroll
      for (int kk = 0; kk < BM; kk += 16) {
        // dl^T: element (vocabulary i, row k) sits at sDL[k * LDP + i]
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, sDL + kk * LDP + warp * 16, LDP);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, b + kk * LDT + n * 16, LDT);
          wmma::mma_sync(out[n], fa, fb, out[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(slab + hb * BK + n * 16, out[n], H,
                                wmma::mem_row_major);
      __syncthreads();
    }
  }
}

cudaError_t set_smem(const void *kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

bool bad_shape(int M, int H, int V) {
  return M <= 0 || V <= 0 || H <= 0 || H % BK != 0;
}

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

// as above, with lse and g (M,) fp32; dx_part (nsplit, Mpad, H) fp32 with
// Mpad = M rounded up to 64: each split's share of dx = dl W (rows past M
// hold zeros)
extern "C" int fused_head_dx_bf16(const void *x, const void *w, const void *y,
                                  const void *lse, const void *g, void *dx_part,
                                  int M, int H, int V, int nsplit, int Mpad,
                                  void *stream) {
  const int n_vt = (V + BN - 1) / BN;
  if (bad_shape(M, H, V) || nsplit < 1 || nsplit > n_vt ||
      Mpad != (M + BM - 1) / BM * BM)
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem(reinterpret_cast<const void *>(fused_head_dx_kernel));
  if (err != cudaSuccess) return err;
  dim3 grid(Mpad / BM, nsplit);
  fused_head_dx_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16 *>(x), static_cast<const bf16 *>(w),
      static_cast<const int *>(y), static_cast<const float *>(lse),
      static_cast<const float *>(g), static_cast<float *>(dx_part), M, H, V, Mpad);
  return cudaGetLastError();
}

// as above; dw32 (Vpad, H) fp32 with Vpad = V rounded up to 64: dW = dl^T x
// (rows past V hold zeros)
extern "C" int fused_head_dw_bf16(const void *x, const void *w, const void *y,
                                  const void *lse, const void *g, void *dw32,
                                  int M, int H, int V, int Vpad, void *stream) {
  if (bad_shape(M, H, V) || Vpad != (V + BN - 1) / BN * BN) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(reinterpret_cast<const void *>(fused_head_dw_kernel));
  if (err != cudaSuccess) return err;
  fused_head_dw_kernel<<<Vpad / BN, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16 *>(x), static_cast<const bf16 *>(w),
      static_cast<const int *>(y), static_cast<const float *>(lse),
      static_cast<const float *>(g), static_cast<float *>(dw32), M, H, V);
  return cudaGetLastError();
}
