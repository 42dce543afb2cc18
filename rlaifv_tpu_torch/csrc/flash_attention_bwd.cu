// Flash attention backward for Hopper (sm_90a): dq and dk/dv, bf16 in and
// out, fp32 inside.
//
// Replaces: rlaifv_tpu/ops/flash_attention.py:_bwd_dq_kernel and
// _bwd_dkv_kernel (the two pallas_calls of _bwd), the TPU kernels behind
// the gradient of `flash_attention`.
//
// What bounds it on the H100: tensor-core FLOPs. Each CTA reuses a 64-row
// tile of Q (dq kernel) or of K/V (dk/dv kernel) against every tile it
// streams, so at training lengths (L ~ 2048, D = 128) the five products of
// the backward (S = QK^T, dP = dO V^T, dq = dS K, dv = P^T dO,
// dk = dS^T Q) dominate the bytes read.
//
// What the design does about it: the products run on the tensor cores
// (WMMA bf16 x bf16 -> fp32, 16x16x16 fragments). The TPU kernels keep the
// whole K (or the whole Q) resident in VMEM and score one (BQ, L) or
// (Lq, BK) product, which no Hopper SM holds, so here both kernels stream
// 64-row tiles through shared memory. The split is the TPU's own: dq comes
// from one kernel (one CTA per batch, head and 64 query rows, streaming the
// K/V tiles up to the causal diagonal) and dk/dv from the other (one CTA
// per batch, kv head and 64 keys, looping over the n_rep query heads of
// that kv head and over the query tiles from the diagonal on). No atomics:
// every output element is written once by one CTA, so the gradient is
// deterministic. dq accumulates in WMMA fragments (registers); dk and dv,
// which a warp updates from two products a tile, accumulate in fp32 shared
// memory. Probabilities are recomputed from the forward's saved lse:
// p = exp(s * scale - lse); the products take P and dS rounded to bf16, as
// the TPU kernels' bf16 MXU path does. delta = rowsum(dO * O) is a plain
// torch reduction outside, as it is an XLA fusion outside on the TPU.
// wgmma, TMA and warp specialisation are left for a later change.
//
// Masking is the forward's: a key with mask 0, or (causal) a key past the
// query's absolute position q_offset + row, has p = 0. That covers the rows
// the forward reported as fully masked (their lse is about -5e29): every
// entry of such a row is masked, so the row adds nothing and gets dq = 0.
// Query rows past Lq and key rows past Lk are zero-filled, add nothing and
// are never written.
#include <math.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // key rows per tile
constexpr int NWARPS = 4;  // each warp owns 16 rows of the CTA's own tile
constexpr int NTHREADS = NWARPS * 32;
static_assert(BQ == 16 * NWARPS && BK == 16 * NWARPS, "16 rows a warp");

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// element strides (batch, position, head) of q, k, v and dO
struct Strides {
  long long qb, ql, qh, kb, kl, kh, vb, vl, vh, ob, ol, oh;
};

template <int D>
struct Tiles {
  static constexpr int LDQ = D + 8;   // bf16 row stride of Q/K/V/dO tiles
  static constexpr int LDS = 64 + 4;  // fp32 row stride of 64-wide score tiles
  static constexpr int LDP = 64 + 8;  // bf16 row stride of 64-wide P/dS tiles
  static constexpr int LDA = D + 4;   // fp32 row stride of D-wide sums
  static constexpr int TILE = align128(64 * LDQ * 2);
  static constexpr int SCORE = align128(64 * LDS * 4);
  static constexpr int PROB = align128(64 * LDP * 2);
  static constexpr int ACC = align128(64 * LDA * 4);
  static constexpr int ROW = align128(64 * 4);
};

template <int D>
struct DqLayout : Tiles<D> {
  using T = Tiles<D>;
  static constexpr int Q = 0;
  static constexpr int DO = Q + T::TILE;
  static constexpr int K = DO + T::TILE;
  static constexpr int V = K + T::TILE;
  static constexpr int S = V + T::TILE;
  static constexpr int DP = S + T::SCORE;
  static constexpr int DS = DP + T::SCORE;
  static constexpr int OUT = DS + T::PROB;
  static constexpr int MASK = OUT + T::ACC;
  static constexpr int BYTES = MASK + T::ROW;
};

template <int D>
struct DkvLayout : Tiles<D> {
  using T = Tiles<D>;
  static constexpr int K = 0;
  static constexpr int V = K + T::TILE;
  static constexpr int Q = V + T::TILE;
  static constexpr int DO = Q + T::TILE;
  static constexpr int ST = DO + T::TILE;
  static constexpr int DPT = ST + T::SCORE;
  static constexpr int PT = DPT + T::SCORE;
  static constexpr int DST = PT + T::PROB;
  static constexpr int DK = DST + T::PROB;
  static constexpr int DV = DK + T::ACC;
  static constexpr int LSE = DV + T::ACC;
  static constexpr int DELTA = LSE + T::ROW;
  static constexpr int BYTES = DELTA + T::ROW;
};

// rows [row0, row0 + 64) of a (.., L, .., D) operand into a shared tile,
// zero-filling rows at or past `rows`; 16-byte loads along D
template <int D>
__device__ __forceinline__ void load_tile(bf16 *dst, const bf16 *src,
                                          long long row_stride, int row0,
                                          int rows) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows) val = rlaifv::load16(src + (row0 + r) * row_stride + c * 8);
    *reinterpret_cast<uint4 *>(dst + r * Tiles<D>::LDQ + c * 8) = val;
  }
}

// out[16 x 64] (fp32, this warp's rows) = A[16 x D] . B[64 x D]^T, with A
// and B row-major bf16 tiles in shared memory
template <int D>
__device__ __forceinline__ void product_abt(float *out, const bf16 *a,
                                            const bf16 *b) {
  constexpr int LDQ = Tiles<D>::LDQ;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk, LDQ);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + n * 16 * LDQ + kk, LDQ);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], Tiles<D>::LDS,
                            wmma::mem_row_major);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16 *__restrict__ q, const bf16 *__restrict__ k,
                    const bf16 *__restrict__ v, const int *__restrict__ mask,
                    const bf16 *__restrict__ dout,
                    const float *__restrict__ lse,
                    const float *__restrict__ delta, bf16 *__restrict__ dq,
                    int H, int KVH, int Lq, int Lk, Strides st, int causal,
                    int q_offset, float scale) {
  using Lay = DqLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *sQ = reinterpret_cast<bf16 *>(smem + Lay::Q);
  bf16 *sDO = reinterpret_cast<bf16 *>(smem + Lay::DO);
  bf16 *sK = reinterpret_cast<bf16 *>(smem + Lay::K);
  bf16 *sV = reinterpret_cast<bf16 *>(smem + Lay::V);
  float *sS = reinterpret_cast<float *>(smem + Lay::S);
  float *sDP = reinterpret_cast<float *>(smem + Lay::DP);
  bf16 *sDS = reinterpret_cast<bf16 *>(smem + Lay::DS);
  float *sOut = reinterpret_cast<float *>(smem + Lay::OUT);
  int *sMask = reinterpret_cast<int *>(smem + Lay::MASK);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile<D>(sQ, q + b * st.qb + h * st.qh, st.ql, q0, Lq);
  load_tile<D>(sDO, dout + b * st.ob + h * st.oh, st.ol, q0, Lq);

  // lanes 2i and 2i+1 share query row warp*16 + i, 32 columns each
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int qi = q0 + row;
  const bool row_ok = qi < Lq;
  const long long stat = ((long long)b * H + h) * Lq + qi;
  const float lse_r = row_ok ? lse[stat] : 0.f;
  const float delta_r = row_ok ? delta[stat] : 0.f;
  const int qpos = q_offset + qi;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  // keys past the tile's last query position are never read
  int kv_end = Lk;
  if (causal) kv_end = min(Lk, q_offset + min(q0 + BQ, Lq));

  const bf16 *kb = k + b * st.kb + kvh * st.kh;
  const bf16 *vb = v + b * st.vb + kvh * st.vh;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous K/V tile is consumed
    load_tile<D>(sK, kb, st.kl, k0, Lk);
    load_tile<D>(sV, vb, st.vl, k0, Lk);
    for (int j = threadIdx.x; j < BK; j += NTHREADS)
      sMask[j] = (k0 + j < Lk) ? mask[(long long)b * Lk + k0 + j] : 0;
    __syncthreads();

    const int wrow = warp * 16;
    product_abt<D>(sS + wrow * Tiles<D>::LDS, sQ + wrow * Tiles<D>::LDQ, sK);
    product_abt<D>(sDP + wrow * Tiles<D>::LDS, sDO + wrow * Tiles<D>::LDQ, sV);
    __syncwarp();

    // dS = P o (dP - delta) * scale, P = exp(S * scale - lse)
    {
      const float *srow = sS + row * Tiles<D>::LDS;
      const float *dprow = sDP + row * Tiles<D>::LDS;
      bf16 *dsrow = sDS + row * Tiles<D>::LDP;
#pragma unroll 8
      for (int j = 0; j < BK / 2; ++j) {
        const int c = 2 * j + half;
        const bool ok = row_ok && sMask[c] != 0 && (!causal || k0 + c <= qpos);
        const float p = ok ? expf(srow[c] * scale - lse_r) : 0.f;
        dsrow[c] = __float2bfloat16(p * (dprow[c] - delta_r) * scale);
      }
    }
    __syncwarp();

    // dq += dS K for this warp's 16 rows
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sDS + wrow * Tiles<D>::LDP + kk, Tiles<D>::LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sK + kk * Tiles<D>::LDQ + n * 16, Tiles<D>::LDQ);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      }
    }
  }

  float *orow_base = sOut + warp * 16 * Tiles<D>::LDA;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(orow_base + n * 16, acc[n], Tiles<D>::LDA,
                            wmma::mem_row_major);
  __syncwarp();
  if (row_ok) {
    const float *orow = sOut + row * Tiles<D>::LDA;
    bf16 *dst = dq + (((long long)b * Lq + qi) * H + h) * D;
#pragma unroll 8
    for (int j = 0; j < D / 2; ++j) {
      const int c = 2 * j + half;
      dst[c] = __float2bfloat16(orow[c]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16 *__restrict__ q, const bf16 *__restrict__ k,
                     const bf16 *__restrict__ v, const int *__restrict__ mask,
                     const bf16 *__restrict__ dout,
                     const float *__restrict__ lse,
                     const float *__restrict__ delta, bf16 *__restrict__ dk,
                     bf16 *__restrict__ dv, int H, int KVH, int Lq, int Lk,
                     Strides st, int causal, int q_offset, float scale) {
  using Lay = DkvLayout<D>;
  constexpr int LDQ = Tiles<D>::LDQ, LDS = Tiles<D>::LDS;
  constexpr int LDP = Tiles<D>::LDP, LDA = Tiles<D>::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *sK = reinterpret_cast<bf16 *>(smem + Lay::K);
  bf16 *sV = reinterpret_cast<bf16 *>(smem + Lay::V);
  bf16 *sQ = reinterpret_cast<bf16 *>(smem + Lay::Q);
  bf16 *sDO = reinterpret_cast<bf16 *>(smem + Lay::DO);
  float *sST = reinterpret_cast<float *>(smem + Lay::ST);
  float *sDPT = reinterpret_cast<float *>(smem + Lay::DPT);
  bf16 *sPT = reinterpret_cast<bf16 *>(smem + Lay::PT);
  bf16 *sDST = reinterpret_cast<bf16 *>(smem + Lay::DST);
  float *sDK = reinterpret_cast<float *>(smem + Lay::DK);
  float *sDV = reinterpret_cast<float *>(smem + Lay::DV);
  float *sLse = reinterpret_cast<float *>(smem + Lay::LSE);
  float *sDelta = reinterpret_cast<float *>(smem + Lay::DELTA);

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = H / KVH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;

  load_tile<D>(sK, k + b * st.kb + kvh * st.kh, st.kl, k0, Lk);
  load_tile<D>(sV, v + b * st.vb + kvh * st.vh, st.vl, k0, Lk);
  for (int i = threadIdx.x; i < 64 * LDA; i += NTHREADS) {
    sDK[i] = 0.f;
    sDV[i] = 0.f;
  }

  // lanes 2i and 2i+1 share key row warp*16 + i, 32 query columns each
  const int row = wrow + (lane >> 1);
  const int half = lane & 1;
  const int kj = k0 + row;
  const bool key_ok = kj < Lk && mask[(long long)b * Lk + kj] != 0;

  // query rows before the first one that may see this key tile are skipped
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - q_offset) / BQ * BQ;

  for (int r = 0; r < n_rep; ++r) {
    const int h = kvh * n_rep + r;
    const bf16 *q_head = q + b * st.qb + h * st.qh;
    const bf16 *do_head = dout + b * st.ob + h * st.oh;
    const long long stat0 = ((long long)b * H + h) * Lq;
    for (int q0 = q_begin; q0 < Lq; q0 += BQ) {
      __syncthreads();  // the previous Q/dO tile is consumed
      load_tile<D>(sQ, q_head, st.ql, q0, Lq);
      load_tile<D>(sDO, do_head, st.ol, q0, Lq);
      for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
        const bool ok = q0 + i < Lq;
        sLse[i] = ok ? lse[stat0 + q0 + i] : 0.f;
        sDelta[i] = ok ? delta[stat0 + q0 + i] : 0.f;
      }
      __syncthreads();

      product_abt<D>(sST + wrow * LDS, sK + wrow * LDQ, sQ);
      product_abt<D>(sDPT + wrow * LDS, sV + wrow * LDQ, sDO);
      __syncwarp();

      // P^T and dS^T = P^T o (dP^T - delta) * scale for this key row
      {
        const float *srow = sST + row * LDS;
        const float *dprow = sDPT + row * LDS;
        bf16 *prow = sPT + row * LDP;
        bf16 *dsrow = sDST + row * LDP;
#pragma unroll 8
        for (int j = 0; j < BQ / 2; ++j) {
          const int c = 2 * j + half;
          const int qi = q0 + c;
          const bool ok = key_ok && qi < Lq && (!causal || kj <= q_offset + qi);
          const float p = ok ? expf(srow[c] * scale - sLse[c]) : 0.f;
          prow[c] = __float2bfloat16(p);
          dsrow[c] = __float2bfloat16(p * (dprow[c] - sDelta[c]) * scale);
        }
      }
      __syncwarp();

      // dV += P^T dO and dK += dS^T Q for this warp's 16 key rows
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> av, ak;
        float *pv = sDV + wrow * LDA + n * 16;
        float *pk = sDK + wrow * LDA + n * 16;
        wmma::load_matrix_sync(av, pv, LDA, wmma::mem_row_major);
        wmma::load_matrix_sync(ak, pk, LDA, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BQ; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, sPT + wrow * LDP + kk, LDP);
          wmma::load_matrix_sync(fb, sDO + kk * LDQ + n * 16, LDQ);
          wmma::mma_sync(av, fa, fb, av);
          wmma::load_matrix_sync(fa, sDST + wrow * LDP + kk, LDP);
          wmma::load_matrix_sync(fb, sQ + kk * LDQ + n * 16, LDQ);
          wmma::mma_sync(ak, fa, fb, ak);
        }
        wmma::store_matrix_sync(pv, av, LDA, wmma::mem_row_major);
        wmma::store_matrix_sync(pk, ak, LDA, wmma::mem_row_major);
      }
    }
  }

  __syncthreads();  // the sums are complete (and zero if no tile ran)
  if (kj < Lk) {
    const float *krow = sDK + row * LDA;
    const float *vrow = sDV + row * LDA;
    const long long off = (((long long)b * Lk + kj) * KVH + kvh) * D;
#pragma unroll 8
    for (int j = 0; j < D / 2; ++j) {
      const int c = 2 * j + half;
      dk[off + c] = __float2bfloat16(krow[c]);
      dv[off + c] = __float2bfloat16(vrow[c]);
    }
  }
}

template <int D>
cudaError_t launch(const bf16 *q, const bf16 *k, const bf16 *v, const int *mask,
                   const bf16 *dout, const float *lse, const float *delta,
                   bf16 *dq, bf16 *dk, bf16 *dv, int B, int H, int KVH, int Lq,
                   int Lk, const Strides &st, int causal, int q_offset,
                   float scale, cudaStream_t stream) {
  if (dq != nullptr) {
    constexpr int bytes = DqLayout<D>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((Lq + BQ - 1) / BQ, H, B);
    flash_bwd_dq_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
        q, k, v, mask, dout, lse, delta, dq, H, KVH, Lq, Lk, st, causal,
        q_offset, scale);
  } else {
    constexpr int bytes = DkvLayout<D>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((Lk + BK - 1) / BK, KVH, B);
    flash_bwd_dkv_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
        q, k, v, mask, dout, lse, delta, dk, dv, H, KVH, Lq, Lk, st, causal,
        q_offset, scale);
  }
  return cudaGetLastError();
}

int dispatch(const void *q, const void *k, const void *v, const void *mask,
             const void *dout, const void *lse, const void *delta, void *dq,
             void *dk, void *dv, int B, int H, int KVH, int Lq, int Lk, int D,
             const int *s, int causal, int q_offset, float scale,
             void *stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || Lq <= 0 || Lk <= 0 || q_offset < 0)
    return cudaErrorInvalidValue;
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5],
                   s[6], s[7], s[8], s[9], s[10], s[11]};
  const auto *qp = static_cast<const bf16 *>(q);
  const auto *kp = static_cast<const bf16 *>(k);
  const auto *vp = static_cast<const bf16 *>(v);
  const auto *mp = static_cast<const int *>(mask);
  const auto *op = static_cast<const bf16 *>(dout);
  const auto *lp = static_cast<const float *>(lse);
  const auto *dp = static_cast<const float *>(delta);
  auto *dqp = static_cast<bf16 *>(dq);
  auto *dkp = static_cast<bf16 *>(dk);
  auto *dvp = static_cast<bf16 *>(dv);
  auto stm = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(qp, kp, vp, mp, op, lp, dp, dqp, dkp, dvp, B, H, KVH,
                        Lq, Lk, st, causal, q_offset, scale, stm);
    case 128:
      return launch<128>(qp, kp, vp, mp, op, lp, dp, dqp, dkp, dvp, B, H, KVH,
                         Lq, Lk, st, causal, q_offset, scale, stm);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Lq, H, D), k/v (B, Lk, KVH, D), dout (B, Lq, H, D) bf16 with unit
// stride along D and the given element strides for (batch, position, head);
// mask (B, Lk) int32; lse and delta (B, H, Lq) fp32 contiguous; dq
// (B, Lq, H, D) bf16 contiguous.
extern "C" int flash_attention_bwd_dq_bf16(
    const void *q, const void *k, const void *v, const void *mask,
    const void *dout, const void *lse, const void *delta, void *dq, int B,
    int H, int KVH, int Lq, int Lk, int D, int qsb, int qsl, int qsh, int ksb,
    int ksl, int ksh, int vsb, int vsl, int vsh, int osb, int osl, int osh,
    int causal, int q_offset, float scale, void *stream) {
  if (dq == nullptr) return cudaErrorInvalidValue;
  const int s[12] = {qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, osb, osl, osh};
  return dispatch(q, k, v, mask, dout, lse, delta, dq, nullptr, nullptr, B, H,
                  KVH, Lq, Lk, D, s, causal, q_offset, scale, stream);
}

// as above; dk and dv (B, Lk, KVH, D) bf16 contiguous, each the sum over
// the n_rep = H / KVH query heads of its kv head
extern "C" int flash_attention_bwd_dkv_bf16(
    const void *q, const void *k, const void *v, const void *mask,
    const void *dout, const void *lse, const void *delta, void *dk, void *dv,
    int B, int H, int KVH, int Lq, int Lk, int D, int qsb, int qsl, int qsh,
    int ksb, int ksl, int ksh, int vsb, int vsl, int vsh, int osb, int osl,
    int osh, int causal, int q_offset, float scale, void *stream) {
  if (dk == nullptr || dv == nullptr) return cudaErrorInvalidValue;
  const int s[12] = {qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, osb, osl, osh};
  return dispatch(q, k, v, mask, dout, lse, delta, nullptr, dk, dv, B, H, KVH,
                  Lq, Lk, D, s, causal, q_offset, scale, stream);
}
