// Flash attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces: rlaifv_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _fwd's pallas_call), the TPU kernel behind `flash_attention`.
//
// What bounds it on the H100: tensor-core FLOPs. At the autocheck prefix
// prefill (Lq = Lk ~ 740, D = 128) every key tile is reused by 64 query
// rows, so the kernel does ~64 multiply-adds per byte it reads, and the
// score and output products dominate.
//
// What the design does about it: the products run on the tensor cores
// (WMMA bf16 x bf16 -> fp32, 16x16x16 fragments); the TPU kernel kept all
// of K resident in VMEM and scored it in one product, which does not fit a
// Hopper SM, so here one CTA owns a (batch, head, 64-query-row) tile and
// streams 64-key K/V tiles through shared memory with an online softmax,
// stopping at the causal diagonal (about half the tiles of a square causal
// problem are never read). Ragged edges are masked in the kernel, so no
// 128-padding is needed. Scores, the running max/sum and the output sum
// stay fp32; probabilities are rounded to bf16 for the P.V product, as the
// TPU kernel's bf16 MXU path does. wgmma, TMA and warp specialisation are
// left for a later change.
//
// Semantics kept from the TPU kernel: scale 1/sqrt(D); key mask (int32,
// nonzero = attend) plus an optional causal mask on absolute positions
// (q_offset + row); GQA by h / (H / KVH); a row whose keys are all masked
// outputs exactly 0 and lse = -5e29 + log(1e-30); otherwise
// lse = max + log(sum).
#include <math.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // key columns per tile
constexpr int NWARPS = BQ / 16;  // each warp owns 16 query rows
constexpr int NTHREADS = NWARPS * 32;
static_assert(BQ == BK, "load_tile stages Q and K/V tiles of one height");
// the TPU kernel floors its running max at -1e30/2: a row whose keys are
// all masked keeps max = -inf here and reports this floor in its lse
constexpr float kMaskedRowMax = -5e29f;

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;   // bf16 row stride of Q/K/V tiles
  static constexpr int LDS = BK + 4;  // fp32 row stride of the score tile
  static constexpr int LDP = BK + 8;  // bf16 row stride of the probability tile
  static constexpr int LDO = D + 4;   // fp32 row stride of the output sum
  static constexpr int Q = 0;
  static constexpr int K = Q + align128(BQ * LDQ * 2);
  static constexpr int V = K + align128(BK * LDQ * 2);
  static constexpr int S = V + align128(BK * LDQ * 2);
  static constexpr int P = S + align128(BQ * LDS * 4);
  static constexpr int O = P + align128(BQ * LDP * 2);
  static constexpr int MASK = O + align128(BQ * LDO * 4);
  static constexpr int BYTES = MASK + align128(BK * 4);
};

// rows [row0, row0 + 64) of a (.., L, .., D) operand into a shared tile,
// zero-filling rows at or past `rows`; 16-byte loads along D
template <int D>
__device__ __forceinline__ void load_tile(bf16 *dst, const bf16 *src,
                                          long long row_stride, int row0,
                                          int rows) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < BK * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows) val = rlaifv::load16(src + (row0 + r) * row_stride + c * 8);
    *reinterpret_cast<uint4 *>(dst + r * Layout<D>::LDQ + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16 *__restrict__ q, const bf16 *__restrict__ k,
                 const bf16 *__restrict__ v, const int *__restrict__ mask,
                 bf16 *__restrict__ out, float *__restrict__ lse, int H,
                 int KVH, int Lq, int Lk, long long qsb, long long qsl,
                 long long qsh, long long ksb, long long ksl, long long ksh,
                 long long vsb, long long vsl, long long vsh, int causal,
                 int q_offset, float scale) {
  using Lay = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *sQ = reinterpret_cast<bf16 *>(smem + Lay::Q);
  bf16 *sK = reinterpret_cast<bf16 *>(smem + Lay::K);
  bf16 *sV = reinterpret_cast<bf16 *>(smem + Lay::V);
  float *sS = reinterpret_cast<float *>(smem + Lay::S);
  bf16 *sP = reinterpret_cast<bf16 *>(smem + Lay::P);
  float *sO = reinterpret_cast<float *>(smem + Lay::O);
  int *sMask = reinterpret_cast<int *>(smem + Lay::MASK);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile<D>(sQ, q + b * qsb + h * qsh, qsl, q0, Lq);
  for (int i = threadIdx.x; i < BQ * Lay::LDO; i += NTHREADS) sO[i] = 0.f;

  // softmax bookkeeping: lanes 2i and 2i+1 share query row warp*16 + i and
  // keep identical copies of its running max and sum
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int qpos = q_offset + q0 + row;
  float m_run = -INFINITY;
  float l_run = 0.f;

  // keys past the tile's last query position are never read
  int kv_end = Lk;
  if (causal) kv_end = min(Lk, q_offset + min(q0 + BQ, Lq));

  const bf16 *kb = k + b * ksb + kvh * ksh;
  const bf16 *vb = v + b * vsb + kvh * vsh;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(sK, kb, ksl, k0, Lk);
    load_tile<D>(sV, vb, vsl, k0, Lk);
    for (int j = threadIdx.x; j < BK; j += NTHREADS)
      sMask[j] = (k0 + j < Lk) ? mask[(long long)b * Lk + k0 + j] : 0;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + warp * 16 * Lay::LDQ + kk, Lay::LDQ);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
          wmma::load_matrix_sync(bt, sK + n * 16 * Lay::LDQ + kk, Lay::LDQ);
          wmma::mma_sync(acc[n], a, bt, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 16; ++n)
        wmma::store_matrix_sync(sS + warp * 16 * Lay::LDS + n * 16, acc[n],
                                Lay::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile; each lane of a pair takes 32 columns
    {
      float *srow = sS + row * Lay::LDS;
      bf16 *prow = sP + row * Lay::LDP;
      float mx = -INFINITY;
#pragma unroll 8
      for (int j = 0; j < BK / 2; ++j) {
        const int c = 2 * j + half;
        const bool ok = sMask[c] != 0 && (!causal || k0 + c <= qpos);
        const float s = ok ? srow[c] * scale : -INFINITY;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_run, mx);
      // m_new == -inf: nothing attended yet, the sums stay 0
      const float alpha = (m_new == -INFINITY) ? 1.f : expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll 8
      for (int j = 0; j < BK / 2; ++j) {
        const int c = 2 * j + half;
        const float s = srow[c];
        const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
        prow[c] = __float2bfloat16(p);
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      float *orow = sO + row * Lay::LDO;
#pragma unroll 8
      for (int j = 0; j < D / 2; ++j) orow[2 * j + half] *= alpha;
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      float *optr = sO + warp * 16 * Lay::LDO + n * 16;
      wmma::load_matrix_sync(o, optr, Lay::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, sP + warp * 16 * Lay::LDP + kk, Lay::LDP);
        wmma::load_matrix_sync(bv, sV + kk * Lay::LDQ + n * 16, Lay::LDQ);
        wmma::mma_sync(o, a, bv, o);
      }
      wmma::store_matrix_sync(optr, o, Lay::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (q0 + row < Lq) {
    const float l_safe = fmaxf(l_run, 1e-30f);
    const float inv = 1.f / l_safe;
    const float *orow = sO + row * Lay::LDO;
    bf16 *dst = out + (((long long)b * Lq + q0 + row) * H + h) * D;
#pragma unroll 8
    for (int j = 0; j < D / 2; ++j) {
      const int c = 2 * j + half;
      dst[c] = __float2bfloat16(orow[c] * inv);
    }
    if (half == 0)
      lse[((long long)b * H + h) * Lq + q0 + row] =
          fmaxf(m_run, kMaskedRowMax) + logf(l_safe);
  }
}

template <int D>
cudaError_t launch(const bf16 *q, const bf16 *k, const bf16 *v, const int *mask,
                   bf16 *out, float *lse, int B, int H, int KVH, int Lq, int Lk,
                   const long long *s, int causal, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      q, k, v, mask, out, lse, H, KVH, Lq, Lk, s[0], s[1], s[2], s[3], s[4],
      s[5], s[6], s[7], s[8], causal, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, Lq, H, D), k/v (B, Lk, KVH, D) bf16 with unit stride along D and the
// given element strides for (batch, position, head); mask (B, Lk) int32;
// out (B, Lq, H, D) bf16 and lse (B, H, Lq) fp32, both contiguous.
extern "C" int flash_attention_fwd_bf16(
    const void *q, const void *k, const void *v, const void *mask, void *out,
    void *lse, int B, int H, int KVH, int Lq, int Lk, int D, int qsb, int qsl,
    int qsh, int ksb, int ksl, int ksh, int vsb, int vsl, int vsh, int causal,
    int q_offset, float scale, void *stream) {
  if (KVH <= 0 || H % KVH != 0 || Lq <= 0 || Lk <= 0 || q_offset < 0)
    return cudaErrorInvalidValue;
  const long long s[9] = {qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh};
  auto st = static_cast<cudaStream_t>(stream);
  const auto *qp = static_cast<const bf16 *>(q);
  const auto *kp = static_cast<const bf16 *>(k);
  const auto *vp = static_cast<const bf16 *>(v);
  const auto *mp = static_cast<const int *>(mask);
  auto *op = static_cast<bf16 *>(out);
  auto *lp = static_cast<float *>(lse);
  switch (D) {
    case 64:
      return launch<64>(qp, kp, vp, mp, op, lp, B, H, KVH, Lq, Lk, s, causal,
                        q_offset, scale, st);
    case 128:
      return launch<128>(qp, kp, vp, mp, op, lp, B, H, KVH, Lq, Lk, s, causal,
                         q_offset, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
