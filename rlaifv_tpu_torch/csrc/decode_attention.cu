// Prefix decode attention for Hopper (sm_90a): one query token per head
// over a static (B, L, KVH, D) bf16 KV cache, reading only the live prefix.
//
// Replaces: rlaifv_tpu/ops/decode_attention.py:_prefix_kernel (launched by
// decode_attention_prefix's pallas_call), TPU kernel #4: the kernel of every
// bf16 decode step of generate / generate_repeated, and of the bf16
// Llama3-8B divide-and-conquer backend (GQA, n_rep 4).
//
// What it computes (the plain version is ops/decode_attention.py::
// decode_attention_prefix_ref): s = (q . k) / sqrt(D) over cache columns
// [0, valid_len), -1e30 where mask == 0; m = max(max s, -5e29); p = exp(s -
// m); out = (p . v) / max(sum p, 1e-30), in bf16. A row whose live keys are
// all masked returns exactly 0. GQA head h = kv_head * n_rep + r.
//
// What bounds it on the H100: HBM bytes. Each cached key and value is used
// once per query head of its group (n_rep multiply-adds per element read),
// far below the ~295 operations per byte at which the tensor cores would
// become the limit, so time tracks the bytes of K and V read.
//
// What the design does about it:
// - CTAs that fill the card: the live keys [0, valid_len) are split into
//   `splits` ranges (ops/decode_attention.py:prefix_plan: only while the
//   B x KVH (batch row, kv head) CTAs miss one CTA an SM, at least
//   PREFIX_MIN_KEYS keys a split; Llama3's GQA step, B 8 x KVH 8 = 64 CTAs
//   on 132 SMs, takes 2). One CTA owns one (batch row, kv head, split) and
//   serves all n_rep query heads, so every K/V byte is read once. Three
//   CTAs fit an SM, and a batch of many rows fills them; a split beyond one
//   CTA an SM reads no faster (tools/split_sweep.py): one CTA's 64 KB in
//   flight already keeps its SM's share of HBM busy, and every split adds
//   its state to the merge.
// - Bytes in flight: each of the CTA's 4 warps walks its own tiles of 16
//   keys (tile w, w + 4, ... of the split) through its own ring of
//   shared-memory stages (2 at D 128, 4 at D 64; 64 KB a CTA, three CTAs an
//   SM), fed by TMA from rank-4 tensor maps over (D, valid_len, KVH, B):
//   boxes of 16 keys x 64 columns, 128-byte swizzled. A stage is refilled as
//   soon as its warp has read it, so a CTA keeps up to 64 KB in flight and
//   no warp waits on another. The maps end at valid_len:
//   TMA fills a box's keys past it with zeros and never reads those
//   columns. The mask of a tile comes in by cp.async (zeros past the split's
//   last key: those keys read as masked).
// - Few instructions a byte: both products on the tensor cores (mma.sync
//   m16n8k16 bf16, fp32 sums). Scores as S^T = K Q^T (16 keys the m side,
//   the n_rep heads padded to the n side of 8, q^T's fragments in
//   registers), an online softmax on those accumulators in log2 units (one
//   exp2f a key and head, one a tile and head for the rescale), P^T moved
//   into the B fragment of O^T += V^T P^T by movmatrix (P rounded to bf16
//   for this product: the flash forward's rounding), V^T read by
//   ldmatrix.trans. Each warp keeps (m, l, O^T) for its tiles; the CTA's
//   warps merge through shared memory.
// - The split's state: with one split the CTA writes the output; with
//   several each writes its (acc, m, l) and prefix_merge (launched
//   programmatically: it starts while the splits run and waits for them)
//   combines them in split order in one pass, rescaling to a running max
//   (the loads of four splits in flight at once): out = (sum acc_s 2^(m_s -
//   M)) / max(sum l_s 2^(m_s - M), 1e-30), M = max m_s.
//
// The fully masked row: every running max starts at the clamp -5e29 and a
// masked key's p is 0 (the reference's exp(-1e30 - m) is an exact fp32 0
// whenever m >= -5e29). A split or a warp with no live key ends with m =
// -5e29, l = 0 and acc = 0, which adds exactly 0 to a merge, and a row with
// no live key anywhere writes 0 / max(0, 1e-30) = 0.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "int8_mma.cuh"

using bf16 = __nv_bfloat16;

namespace {

using namespace rlaifv;

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TILE = 16;           // keys a warp reads a stage
constexpr int RING_BYTES = 65536;  // a CTA's stages: three CTAs an SM
constexpr int HP = 8;              // heads a product holds: n_rep padded to the n side
constexpr float M_FLOOR = -5e29f;  // NEG_INF / 2: the reference's clamp of the max
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct Geo {
  static constexpr int HALF = TILE * 128;  // 64 columns of a tile: 16 rows of 128 bytes
  static constexpr int KV = TILE * D * 2;  // a tile of k (or v): D / 64 halves
  static constexpr int SLOT = 2 * KV;      // k, then v
  static constexpr int STAGES = RING_BYTES / NWARPS / SLOT;
  static constexpr int SMEM = NWARPS * STAGES * SLOT + 1024;  // + the alignment slack
  static_assert(D == 64 || D == 128, "D 64 or 128");
  static_assert(STAGES >= 2, "two stages a warp at least");
  static_assert(NWARPS * HP * D * 4 <= RING_BYTES, "the warps' merge fits the ring");
};

// byte offset of row r's 16-byte chunk c in a 64-column half, as TMA's
// 128-byte swizzle lays it: the 8 rows of an ldmatrix land on distinct banks
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void cp_async4(void *smem, const void *gmem, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// the transpose of an 8 x 8 bf16 matrix held as mma fragments (a thread
// holds row lane / 4, columns 2 (lane % 4) and + 1)
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// d += A (16 x 16, row-major fragments) B (16 x 8), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// part: (B, H, splits, D + 2) fp32, a split's acc over D, then m (log2
// units) and l
template <int D>
__global__ void __launch_bounds__(NTHREADS, 3)
prefix_split(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
             const bf16 *__restrict__ q, const int *__restrict__ mask, bf16 *__restrict__ out,
             float *__restrict__ part, int REP, int KVH, int L, int valid_len, long long qsb,
             long long qsh, float scale) {
  using G = Geo<D>;
  extern __shared__ __align__(1024) unsigned char smem_prefix[];
  unsigned char *ring = smem_prefix + ((1024 - saddr(smem_prefix) % 1024) % 1024);
  __shared__ __align__(8) uint64_t s_full[NWARPS][G::STAGES];  // a stage's k and v have landed
  __shared__ int s_mask[NWARPS][G::STAGES][TILE];
  __shared__ float s_m[NWARPS][HP], s_l[NWARPS][HP];

  grid_launch_dependents();  // the merge may launch now and wait
  // scores in log2 units (s log2 e), so every exponential is one exp2f
  scale *= LOG2E;
  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int l0 = static_cast<int>(static_cast<long long>(split) * valid_len / splits);
  const int l1 = static_cast<int>(static_cast<long long>(split + 1) * valid_len / splits);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, t = lane % 4;
  // this warp's tiles: keys l0 + TILE (warp + NWARPS i) .., i < n
  const int n_tiles = (l1 - l0 + TILE - 1) / TILE;
  const int n = n_tiles > warp ? (n_tiles - warp + NWARPS - 1) / NWARPS : 0;
  unsigned char *wring = ring + warp * G::STAGES * G::SLOT;
  if (lane == 0) {
    for (int st = 0; st < G::STAGES; ++st) bar_init(saddr(&s_full[warp][st]), 1);
    bar_init_fence();
  }
  __syncthreads();

  // tile i of this warp into stage i % STAGES: k and v by TMA (lane 0), the
  // mask by cp.async (zeros past the split's last key); past the last tile
  // an empty group keeps the group count
  const int *mrow = mask + static_cast<long long>(b) * L;
  auto issue = [&](int i) {
    if (i < n) {
      const int st = i % G::STAGES;
      const int t0 = l0 + TILE * (warp + NWARPS * i);
      if (lane == 0) {
        unsigned char *dst = wring + st * G::SLOT;
        const uint32_t bar = saddr(&s_full[warp][st]);
        bar_expect(bar, G::SLOT);
#pragma unroll
        for (int h = 0; h < D / 64; ++h) {
          tma_load_4d(saddr(dst + h * G::HALF), &map_k, 64 * h, t0, g, b, bar);
          tma_load_4d(saddr(dst + G::KV + h * G::HALF), &map_v, 64 * h, t0, g, b, bar);
        }
      }
      if (lane < TILE) {
        const int key = t0 + lane;
        cp_async4(&s_mask[warp][st][lane], mrow + min(key, l1 - 1), key < l1 ? 4 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < G::STAGES; ++i) issue(i);

  // q^T as the scores' B fragments: head gq (zeros past REP), columns
  // 16 kk + 2 t, + 1 and 16 kk + 8 + 2 t, + 1
  uint32_t qb[D / 16][2];
  {
    const bf16 *qr = q + b * qsb + static_cast<long long>(g * REP + min(gq, REP - 1)) * qsh;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qb[kk][0] = gq < REP ? *reinterpret_cast<const uint32_t *>(qr + 16 * kk + 2 * t) : 0u;
      qb[kk][1] = gq < REP ? *reinterpret_cast<const uint32_t *>(qr + 16 * kk + 8 + 2 * t) : 0u;
    }
  }
  // this thread's heads 2 t, 2 t + 1: running max (log2 units), its own
  // keys' share of the sum, and O^T: o[mt][e] is column 16 mt + gq + 8 (e >>
  // 1) of head 2 t + (e & 1)
  float m[2] = {M_FLOOR, M_FLOOR}, l[2] = {0.f, 0.f};
  float o[D / 16][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
  // the ldmatrix row of this lane: K (A of the scores) rows lane % 8 + 8
  // ((lane / 8) % 2), chunk + lane / 16; V (A of O^T, transposed) rows lane %
  // 8 + 8 (lane / 16), chunk + (lane / 8) % 2
  const int rk = (lane & 7) + 8 * ((lane >> 3) & 1), ck = lane >> 4;
  const int rv = (lane & 7) + 8 * (lane >> 4), cv = (lane >> 3) & 1;

#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int st = i % G::STAGES;
    cp_async_wait<G::STAGES - 1>();  // this lane's mask copy of tile i has landed
    __syncwarp();                    // ... and every lane's
    bar_wait(saddr(&s_full[warp][st]), (i / G::STAGES) & 1);  // ... and its k and v
    const uint32_t kt = saddr(wring + st * G::SLOT), vt = kt + G::KV;

    // S^T = K Q^T: c[e] is key gq + 8 (e >> 1), head 2 t + (e & 1); two
    // chains of products, summed
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, kt + (kk >> 2) * G::HALF + swz(rk, 2 * (kk & 3) + ck));
      mma_bf16(c[kk & 1], a, qb[kk]);
    }
    const bool live[2] = {s_mask[warp][st][gq] != 0, s_mask[warp][st][gq + 8] != 0};
    float s[4], p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = (c[0][e] + c[1][e]) * scale;
    // the tile's max of each head over its live keys (the 8 lanes of one t)
    float mx[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(live[0] ? s[hh] : -INFINITY, live[1] ? s[2 + hh] : -INFINITY);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(FULL, mx[hh], off));
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], mx[hh]);
      corr[hh] = exp2f(m[hh] - m_new);
      p[hh] = live[0] ? exp2f(s[hh] - m_new) : 0.f;
      p[2 + hh] = live[1] ? exp2f(s[2 + hh] - m_new) : 0.f;
      l[hh] = l[hh] * corr[hh] + (p[hh] + p[2 + hh]);
      m[hh] = m_new;
    }
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][e] *= corr[e & 1];
    // P^T as the B fragment of O^T += V^T P^T: keys 2 t, + 1 (and + 8) of
    // head gq, the transposes of the key-major 8 x 8 blocks this thread holds
    const uint32_t pb[2] = {movmatrix_trans(pack_bf16(p[0], p[1])),
                            movmatrix_trans(pack_bf16(p[2], p[3]))};
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, vt + (mt >> 2) * G::HALF + swz(rv, 2 * (mt & 3) + cv));
      mma_bf16(o[mt], a, pb);
    }
    // the stage is read: refill it
    fence_async_smem();
    __syncwarp();
    issue(i + G::STAGES);
  }
  cp_async_wait<0>();

  // the sums over this warp's keys (the 8 lanes of one t)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) l[hh] += __shfl_xor_sync(FULL, l[hh], off);
  __syncthreads();  // every warp is done with the ring: it holds the merge
  float *s_acc = reinterpret_cast<float *>(ring);  // [NWARPS][HP][D]
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 2 * t + (e & 1);
      if (r < REP) s_acc[(warp * HP + r) * D + 16 * mt + gq + 8 * (e >> 1)] = o[mt][e];
    }
  if (gq == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      s_m[warp][2 * t + hh] = m[hh];
      s_l[warp][2 * t + hh] = l[hh];
    }
  }
  __syncthreads();

  // merge the warps; write (B, H, D), or this split's state
  for (int idx = threadIdx.x; idx < REP * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    float mx = M_FLOOR;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, s_m[w][r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float a = exp2f(s_m[w][r] - mx);
      num += s_acc[(w * HP + r) * D + d] * a;
      den += s_l[w][r] * a;
    }
    const long long h = static_cast<long long>(b) * KVH * REP + g * REP + r;
    if (splits == 1) {
      out[h * D + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
    } else {
      float *ps = part + (h * splits + split) * (D + 2);
      ps[d] = num;
      if (d == 0) {
        ps[D] = mx;
        ps[D + 1] = den;
      }
    }
  }
}

// one CTA a (row, head), a thread a column of D: the splits' states, in
// split order, each rescaled to the running max of those before it and itself
template <int D>
__global__ void __launch_bounds__(D)
prefix_merge(const float *__restrict__ part, bf16 *__restrict__ out, int splits) {
  grid_dependency_wait();  // the splits' states
  const float *p = part + static_cast<long long>(blockIdx.x) * splits * (D + 2);
  const int d = threadIdx.x;
  // one pass with a running max: the loads of four splits in flight at once
  float mx = M_FLOOR, num = 0.f, den = 0.f;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const float *ps = p + s * (D + 2);
    const float m_s = ps[D], l_s = ps[D + 1], acc_s = ps[d];
    const float m_new = fmaxf(mx, m_s);
    const float c = exp2f(mx - m_new), a = exp2f(m_s - m_new);
    num = num * c + acc_s * a;
    den = den * c + l_s * a;
    mx = m_new;
  }
  out[static_cast<long long>(blockIdx.x) * D + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
}

struct Args {
  const bf16 *q;
  const void *k, *v;
  const int *mask;
  bf16 *out;
  float *part;
  int B, REP, KVH, L, valid_len, splits;
  long long qsb, qsh;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch(const Args &a) {
  using G = Geo<D>;
  static bool smem_set = false;  // once a process: a decode step calls this per layer
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(reinterpret_cast<const void *>(prefix_split<D>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  // the live prefix as (D, valid_len, KVH, B), read in boxes of 64 columns x
  // TILE keys: keys past valid_len read as zeros and are never fetched
  CUtensorMap mk, mv;
  const long long sl = static_cast<long long>(a.KVH) * D, sb = sl * a.L;
  if (!attention_map(&mk, a.k, a.B, a.valid_len, a.KVH, D, sb, sl, D, TILE) ||
      !attention_map(&mv, a.v, a.B, a.valid_len, a.KVH, D, sb, sl, D, TILE))
    return cudaErrorInvalidValue;
  const dim3 grid(a.KVH, a.B, a.splits);
  prefix_split<D><<<grid, NTHREADS, G::SMEM, a.stream>>>(mk, mv, a.q, a.mask, a.out, a.part,
                                                          a.REP, a.KVH, a.L, a.valid_len,
                                                          a.qsb, a.qsh, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  // launched while the splits still run; it waits for them
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.KVH * a.REP);
  cfg.blockDim = dim3(D);
  cfg.stream = a.stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, prefix_merge<D>, static_cast<const float *>(a.part), a.out,
                            a.splits);
}

}  // namespace

// q (B, H, D) bf16 with unit stride along D and element strides qsb, qsh
// (4-byte aligned); k/v (B, L, KVH, D) bf16 contiguous and 16-byte aligned;
// mask (B, L) int32 contiguous; out (B, H, D) bf16 contiguous. D 64 or 128,
// n_rep = H / KVH 1, 2, 4 or 8. Reads cache columns [0, valid_len) only, in
// `splits` ranges (1 to valid_len): with more than one, part is (B, H,
// splits, D + 2) fp32 scratch and a second launch merges the splits.
// Anything else is refused.
extern "C" int decode_attention_prefix_bf16(const void *q, const void *k, const void *v,
                                            const void *mask, void *out, void *part, int B,
                                            int H, int KVH, int L, int D, int valid_len,
                                            int splits, int qsb, int qsh, float scale,
                                            void *stream) {
  const auto aligned = [](const void *p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (B < 1 || KVH <= 0 || H % KVH != 0 || valid_len < 1 || valid_len > L || !aligned(k) ||
      !aligned(v))
    return cudaErrorInvalidValue;
  const int rep = H / KVH;
  if ((rep != 1 && rep != 2 && rep != 4 && rep != 8) || splits < 1 || splits > valid_len ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16 *>(q), k, v, static_cast<const int *>(mask),
               static_cast<bf16 *>(out), static_cast<float *>(part), B, rep, KVH, L,
               valid_len, splits, qsb, qsh, scale, static_cast<cudaStream_t>(stream)};
  if (D == 128) return launch<128>(a);
  if (D == 64) return launch<64>(a);
  return cudaErrorInvalidValue;
}
