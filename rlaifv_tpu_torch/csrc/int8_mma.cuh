// Pieces shared by the int8 tensor-core kernels (quant_matmul.cu,
// int4_matmul.cu and fused_decode.cu): asynchronous 16-byte copies, int8 and
// bf16 tile loads that read zeros outside the matrix, the IEEE row
// quantisation the TPU kernels feed their MXU, int4 nibble unpacking, the
// swizzled staging layout and 4 x 4 byte transpose, and mma.sync m16n8k32 s8.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace rlaifv {

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const int8_t *p) {
  return *reinterpret_cast<const uint32_t *>(p);
}

// 16 bytes of row r, columns [c, c + 16) of a row-major (rows, cols) int8
// matrix into dst (16-byte aligned shared memory); what lies outside the
// matrix reads as zero. vec: rows are 16-byte aligned, so whole chunks
// copy asynchronously.
__device__ __forceinline__ void load16_i8(int8_t *dst, const int8_t *src, int r,
                                          int rows, int c, int cols, bool vec) {
  if (r < rows && c + 16 <= cols && vec) {
    cp_async16(dst, src + (long long)r * cols + c);
  } else if (r < rows && c < cols) {
    const int8_t *row = src + (long long)r * cols;
#pragma unroll
    for (int j = 0; j < 16; ++j) dst[j] = c + j < cols ? row[c + j] : int8_t(0);
  } else {
    *reinterpret_cast<uint4 *>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// 8 bf16 values of row r, columns [c, c + 8) as floats (zero outside);
// vec: rows are 16-byte aligned
__device__ __forceinline__ void load8_bf16(float (&v)[8], const __nv_bfloat16 *src,
                                           int r, int rows, int c, int cols, bool vec) {
  if (r < rows && c + 8 <= cols && vec) {
    bf16x8_to_float(load16(src + (long long)r * cols + c), v);
  } else {
    const __nv_bfloat16 *row = src + (long long)r * cols;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = r < rows && c + j < cols ? __bfloat162float(row[c + j]) : 0.f;
  }
}

// a chunk of activations -> the int8 values the TPU kernels feed their MXU:
// clamp(round_half_even(v / scale), -127, 127), IEEE division
__device__ __forceinline__ uint2 quantize8(const float (&v)[8], float scale) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int q = __float2int_rn(__fdiv_rn(v[j], scale));
    q = max(-127, min(127, q));
    w[j / 4] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (j % 4));
  }
  return make_uint2(w[0], w[1]);
}

// the sign-extended low / high nibbles of 4 packed int4 bytes (pack_int4),
// byte for byte: ((b & 0xF) ^ 8) - 8 and b >> 4 of the TPU kernels' unpack
__device__ __forceinline__ uint32_t lo_nibbles(uint32_t w) {
  const uint32_t n = w & 0x0f0f0f0fu;
  return n | ((n & 0x08080808u) * 0x1eu);  // bit 3 set: the byte's top nibble 0xf
}
__device__ __forceinline__ uint32_t hi_nibbles(uint32_t w) { return lo_nibbles(w >> 4); }

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A staging tile of 128-byte rows: row r's 16-byte chunk c stored at chunk
// c ^ ((r / 4) % 8), so that a transpose's reads (16 rows of one chunk per
// half warp) spread over the banks
__device__ __forceinline__ int swizzle128(int r, int byte) {
  return r * 128 + ((((byte >> 4) ^ (r >> 2)) & 7) << 4) + (byte & 15);
}

// A 4 x 4 byte block: w[r] byte j = m[r][j] -> o[j] byte r = m[r][j]
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4], uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// Rows [m0, m0 + BM) of a (M, C) bf16 matrix: scale = max(max |v|, 1e-20)
// / 127 per row, one warp a row.
template <int BM, int NTHREADS>
__device__ void row_scales(float *srow, const __nv_bfloat16 *a, int m0, int M, int C,
                           bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += NTHREADS / 32) {
    float amax = 0.f;
    if (m0 + r < M) {
      for (int c = lane * 8; c < C; c += 32 * 8) {
        float v[8];
        load8_bf16(v, a, m0 + r, M, c, C, vec);
#pragma unroll
        for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) srow[r] = __fdiv_rn(fmaxf(amax, 1e-20f), 127.0f);
  }
}

}  // namespace rlaifv
