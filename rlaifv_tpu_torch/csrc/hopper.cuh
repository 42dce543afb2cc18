// Hopper (sm_90a) building blocks shared by the TMA + wgmma kernels of this
// directory (fused_head.cu, quant_matmul.cu, int4_matmul.cu,
// flash_attention.cu, flash_attention_bwd.cu, decode_attention_int8.cu):
// mbarriers, 1D/2D/3D/4D TMA
// loads, wgmma shared-memory descriptors, fences, programmatic dependent
// launch, the int8 products (n128 and n256) and the bf16 products of the
// attention kernels, and the tensor-map encoders looked up through the CUDA
// runtime (no -lcuda).
#pragma once

#include <cuda.h>  // CUtensorMap and the encode function's types only
#include <cuda_runtime.h>
#include <stdint.h>

namespace rlaifv {

// ~4 s at the H100's clock: a wait that never ends traps instead of hanging
constexpr long long SPIN_CYCLES = 1ll << 33;

__device__ __forceinline__ uint32_t saddr(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// after every bar_init of the block, before any thread uses the barriers
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to wait for
__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > SPIN_CYCLES) __trap();
  }
}

// the box at (c_inner, c_outer) of a 2D tensor map into shared memory; the
// barrier counts its bytes (zeros for the part outside the tensor)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap *map,
                                         int c_inner, int c_outer, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c_inner), "r"(c_outer)
      : "memory");
}

// the box at element c0 of a 1D tensor map
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap *map, int c0,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// the box at (c0, c1, c2), innermost first, of a 3D tensor map
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap *map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the box at (c0, c1, c2, c3), innermost first, of a 4D tensor map
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap *map, int c0,
                                            int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Programmatic dependent launch: a grid launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start once every
// CTA of the grid before it has called grid_launch_dependents (or exited);
// grid_dependency_wait returns when that grid has finished and its writes
// are visible.
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// generic-proxy writes to shared memory, visible to wgmma reads after the
// next barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's shared-memory matrix descriptor of a swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units) and the
// layout: 1 = 128-byte swizzle, 2 = 64-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout = 1) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32 |
         layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128 int32, this warpgroup's registers) = A (64 x 32) B^T + (d, or
// 0 when keep is 0), int8 x int8, both operands K-major: A and B from
// shared memory (descriptors). Register i of a thread holds row 16 (warp %
// 4) + lane / 4 + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 (lane % 4) +
// (i & 1) of the tile.
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[64], uint64_t da, uint64_t db,
                                            int keep = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(keep));
}

// the same with A from registers: a[0..3] hold rows lane / 4 and lane / 4 + 8
// of this warp's 16, at columns 4 (lane % 4) + 0..3 (a[0], a[1]) and
// 16 + 4 (lane % 4) + 0..3 (a[2], a[3]), four int8 a register (mma.sync
// m16n8k32's A layout)
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256 int32) += A (64 x 32) B^T, as wgmma_s8_ss at twice the width:
// register i of a thread holds row 16 (warp % 4) + lane / 4 + 8 ((i >> 1) &
// 1) and column 8 (i >> 2) + 2 (lane % 4) + (i & 1), i < 128
#define RLAIFV_I8(d, i)                                                                 \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),          \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define RLAIFV_I32(d, i) RLAIFV_I8(d, i), RLAIFV_I8(d, i + 8), RLAIFV_I8(d, i + 16), \
                         RLAIFV_I8(d, i + 24)
#define RLAIFV_R128                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "     \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "     \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "     \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "     \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "     \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "     \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"

__device__ __forceinline__ void wgmma_s8_ss256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " RLAIFV_R128
      ", %128, %129, p;\n}\n"
      : RLAIFV_I32(d, 0), RLAIFV_I32(d, 32), RLAIFV_I32(d, 64), RLAIFV_I32(d, 96)
      : "l"(da), "l"(db), "r"(1));
}

// The bf16 products of the attention kernels: d (64 x N fp32, this
// warpgroup's registers; register i of a thread holds row 16 (warp % 4) +
// lane / 4 + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 (lane % 4) + (i & 1))
// += A (64 x 16) B (16 x N), or = when keep is 0. wgmma_bf16_ss: A and B
// from shared memory, both K-major. wgmma_bf16_rs: A from registers (a[0..3]
// of a thread hold rows lane / 4 and lane / 4 + 8 of this warp's 16 at
// columns 2 (lane % 4) + {0, 1} and 8 + 2 (lane % 4) + {0, 1}: mma.sync
// m16n8k16's A fragment, which is also how the accumulator above holds
// columns 16 s .. 16 s + 15 in registers 8 s .. 8 s + 7), B K-major (TB = 0)
// or MN-major (TB = 1).
#define RLAIFV_F8(d, i)                                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define RLAIFV_F32(d, i) RLAIFV_F8(d, i), RLAIFV_F8(d, i + 8), RLAIFV_F8(d, i + 16), \
                         RLAIFV_F8(d, i + 24)
#define RLAIFV_R32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define RLAIFV_R64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

template <int N>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                              int keep);
template <>
__device__ __forceinline__ void wgmma_bf16_ss<64>(float (&d)[32], uint64_t da, uint64_t db,
                                                  int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RLAIFV_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RLAIFV_F32(d, 0)
      : "l"(da), "l"(db), "r"(keep));
}
template <>
__device__ __forceinline__ void wgmma_bf16_ss<128>(float (&d)[64], uint64_t da, uint64_t db,
                                                   int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RLAIFV_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : RLAIFV_F32(d, 0), RLAIFV_F32(d, 32)
      : "l"(da), "l"(db), "r"(keep));
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t db);
template <>
__device__ __forceinline__ void wgmma_bf16_rs<64, 1>(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RLAIFV_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RLAIFV_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16_rs<128, 1>(float (&d)[64], const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RLAIFV_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RLAIFV_F32(d, 0), RLAIFV_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// keeps the compiler from moving reads of fp32 accumulators across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keeps the compiler from moving reads of the accumulators across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap *, CUtensorMapDataType, cuuint32_t, void *,
                                const cuuint64_t *, const cuuint64_t *, const cuuint32_t *,
                                const cuuint32_t *, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void *f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A tensor map over the row-major (rows, cols) matrix at base, row stride
// ld_bytes, read in boxes of box_rows x box_cols elements; boxes read zeros
// outside the matrix. The base must be 16-byte aligned and ld_bytes a
// multiple of 16 (false otherwise, or when the encoder refuses).
inline bool tensor_map_2d(CUtensorMap *map, CUtensorMapDataType type, const void *base,
                          long long rows, long long cols, long long ld_bytes, int box_cols,
                          int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 || ld_bytes % 16 != 0)
    return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, type, 2, const_cast<void *>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map of `rank` (1 to 5) dimensions, innermost first: dims[i]
// elements along dimension i, strides[i - 1] bytes between neighbours along
// dimension i >= 1 (in any order: (D, position, head, batch) views of a fused
// projection have a head stride below the position stride), read in boxes of
// box[i] elements; boxes read zeros outside the tensor. The base must be
// 16-byte aligned and every stride a positive multiple of 16 (false
// otherwise, or when the encoder refuses).
inline bool tensor_map_nd(CUtensorMap *map, CUtensorMapDataType type, const void *base,
                          int rank, const long long *dims, const long long *strides,
                          const int *box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || rank < 1 || rank > 5 || reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], step[5];
  for (int i = 0; i < rank; ++i) {
    if (dims[i] <= 0 || box[i] <= 0 || box[i] > 256) return false;
    d[i] = static_cast<cuuint64_t>(dims[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
    step[i] = 1;
    if (i > 0) {
      if (strides[i - 1] <= 0 || strides[i - 1] % 16 != 0) return false;
      s[i - 1] = static_cast<cuuint64_t>(strides[i - 1]);
    }
  }
  return encode(map, type, rank, const_cast<void *>(base), d, s, b, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a tensor map over n elements in a row, read box at a time (no swizzle); a
// box must start 16-byte aligned
inline bool tensor_map_1d(CUtensorMap *map, CUtensorMapDataType type, const void *base,
                          long long n, int box) {
  return tensor_map_nd(map, type, base, 1, &n, nullptr, &box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// the attention kernels' operands: a tensor map over a bf16 (B, L, heads, D)
// tensor with element strides (sb, sl, sh) and unit stride along D, read in
// boxes of 64 columns x `rows` positions (128 bytes a row, swizzled); a
// dimension of extent 1 takes any valid stride
inline bool attention_map(CUtensorMap *map, const void *base, int B, int L, int heads, int D,
                          long long sb, long long sl, long long sh, int rows) {
  const long long dims[4] = {D, L, heads, B};
  long long strides[3] = {2 * sl, 2 * sh, 2 * sb};
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] == 1) strides[i] = 2ll * D;
  const int box[4] = {64, rows, 1, 1};
  return tensor_map_nd(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 4, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace rlaifv
