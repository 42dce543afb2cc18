// Helpers shared by the kernels of this directory. Plain CUDA C++, no
// PyTorch headers: each .cu file exports `extern "C"` entry points that the
// Python side loads with ctypes (rlaifv_tpu_torch/ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rlaifv {

// 8 bf16 values (one 16-byte load) -> 8 floats
__device__ __forceinline__ void bf16x8_to_float(const uint4 &u, float *f) {
  const __nv_bfloat162 *h = reinterpret_cast<const __nv_bfloat162 *>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16 *p) {
  return *reinterpret_cast<const uint4 *>(p);
}

}  // namespace rlaifv
