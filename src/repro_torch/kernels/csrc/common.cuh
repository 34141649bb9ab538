// Shared helpers of the port's CUDA kernels: dtype codes and loads and
// stores that convert between the storage type and fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

// dtype codes passed by the Python wrappers (kernels/_lib.py DTYPES)
enum : int { DT_F32 = 0, DT_BF16 = 1 };

// lse of a row with no live key (models/cache.py NEG_INF)
#define REPRO_NEG_INF (-0x1.666664p+127f)  // fp32(-0.7 * FLT_MAX)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's .to()
}
