// Helpers shared by the kernels: dtype codes, conversions, warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed from Python (kernels/_build.py wrappers)
enum DTypeCode { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

// -1e30 stands in for -inf, as in the TPU kernels: exp(NEG_INF - m) is an
// exact 0 and never a NaN from (-inf) - (-inf).
constexpr float NEG_INF = -1.0e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
