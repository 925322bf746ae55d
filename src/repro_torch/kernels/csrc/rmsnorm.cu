// RMSNorm over the last dimension: y = (x * rsqrt(mean(x^2) + eps)) * scale.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (driver rmsnorm_pallas), which keeps blocks of 256 rows whole in VMEM.
//
// Bound on the H100: memory.  A row is read, reduced and written with a
// few flops per element (about 0.6 flop/byte in bf16, far below the ~295
// the tensor cores need), so the least time is (2 * rows * d + d) * bytes
// over 3.35 TB/s.
//
// Design: one thread block per row.  Each thread reads 16-byte vectors
// (8 bf16 or 4 f32) where the row width and the pointers allow it, so a
// warp reads 512 contiguous bytes per instruction.  The fp32 sum of squares
// is reduced with warp shuffles and then across warps through 32 floats of
// shared memory.  The second pass re-reads the row (an L1/L2 hit at d up
// to 8192, i.e. at most 32 KB a row) instead of holding it in registers,
// which keeps register use flat for every d.  Arithmetic is fp32 in the
// reference's order, (x * rsqrt(var + eps)) * scale, then one cast.
#include <cstdint>

#include "common.cuh"

template <typename T, bool VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const T* __restrict__ scale,
                               T* __restrict__ y, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* yr = y + static_cast<size_t>(blockIdx.x) * d;

  float ss = 0.f;
  if (VEC) {
    for (int i = threadIdx.x * V; i < d; i += blockDim.x * V) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      float f = to_f32(xr[i]);
      ss += f * f;
    }
  }

  __shared__ float partial[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < static_cast<int>(blockDim.x >> 5) ? partial[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) partial[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(partial[0] / static_cast<float>(d) + eps);

  if (VEC) {
    for (int i = threadIdx.x * V; i < d; i += blockDim.x * V) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      uint4 sraw = *reinterpret_cast<const uint4*>(scale + i);
      uint4 out;
      const T* e = reinterpret_cast<const T*>(&raw);
      const T* s = reinterpret_cast<const T*>(&sraw);
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = from_f32<T>((to_f32(e[j]) * inv) * to_f32(s[j]));
      *reinterpret_cast<uint4*>(yr + i) = out;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      yr[i] = from_f32<T>((to_f32(xr[i]) * inv) * to_f32(scale[i]));
  }
}

template <typename T>
static cudaError_t launch(const void* x, const void* scale, void* y, int rows,
                          int d, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (d % V == 0) &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(scale) |
                     reinterpret_cast<uintptr_t>(y)) % 16 == 0);
  const int per_thread = vec ? V : 1;
  int threads = (d + per_thread - 1) / per_thread;
  threads = ((threads + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* yp = static_cast<T*>(y);
  if (vec)
    rmsnorm_kernel<T, true><<<rows, threads, 0, stream>>>(xp, sp, yp, d, eps);
  else
    rmsnorm_kernel<T, false><<<rows, threads, 0, stream>>>(xp, sp, yp, d, eps);
  return cudaGetLastError();
}

extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y,
                              int rows, int d, float eps, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return cudaSuccess;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, scale, y, rows, d, eps, s);
  if (dtype == DTYPE_F32) return launch<float>(x, scale, y, rows, d, eps, s);
  return cudaErrorInvalidValue;
}
