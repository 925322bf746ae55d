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
//
// Backward (rmsnorm_bwd_launch): the port's counterpart of autodiff of
// ops.rmsnorm (src/repro/kernels/ops.py:243), which the JAX package leaves
// to XLA; not a TPU kernel.  With r = rsqrt(mean(x^2) + eps) and g the
// incoming gradient,
//     dx     = r * (g * s - x * r^2 * mean(g * s * x))
//     dscale = sum over rows of g * x * r.
// Bound on the H100: memory again, x and g read and dx written once
// ((3 * rows * d) elements) plus the scale and its gradient.  The rows are
// split into one contiguous chunk per block (at most 264 blocks, two per
// SM); each block writes its fp32 partial of dscale as one row of a
// (blocks, d) buffer, and a second kernel sums the partials per column in
// a fixed order and casts, so dscale is reproducible run to run (no
// atomics).  Two routes, chosen by the wrapper (kernels/rmsnorm.py
// bwd_vector_route):
//   - vector (d a multiple of 8 bf16 or 4 f32, 16-byte aligned bases):
//     rmsnorm_bwd_rows_kernel.  A thread owns the same KV 16-byte vectors
//     of columns in every row, so it loads its part of the scale once and
//     keeps its dscale partial in registers.  A row of x and g is loaded
//     once into registers (16 bf16 of each a thread at d = 4096) while the
//     next row's loads are already in flight; sum(x^2) and sum(g s x) are
//     reduced together (shuffles, then one barrier: each warp's pair goes
//     to a shared slot of the row's parity, and every thread sums the
//     slots in warp order), and dx is written from registers.  The
//     partials are summed by rmsnorm_dscale_wide_kernel: a block per 32
//     columns, eight warps each summing every eighth partial row in
//     order, then the eight sums in warp order (128 blocks at d = 4096);
//   - scalar (odd widths, unaligned bases): the first design,
//     rmsnorm_bwd_kernel, walks its rows with one element a thread at a
//     time, reduces through shared memory with three barriers a row,
//     re-reads the row for dx and keeps its dscale partial in shared
//     memory; rmsnorm_dscale_kernel sums the partials with a thread per
//     column.
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

// ------------------------------------------------------------- backward

template <typename T>
__global__ void rmsnorm_bwd_kernel(const T* __restrict__ x,
                                   const T* __restrict__ scale,
                                   const T* __restrict__ g,
                                   T* __restrict__ dx,
                                   float* __restrict__ partial, int rows,
                                   int d, float eps, int rows_per_block) {
  extern __shared__ float ds[];             // d floats: this block's dscale
  __shared__ float red[2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int stride = blockDim.x;
  for (int i = threadIdx.x; i < d; i += stride) ds[i] = 0.f;

  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(rows, row0 + rows_per_block);
  for (int row = row0; row < row1; ++row) {
    const T* xr = x + static_cast<size_t>(row) * d;
    const T* gr = g + static_cast<size_t>(row) * d;
    T* dr = dx + static_cast<size_t>(row) * d;
    float ss = 0.f, sgx = 0.f;
    for (int i = threadIdx.x; i < d; i += stride) {
      const float xf = to_f32(xr[i]);
      ss += xf * xf;
      sgx += to_f32(gr[i]) * to_f32(scale[i]) * xf;
    }
    ss = warp_sum(ss);
    sgx = warp_sum(sgx);
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = sgx;
    }
    __syncthreads();
    if (warp == 0) {
      float a = lane < nwarps ? red[0][lane] : 0.f;
      float c = lane < nwarps ? red[1][lane] : 0.f;
      a = warp_sum(a);
      c = warp_sum(c);
      if (lane == 0) {
        red[0][0] = a;
        red[1][0] = c;
      }
    }
    __syncthreads();
    const float r = rsqrtf(red[0][0] / static_cast<float>(d) + eps);
    const float coef = r * r * (red[1][0] / static_cast<float>(d));
    __syncthreads();  // every thread has read red before the next row

    for (int i = threadIdx.x; i < d; i += stride) {
      const float xf = to_f32(xr[i]), gf = to_f32(gr[i]);
      dr[i] = from_f32<T>(r * (gf * to_f32(scale[i]) - xf * coef));
      ds[i] += gf * (xf * r);
    }
  }
  float* pr = partial + static_cast<size_t>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += stride) pr[i] = ds[i];
}

// dscale[c] = sum over blocks of partial[blk, c], in block order.
template <typename T>
__global__ void rmsnorm_dscale_kernel(const float* __restrict__ partial,
                                      T* __restrict__ dscale, int blocks,
                                      int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b)
    acc += partial[static_cast<size_t>(b) * d + c];
  dscale[c] = from_f32<T>(acc);
}

// The vector route: KV 16-byte vectors of columns a thread, NT threads.
template <typename T, int KV, int NT>
__global__ void __launch_bounds__(NT)
rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                        const T* __restrict__ g, T* __restrict__ dx,
                        float* __restrict__ partial, int rows, int d,
                        float eps, int rows_per_block) {
  constexpr int V = 16 / sizeof(T);
  constexpr int NW = NT / 32;
  __shared__ float red[2][2][NW];     // [row parity][sum][warp]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = d / V;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  uint4 sv[KV], xn[KV], gn[KV];
  float ds[KV][V];
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const int v = threadIdx.x + k * NT;
    sv[k] = v < nv ? reinterpret_cast<const uint4*>(scale)[v] : zero4;
#pragma unroll
    for (int j = 0; j < V; ++j) ds[k][j] = 0.f;
  }
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(rows, row0 + rows_per_block);
  auto load_row = [&](int row) {
    const uint4* xr = reinterpret_cast<const uint4*>(
        x + static_cast<size_t>(row) * d);
    const uint4* gr = reinterpret_cast<const uint4*>(
        g + static_cast<size_t>(row) * d);
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int v = threadIdx.x + k * NT;
      xn[k] = v < nv ? xr[v] : zero4;
      gn[k] = v < nv ? gr[v] : zero4;
    }
  };
  if (row0 < row1) load_row(row0);
  int par = 0;
  for (int row = row0; row < row1; ++row, par ^= 1) {
    uint4 xc[KV], gc[KV];
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      xc[k] = xn[k];
      gc[k] = gn[k];
    }
    if (row + 1 < row1) load_row(row + 1);   // in flight while this reduces
    float ss = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const T* xe = reinterpret_cast<const T*>(&xc[k]);
      const T* ge = reinterpret_cast<const T*>(&gc[k]);
      const T* se = reinterpret_cast<const T*>(&sv[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xf = to_f32(xe[j]);
        ss += xf * xf;
        sgx += to_f32(ge[j]) * to_f32(se[j]) * xf;
      }
    }
    ss = warp_sum(ss);
    sgx = warp_sum(sgx);
    if (lane == 0) {
      red[par][0][warp] = ss;
      red[par][1][warp] = sgx;
    }
    // one barrier a row: the slots of this parity are written again two
    // rows on, after every thread has passed the next row's barrier
    __syncthreads();
    float tss = 0.f, tsgx = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      tss += red[par][0][w];
      tsgx += red[par][1][w];
    }
    const float r = rsqrtf(tss / static_cast<float>(d) + eps);
    const float coef = r * r * (tsgx / static_cast<float>(d));
    uint4* dr = reinterpret_cast<uint4*>(dx + static_cast<size_t>(row) * d);
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int v = threadIdx.x + k * NT;
      const T* xe = reinterpret_cast<const T*>(&xc[k]);
      const T* ge = reinterpret_cast<const T*>(&gc[k]);
      const T* se = reinterpret_cast<const T*>(&sv[k]);
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xf = to_f32(xe[j]), gf = to_f32(ge[j]);
        oe[j] = from_f32<T>(r * (gf * to_f32(se[j]) - xf * coef));
        ds[k][j] += gf * (xf * r);
      }
      if (v < nv) dr[v] = out;
    }
  }
  float4* pr = reinterpret_cast<float4*>(partial +
                                         static_cast<size_t>(blockIdx.x) * d);
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const int v = threadIdx.x + k * NT;
    if (v < nv)
#pragma unroll
      for (int j = 0; j < V; j += 4)
        pr[(v * V + j) / 4] =
            make_float4(ds[k][j], ds[k][j + 1], ds[k][j + 2], ds[k][j + 3]);
  }
}

// dscale[c] = sum over blocks of partial[blk, c]: a block per 32 columns,
// warp w sums the partial rows w, w + 8, ... in order, then the eight sums
// in warp order
template <typename T>
__global__ void __launch_bounds__(256)
rmsnorm_dscale_wide_kernel(const float* __restrict__ partial,
                           T* __restrict__ dscale, int blocks, int d) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int b = warp; b < blocks; b += 8)
      acc += partial[static_cast<size_t>(b) * d + c];
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < d) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) sum += red[w][lane];
    dscale[c] = from_f32<T>(sum);
  }
}

template <typename T, int KV, int NT>
static cudaError_t launch_bwd_rows(const T* x, const T* s, const T* g, T* dx,
                                   float* partial, int rows, int d, float eps,
                                   int blocks, int rpb, cudaStream_t stream) {
  rmsnorm_bwd_rows_kernel<T, KV, NT><<<blocks, NT, 0, stream>>>(
      x, s, g, dx, partial, rows, d, eps, rpb);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_bwd(const void* x, const void* scale, const void* g,
                              void* dx, void* dscale, void* partial, int rows,
                              int d, float eps, int max_blocks, bool vector,
                              cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int rpb = (rows + max_blocks - 1) / max_blocks;
  const int blocks = (rows + rpb - 1) / rpb;
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  const T* gp = static_cast<const T*>(g);
  T* dp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(partial);
  cudaError_t err;
  if (vector) {
    if (d % V != 0 || (reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(scale) |
                       reinterpret_cast<uintptr_t>(g) |
                       reinterpret_cast<uintptr_t>(dx)) % 16 != 0)
      return cudaErrorInvalidValue;
    // 256 threads and up to 4 vectors a thread (8192 bf16, 4096 f32),
    // 512 threads past that
    const int nv = d / V;
    if (nv <= 256)
      err = launch_bwd_rows<T, 1, 256>(xp, sp, gp, dp, pp, rows, d, eps,
                                       blocks, rpb, stream);
    else if (nv <= 512)
      err = launch_bwd_rows<T, 2, 256>(xp, sp, gp, dp, pp, rows, d, eps,
                                       blocks, rpb, stream);
    else if (nv <= 1024)
      err = launch_bwd_rows<T, 4, 256>(xp, sp, gp, dp, pp, rows, d, eps,
                                       blocks, rpb, stream);
    else if constexpr (V == 4)    // f32 past 4096 (bf16 stops at 1024)
      err = launch_bwd_rows<T, 4, 512>(xp, sp, gp, dp, pp, rows, d, eps,
                                       blocks, rpb, stream);
    else
      return cudaErrorInvalidValue;
    if (err != cudaSuccess) return err;
    rmsnorm_dscale_wide_kernel<T><<<(d + 31) / 32, 256, 0, stream>>>(
        pp, static_cast<T*>(dscale), blocks, d);
    return cudaGetLastError();
  }
  int threads = ((d + 31) / 32) * 32;
  threads = threads > 256 ? 256 : threads;
  rmsnorm_bwd_kernel<T><<<blocks, threads, sizeof(float) * d, stream>>>(
      xp, sp, gp, dp, pp, rows, d, eps, rpb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rmsnorm_dscale_kernel<T><<<(d + 255) / 256, 256, 0, stream>>>(
      pp, static_cast<T*>(dscale), blocks, d);
  return cudaGetLastError();
}

// partial: max_blocks * d floats of scratch the caller allocates; vector
// selects the vector route (d a multiple of 16 bytes, aligned bases).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale,
                                  const void* g, void* dx, void* dscale,
                                  void* partial, int rows, int d, float eps,
                                  int max_blocks, int dtype, int vector,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 8192 || max_blocks < 1) return cudaErrorInvalidValue;
  if (rows == 0)
    return cudaMemsetAsync(dscale, 0,
                           static_cast<size_t>(d) *
                               (dtype == DTYPE_BF16 ? 2 : 4), s);
  if (dtype == DTYPE_BF16)
    return launch_bwd<__nv_bfloat16>(x, scale, g, dx, dscale, partial, rows,
                                     d, eps, max_blocks, vector != 0, s);
  if (dtype == DTYPE_F32)
    return launch_bwd<float>(x, scale, g, dx, dscale, partial, rows, d, eps,
                             max_blocks, vector != 0, s);
  return cudaErrorInvalidValue;
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
