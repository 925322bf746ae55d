// RMSNorm over the last dimension: y = (x * rsqrt(mean(x^2) + eps)) * scale.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (driver rmsnorm_pallas), which keeps blocks of 256 rows whole in VMEM.
//
// Bound on the H100: memory.  A row is read, reduced and written with a
// few flops per element (about 0.6 flop/byte in bf16, far below the ~295
// the tensor cores need), so the least time is (2 * rows * d + d) * bytes
// over 3.35 TB/s.  Reaching it takes enough bytes in flight on every SM
// (~3.35 MB across the card at ~1 us of memory latency) and no second
// read of a row; a call of a few rows (decode) is bound by its latency
// instead: one round trip to memory and back is the least it can take.
//
// Design: the arithmetic is fp32 in the reference's order, (x * rsqrt(var
// + eps)) * scale, then one cast; only the order in which the squares are
// summed differs between the routes.  Two routes, chosen by the wrapper
// (kernels/rmsnorm.py fwd_route) from dtype, width, alignment and stride:
//   - vector (rows of whole 16-byte words, d <= 8192, 16-byte aligned x,
//     scale and y, a row stride of whole 16-byte words):
//     each row is read once from memory and held in registers, KV 16-byte
//     vectors a thread (a template parameter), for the normalising pass;
//     a thread owns the same columns in every row, so it loads its part
//     of the scale once; the grid is one wave of the blocks that fit on
//     the SMs, and each of its W workers takes every W-th row (the rows
//     in flight at once side by side in memory), the next one's loads
//     issued before the current one is reduced.
//       * narrow rows (at most 256 vectors: d <= 2048 bf16, 1024 f32):
//         rmsnorm_fwd_warp_kernel, a warp per row, four rows a block, the
//         sum by shuffles alone (no barrier);
//       * wide rows: rmsnorm_fwd_block_kernel, a block per row, sized so
//         that each thread's one to four loads go out in one burst (512
//         threads of one vector at d = 4096 bf16); one barrier a row:
//         each warp writes its partial to a shared slot of the row's
//         parity, and every warp sums the slots by shuffles in the same
//         order.
//     A few rows (decode) take the path of their width: one round trip to
//     memory and at most one barrier a call.
//   - scalar (the first design, for widths of no whole 16-byte words,
//     unaligned bases, and row strides the vector route refuses):
//     rmsnorm_kernel, one block of at most 256 threads a row, 16-byte
//     vectors where width, pointers and stride allow and one element a
//     thread otherwise; the sum of squares through shuffles and 32 floats
//     of shared memory (two barriers), then a second pass that re-reads
//     the row (an L1/L2 hit) and the scale.
// Both routes read x's rows at a stride (its last dimension contiguous),
// so a slice of wider rows (MLA's kv_a[..., :R]) needs no copy; y is
// written contiguous.
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
#include <mutex>

#include "common.cuh"

// ------------------------------------------------------ scalar route

template <typename T, bool VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const T* __restrict__ scale,
                               T* __restrict__ y, int d, long long stride,
                               float eps) {
  constexpr int V = 16 / sizeof(T);
  const T* xr = x + static_cast<long long>(blockIdx.x) * stride;
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
static cudaError_t launch_scalar(const void* x, const void* scale, void* y,
                                 int rows, int d, long long stride,
                                 float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (d % V == 0) && (stride % V == 0) &&
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
    rmsnorm_kernel<T, true><<<rows, threads, 0, stream>>>(xp, sp, yp, d,
                                                          stride, eps);
  else
    rmsnorm_kernel<T, false><<<rows, threads, 0, stream>>>(xp, sp, yp, d,
                                                           stride, eps);
  return cudaGetLastError();
}

// ------------------------------------------------------ vector route

// dst[k] = vector t + k * nt of src, zero past the row's nv vectors
template <int KV>
__device__ __forceinline__ void load_vectors(uint4 (&dst)[KV],
                                             const uint4* __restrict__ src,
                                             int t, int nt, int nv) {
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const int v = t + k * nt;
    dst[k] = v < nv ? __ldg(src + v) : make_uint4(0, 0, 0, 0);
  }
}

// A thread's sum of squares: each vector's in order, then the vectors' in
// order (KV short chains of dependent adds instead of one long one).
template <typename T, int KV>
__device__ __forceinline__ float sum_squares(const uint4 (&xv)[KV]) {
  constexpr int V = 16 / sizeof(T);
  float part[KV];
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const T* e = reinterpret_cast<const T*>(&xv[k]);
    part[k] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f32(e[j]);
      part[k] += f * f;
    }
  }
  float ss = part[0];
#pragma unroll
  for (int k = 1; k < KV; ++k) ss += part[k];
  return ss;
}

// Hides xv's bits from the compiler once a row's squares are summed, so
// that the store converts them again instead of keeping a float of every
// element alive across the reduction (registers, and spills at 8 vectors
// a lane).
template <int KV>
__device__ __forceinline__ void opaque(uint4 (&xv)[KV]) {
#pragma unroll
  for (int k = 0; k < KV; ++k)
    asm volatile("" : "+r"(xv[k].x), "+r"(xv[k].y), "+r"(xv[k].z),
                 "+r"(xv[k].w));
}

// y's vectors t + k * nt of the row: (x * inv) * scale, one cast
template <typename T, int KV>
__device__ __forceinline__ void store_normalised(uint4* __restrict__ dst,
                                                 const uint4 (&xv)[KV],
                                                 const uint4 (&sv)[KV],
                                                 float inv, int t, int nt,
                                                 int nv) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const int v = t + k * nt;
    if (v < nv) {
      const T* e = reinterpret_cast<const T*>(&xv[k]);
      const T* s = reinterpret_cast<const T*>(&sv[k]);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = from_f32<T>((to_f32(e[j]) * inv) * to_f32(s[j]));
      dst[v] = out;
    }
  }
}

template <typename T>
__device__ __forceinline__ const uint4* row_of(const T* x, int row,
                                               long long stride) {
  return reinterpret_cast<const uint4*>(x + static_cast<long long>(row) *
                                                stride);
}

// A warp per row: warp w of the W in the grid takes rows w, w + W, ...
// (the rows in flight at once lie side by side in memory).
template <typename T, int KV>
__global__ void __launch_bounds__(128)
rmsnorm_fwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                        T* __restrict__ y, int rows, int d, long long stride,
                        float eps) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int W = gridDim.x * (blockDim.x >> 5);
  const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (w >= rows) return;
  const int nv = d / V;
  uint4 sv[KV], xn[KV];
  load_vectors<KV>(sv, reinterpret_cast<const uint4*>(scale), lane, 32, nv);
  load_vectors<KV>(xn, row_of(x, w, stride), lane, 32, nv);
  for (int row = w; row < rows; row += W) {
    uint4 xc[KV];
#pragma unroll
    for (int k = 0; k < KV; ++k) xc[k] = xn[k];
    if (row + W < rows)   // in flight while this row reduces
      load_vectors<KV>(xn, row_of(x, row + W, stride), lane, 32, nv);
    // the butterfly leaves the same bits in every lane
    const float ss = warp_sum(sum_squares<T, KV>(xc));
    opaque<KV>(xc);
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    store_normalised<T, KV>(
        reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * d), xc, sv,
        inv, lane, 32, nv);
  }
}

// A block per row: block b of the B in the grid takes rows b, b + B, ...
template <typename T, int KV>
__global__ void __launch_bounds__(512)
rmsnorm_fwd_block_kernel(const T* __restrict__ x,
                         const T* __restrict__ scale, T* __restrict__ y,
                         int rows, int d, long long stride, float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[2][32];        // [row parity][warp]
  const int t = threadIdx.x, nt = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nw = nt >> 5;
  const int B = gridDim.x;
  const int nv = d / V;
  uint4 sv[KV], xn[KV];
  load_vectors<KV>(sv, reinterpret_cast<const uint4*>(scale), t, nt, nv);
  load_vectors<KV>(xn, row_of(x, blockIdx.x, stride), t, nt, nv);
  int par = 0;
  for (int row = blockIdx.x; row < rows; row += B, par ^= 1) {
    uint4 xc[KV];
#pragma unroll
    for (int k = 0; k < KV; ++k) xc[k] = xn[k];
    if (row + B < rows)   // in flight while this row reduces
      load_vectors<KV>(xn, row_of(x, row + B, stride), t, nt, nv);
    const float ss = warp_sum(sum_squares<T, KV>(xc));
    opaque<KV>(xc);
    if (lane == 0) red[par][warp] = ss;
    // one barrier a row: the slots of this parity are written again two
    // rows on, after every thread has passed the next row's barrier
    __syncthreads();
    const float tot = warp_sum(lane < nw ? red[par][lane] : 0.f);
    const float inv = rsqrtf(tot / static_cast<float>(d) + eps);
    store_normalised<T, KV>(
        reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * d), xc, sv,
        inv, t, nt, nv);
  }
}

// The blocks of `threads` threads of `kernel` that one SM holds at once,
// and the SMs, by device: asked of the runtime once (an eager call, before
// any capture of the launch into a graph) and kept.
static void occupancy(const void* kernel, int threads, int* per_sm,
                      int* sms) {
  struct Entry { const void* kernel; int threads, dev, per_sm, sms; };
  static Entry seen[64];
  static int n = 0;
  static std::mutex mu;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i)
    if (seen[i].kernel == kernel && seen[i].threads == threads &&
        seen[i].dev == dev) {
      *per_sm = seen[i].per_sm;
      *sms = seen[i].sms;
      return;
    }
  *per_sm = *sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, 0);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (*per_sm < 1) *per_sm = 1;   // a refusal shows at the launch
  if (*sms < 1) *sms = 1;
  if (n < 64) seen[n++] = {kernel, threads, dev, *per_sm, *sms};
}

// The grid is one wave: the blocks of `workers_per_block` workers (warps
// or blocks) that fit on the SMs at once, or enough for a row a worker.
static int one_wave(const void* kernel, int threads, int workers_per_block,
                    int rows) {
  int per_sm, sms;
  occupancy(kernel, threads, &per_sm, &sms);
  const long long fit = static_cast<long long>(per_sm) * sms;
  const long long need = (rows + workers_per_block - 1) / workers_per_block;
  return static_cast<int>(need < fit ? need : fit);
}

template <typename T, int KV>
static cudaError_t launch_warp(const T* x, const T* s, T* y, int rows, int d,
                               long long stride, float eps,
                               cudaStream_t stream) {
  constexpr int WPB = 4;
  const int blocks = one_wave(
      reinterpret_cast<const void*>(rmsnorm_fwd_warp_kernel<T, KV>),
      32 * WPB, WPB, rows);
  // a call of fewer rows than WPB launches one block of as many warps
  const int warps = rows < WPB ? rows : WPB;
  rmsnorm_fwd_warp_kernel<T, KV><<<blocks, 32 * warps, 0, stream>>>(
      x, s, y, rows, d, stride, eps);
  return cudaGetLastError();
}

template <typename T, int KV>
static cudaError_t launch_block(const T* x, const T* s, T* y, int rows,
                                int d, long long stride, float eps,
                                cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int nv = d / V;
  const int threads = ((nv + KV - 1) / KV + 31) / 32 * 32;
  const int blocks = one_wave(
      reinterpret_cast<const void*>(rmsnorm_fwd_block_kernel<T, KV>),
      threads, 1, rows);
  rmsnorm_fwd_block_kernel<T, KV><<<blocks, threads, 0, stream>>>(
      x, s, y, rows, d, stride, eps);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_vector(const void* x, const void* scale, void* y,
                                 int rows, int d, long long stride,
                                 float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (d % V != 0 || d > 8192 || stride % V != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
       reinterpret_cast<uintptr_t>(y)) % 16 != 0)
    return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* yp = static_cast<T*>(y);
  const int nv = d / V;
  if (nv <= 32)
    return launch_warp<T, 1>(xp, sp, yp, rows, d, stride, eps, stream);
  if (nv <= 64)
    return launch_warp<T, 2>(xp, sp, yp, rows, d, stride, eps, stream);
  if (nv <= 128)
    return launch_warp<T, 4>(xp, sp, yp, rows, d, stride, eps, stream);
  if (nv <= 192)
    return launch_warp<T, 6>(xp, sp, yp, rows, d, stride, eps, stream);
  if (nv <= 256)
    return launch_warp<T, 8>(xp, sp, yp, rows, d, stride, eps, stream);
  if (nv <= 512)
    return launch_block<T, 1>(xp, sp, yp, rows, d, stride, eps, stream);
  if (nv <= 1024)
    return launch_block<T, 2>(xp, sp, yp, rows, d, stride, eps, stream);
  if constexpr (V == 4)   // f32 past 4096 (bf16 stops at 1024 vectors)
    return launch_block<T, 4>(xp, sp, yp, rows, d, stride, eps, stream);
  return cudaErrorInvalidValue;
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

// x's rows at a stride of x_row_stride elements, y contiguous; vector
// selects the vector route, which refuses (cudaErrorInvalidValue) what it
// does not take.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y,
                              int rows, int d, long long x_row_stride,
                              float eps, int dtype, int vector,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 8192 || x_row_stride < 0 || rows < 0)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  if (dtype == DTYPE_BF16)
    return vector ? launch_vector<__nv_bfloat16>(x, scale, y, rows, d,
                                                 x_row_stride, eps, s)
                  : launch_scalar<__nv_bfloat16>(x, scale, y, rows, d,
                                                 x_row_stride, eps, s);
  if (dtype == DTYPE_F32)
    return vector ? launch_vector<float>(x, scale, y, rows, d, x_row_stride,
                                         eps, s)
                  : launch_scalar<float>(x, scale, y, rows, d, x_row_stride,
                                         eps, s);
  return cudaErrorInvalidValue;
}
