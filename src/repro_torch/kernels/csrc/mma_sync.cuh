// The tensor-core helpers of the SSD scan's kernels (csrc/ssd_scan.cu's
// chunked route, csrc/ssd_scan_bwd.cu's tensor-core route): cp.async tile
// loads into shared memory, ldmatrix fragment loads, mma.sync m16n8k16 with
// bf16 operands and fp32 accumulators, and fp32 values split into bf16
// parts.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace mma_sync {

using bf16 = __nv_bfloat16;
using ll = long long;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !ok (src unread)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, or 4 zero bytes where !ok
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's groups are in flight
template <int pending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  cp_commit();
  cp_wait<0>();
}

// Rows [0, rows) of `width` bf16 (a multiple of 8) into dst (row pitch
// ld); row r < valid comes from row0 + r * stride, the rest are zeros.
// `base` is any valid address of the tensor, given for the zero rows.
template <int NT>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* base,
                                          const bf16* row0, ll stride,
                                          int rows, int valid, int width) {
  const int per_row = width / 8;
  for (int e = threadIdx.x; e < rows * per_row; e += NT) {
    const int r = e / per_row, q = e - r * per_row;
    const bool ok = r < valid;
    cp16(dst + r * ld + q * 8, ok ? row0 + r * stride + q * 8 : base, ok);
  }
}

// load_rows without a division: thread i copies the 16-byte column i % 8
// of rows i / 8, i / 8 + NT / 8, ... (width at most 64 bf16)
template <int NT>
__device__ __forceinline__ void load_rows8(bf16* dst, int ld, const bf16* base,
                                           const bf16* row0, ll stride,
                                           int rows, int valid, int width) {
  const int q = threadIdx.x & 7;
  if (q * 8 >= width) return;
  for (int r = threadIdx.x >> 3; r < rows; r += NT / 8) {
    const bool ok = r < valid;
    cp16(dst + r * ld + q * 8, ok ? row0 + r * stride + q * 8 : base, ok);
  }
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8.  Plain: register i holds row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1 of matrix i; .trans: rows 2 (l % 4) and 2 (l % 4) + 1 of
// column l / 4.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b: m16n8k16, A row-major (4 registers), B column-major (2), fp32
// accumulators.  Fragments, for lane l, g = l / 4, q = l % 4: a0 = A[g][2q,
// 2q+1], a1 = A[g+8][2q, 2q+1], a2 = A[g][2q+8, 2q+9], a3 = A[g+8][2q+8,
// 2q+9]; b0 = B[2q, 2q+1][g], b1 = B[2q+8, 2q+9][g]; d0, d1 = D[g][2q,
// 2q+1], d2, d3 = D[g+8][2q, 2q+1] (the lower column in the low half).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as bf16 pairs hi = bf16(v) and lo = bf16(v - hi): v - hi is
// exact in fp32, so hi + lo is v to ~2^-17 relative
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// (v0, v1) as three bf16 pairs, hi + mid + lo = v to ~2^-26 relative
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  split(v0 - hf.x, v1 - hf.y, mid, lo);
}

// (v0, v1) as n bf16 pairs p[0..n), each the rounding of what the pairs
// before it leave (n = 2 gives split's hi and lo, n = 3 split3's parts)
template <int n>
__device__ __forceinline__ void split_n(float v0, float v1, uint32_t (&p)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    const float2 hf = __bfloat1622float2(h);
    p[i] = bits(h);
    v0 -= hf.x;
    v1 -= hf.y;
  }
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

}  // namespace mma_sync
