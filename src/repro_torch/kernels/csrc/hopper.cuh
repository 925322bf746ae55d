// Hopper (sm_90a) building blocks for the bf16 flash kernels
// (flash_attention.cu, flash_attention_bwd.cu): tensor maps for TMA loads,
// mbarriers, wgmma descriptors and instructions, and the accumulator
// fragment's layout.
//
// Shared-memory tiles.  A tile of R rows and up to 128 bf16 columns is kept
// as one or two 64-column "halves", each R rows of 128 bytes in the 128-byte
// swizzle that TMA writes (CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c
// of row r lands at chunk c ^ (r % 8)).  Each half starts on a 1024-byte
// boundary.  Columns past the tensor's width and rows past its length are
// zero-filled by TMA, never read from the next head.
//
// Accumulator fragment of a wgmma m64nN with fp32 accumulators, for thread
// t of the warpgroup (warp w = t / 32, lane l): register 4 j + 2 i + c
// holds row 16 w + l / 4 + 8 i, column 8 j + 2 (l % 4) + c.  Four lanes (a
// quad) share a row.  The A operand of m64nNk16 from registers takes the
// same rows: for k-slice kk the four 32-bit registers pack columns
// 16 kk + 2 (l % 4) + {0, 1} of rows r and r + 8, then columns 16 kk + 8 +
// 2 (l % 4) + {0, 1} of rows r and r + 8, so an accumulator converts to an
// A fragment in place.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace hopper {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ------------------------------------------------------------ host side

// cuTensorMapEncodeTiled from libcuda, found through the runtime, so that
// the library links against nothing but cudart.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 3-D map over a contiguous bf16 tensor (depth, rows, cols), read in
// boxes of 64 columns x box_rows rows x 1, 128-byte swizzled.  Needs cols %
// 8 == 0 (16-byte row stride) and a 16-byte aligned base.
inline bool make_map(CUtensorMap* map, const void* base, int cols, int rows,
                     int depth, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(depth)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                           static_cast<cuuint64_t>(cols) * rows * 2};
  cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether the wgmma route takes these bf16 operands: rows of a multiple of
// 16 bytes, 16-byte aligned bases.
inline bool tma_ok(int cols, const void* p) {
  return cols % 8 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box (64 columns x box_rows rows) at (col, row, depth) into dst;
// completion is counted in bytes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int depth) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(depth)
      : "memory");
}

// A tile of `halves` 64-column halves of `rows` rows each: the TMA boxes
// that fill it, all counted on one barrier (the caller adds the bytes).
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int halves, int rows,
                                         int row, int depth) {
  for (int h = 0; h < halves; ++h)
    tma_load(dst + h * rows * 128, map, bar, 64 * h, row, depth);
}

// wgmma shared-memory descriptor, 128-byte swizzle.  lbo and sbo in bytes:
// for a K-major operand sbo is the stride between 8-row groups (1024) and
// lbo is unused; for an MN-major operand lbo is the stride between
// 64-column halves and sbo the stride between 8-row groups of K.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// K-major operand: k-slice kk (16 columns) of a tile whose halves are
// half_bytes apart; `row0` selects a 64-row part of a taller tile.
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int half_bytes,
                                           int row0, int kk) {
  return desc(smem_addr(tile + (kk >> 2) * half_bytes + row0 * 128 +
                        (kk & 3) * 32),
              16, 1024);
}

// MN-major operand (the transposed B of P V, dS K, P^T dO, dS^T Q):
// k-slice kk covers rows 16 kk .. 16 kk + 15 of the tile.
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile,
                                            int half_bytes, int kk) {
  return desc(smem_addr(tile + kk * 16 * 128), half_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving an accumulator across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// k-slice kk of an m64n64 accumulator (columns 16 kk .. 16 kk + 15) as the
// A operand of the next product, split into two bf16 parts: hi = bf16(x)
// and lo = bf16(x - hi), so that hi + lo keeps 16 significant bits of x.
// Two products, one with hi and one with lo, into the same accumulator.
__device__ __forceinline__ void to_a_frags(const float (&s)[32], int kk,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float x0 = s[8 * kk + 2 * r], x1 = s[8 * kk + 2 * r + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
    lo[r] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
  }
}

// sum and max over the four lanes of a quad (one row of a fragment)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B from shared memory
// through their descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A from registers (the
// accumulator fragment's layout, bf16 pairs), B from shared memory MN-major
// (transposed: N contiguous).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]; A from registers (the
// accumulator fragment's layout, bf16 pairs), B from shared memory MN-major
// (transposed: N contiguous).
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 128, "N is 64 or 128");
  if constexpr (N == 64)
    wgmma_rs_n64_tb(d, a, db, accumulate);
  else
    wgmma_rs_n128_tb(d, a, db, accumulate);
}

}  // namespace hopper
