// GQA flash attention forward with an online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_fa_kernel
// (driver flash_attention_pallas), whose (B*Hq, nq, nk) grid carries the
// running max m, the running sum l and the fp32 accumulator across its
// sequential kv dimension in VMEM scratch.
//
// Bound on the H100: at the prefill shapes (Sq = Sk = 512, D = 128) the
// work is 4*Sq*Sk*D/2 causal flops per head against 2*(Sq+Sk)*D bytes, ~128
// flop/byte in bf16, under the ~295 where the tensor cores become the
// limit: memory bounds the least time.  Only the tensor cores come near
// it: fp32 on the CUDA cores reaches ~13 TFLOP/s here.
//
// Design: two routes, chosen by the entry point from the dtype code.
//
// bf16 (flash_fwd_wgmma): both products on the tensor cores through
// wgmma (bf16 operands, fp32 accumulators; hopper.cuh).  One block of two
// warpgroups per (q tile of 128 rows, q head, batch); each warpgroup owns
// 64 query rows.  TMA loads Q once per block and streams 64-row K and V
// tiles through a two-stage ring in shared memory, each stage counted on
// its own mbarrier: while the warpgroups work on tile j, tile j + 1 is in
// flight, and tile j + 2 is asked for as soon as both warpgroups are done
// with tile j (one __syncthreads a tile).  The tensor maps are 3-D over
// (D, S, B*H), so rows past Sq or Sk and columns past D read as zeros;
// tiles are 64-column halves of 128-byte swizzled rows, so D = 80 (the
// hybrid's shared block) or 72 takes two halves, the second zero-padded,
// and Q K^T runs over all 128 columns; MLA's prefill (q and k of 128 + 64
// = 192 columns, v of 128) takes three halves of Q and K, and D = 136 a
// third half mostly zeros; Dv pads to 64 or 128 columns in the P V
// product and the padded columns are not stored.  At three halves the
// block holds 1 KB of alignment, 48 KB of Q and two 40 KB stages of K and
// V: 132 KB of the 227 KB a block may have.  Every batch of
// wgmma is issued without a branch, its accumulators pinned before and
// after (hopper.cuh fence_regs): issuing only ceil(D / 16) k-slices
// behind a condition made ptxas serialize the products (C7515), and the
// branch-free form ran 8-16% faster even at D = 80 on the card.
// S = Q K^T is an m64n64 product from shared memory (both K-major); the
// online softmax runs on its fp32 accumulator fragment in registers (a
// row's max and sum over the four lanes of a quad, exp2 with scale * log2 e
// folded in); P goes from registers as the A operand of O += P V, with V
// read MN-major (the transpose bit) from the ring.  P is split into two
// bf16 parts, hi = bf16(p) and lo = bf16(p - hi), and O takes both
// products: one bf16 P put up to 2x the checks' bf16 tolerance into the
// outputs of rows that see a few keys with large weights (the kernel
// matched a bf16-P emulation in PyTorch to its worst element on the card),
// and hi + lo keeps 16 bits.  The P V product costs twice its flops.  Masks
// are exact (k_pos < Sk; q_pos >= k_pos when causal with q_pos = q_offset
// + row; q_pos - k_pos < window when window > 0) and applied only on tiles
// that cross a boundary; kv tiles wholly masked for the block are never
// loaded, and a warpgroup skips the products of a tile wholly masked for
// its own 64 rows.  The q tiles run longest first (the last causal tile
// has the most kv tiles; blockIdx.z counts down) so that the tail is
// short.  Needs D and Dv multiples of 8 and 16-byte aligned bases (TMA
// row strides); other bf16 shapes take the CUDA-core kernel below.
//
// f32 (flash_fwd_kernel, the first CUDA-core kernel, also the bf16
// route for head dims that are not multiples of 8): one block (256
// threads) per (q tile of 64 rows, q head, batch); each kv step stages a
// 64-row K and V tile in shared memory as fp32, each thread a 4x4 patch of
// the score tile and a 4x8 patch of the output, fmaf on the CUDA cores.
// TF32 would not hold the f32 checks' 1e-4.
//
// Its rows are staged D + 1 floats wide (no bank conflicts): at D = 192
// the block takes 148 KB of dynamic shared memory, one block an SM.
//
// Both: a row left fully masked ends with l = 0 and is divided by 1 (its
// output is 0), as the TPU kernel does.  D up to 192 (MAX_D), Dv up to
// 128.
//
// Training: when the lse pointer is not null, the kernel also writes each
// row's log-sum-exp, lse = m + log(l_safe) in fp32 with l_safe = l or 1
// where l = 0 (as _flash_fwd_impl in src/repro/kernels/ops.py), shape
// (B, Hq, Sq); the backward (flash_attention_bwd.cu) recomputes the
// probabilities from it.  A fully masked row's lse is -1e30.  Serving
// passes null and writes nothing more.
#include "common.cuh"
#include "hopper.cuh"

// ------------------------------------------------- CUDA cores (f32)

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // kv rows per tile
constexpr int THREADS = 256;
constexpr int MAX_DV = 128;  // 16 lanes x 8 columns
constexpr int NJ = MAX_DV / 16;
constexpr int MAX_D = 192;   // three 64-column halves on the wgmma route

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Hq, int Hkv,
                 int Sq, int Sk, int D, int Dv, float scale, int causal,
                 int window, int q_offset) {
  extern __shared__ float smem[];
  const int DP = D + 1;                     // padded row: no bank conflicts
  float* sQ = smem;                         // BQ x DP
  float* sK = sQ + BQ * DP;                 // BK x DP
  float* sV = sK + BK * DP;                 // BK x Dv
  float* sP = sV + BK * Dv;                 // BQ x (BK + 1)

  const int tid = threadIdx.x;
  const int ty = tid >> 4;                  // rows ty*4 .. ty*4+3
  const int tx = tid & 15;                  // cols tx + 16*j
  const int q_start = blockIdx.x * BQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);

  const T* qb = q + (static_cast<size_t>(b) * Hq + hq) * Sq * D;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * Dv;
  T* ob = o + (static_cast<size_t>(b) * Hq + hq) * Sq * Dv;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx - r * D;
    const int row = q_start + r;
    sQ[r * DP + c] = row < Sq ? to_f32(qb[static_cast<size_t>(row) * D + c])
                              : 0.f;
  }

  // kv range this q tile can see; tiles outside it are fully masked
  const int q_first = q_offset + q_start;
  const int q_last = q_offset + min(q_start + BQ, Sq) - 1;
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q_last + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q_first - window + 1);
  k_lo = (k_lo / BK) * BK;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int kt = k_lo; kt < k_hi; kt += BK) {
    __syncthreads();  // previous tile's sK/sV/sP reads are done (and sQ set)
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx - r * D;
      const int row = kt + r;
      sK[r * DP + c] = row < Sk ? to_f32(kb[static_cast<size_t>(row) * D + c])
                                : 0.f;
    }
    for (int idx = tid; idx < BK * Dv; idx += THREADS) {
      const int r = idx / Dv, c = idx - r * Dv;
      const int row = kt + r;
      sV[idx] = row < Sk ? to_f32(vb[static_cast<size_t>(row) * Dv + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    const float* qrow = sQ + (ty * 4) * DP;
    const float* krow = sK + tx * DP;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qrow[i * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = krow[(16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_first + ty * 4 + i;
      bool valid[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = kt + tx + 16 * j;
        bool ok = k_pos < Sk;
        if (causal) ok = ok && (q_pos >= k_pos);
        if (window > 0) ok = ok && (q_pos - k_pos < window);
        valid[j] = ok;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        sP[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

    const float* prow = sP + (ty * 4) * (BK + 1);
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = prow[i * (BK + 1) + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int c = tx + 16 * jj;
        vv[jj] = c < Dv ? sV[kk * Dv + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_start + ty * 4 + i;
    if (row >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
    if (lse != nullptr && tx == 0)
      lse[(static_cast<size_t>(b) * Hq + hq) * Sq + row] = m[i] + logf(l_safe);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < Dv)
        ob[static_cast<size_t>(row) * Dv + c] = from_f32<T>(acc[i][jj] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                   int Dv, float scale, int causal, int window, int q_offset,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(BQ) * (D + 1) +
                       static_cast<size_t>(BK) * (D + 1) +
                       static_cast<size_t>(BK) * Dv + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq, Hkv, Sq, Sk, D,
      Dv, scale, causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace


// ----------------------------------------------------- bf16, tensor cores

namespace wg {

using namespace hopper;

constexpr int BQ = 128;      // query rows per block (two warpgroups)
constexpr int BK = 64;       // kv rows per ring stage
constexpr int STAGES = 2;
constexpr int THREADS = 256;

// k_lo is a multiple of BK; tiles kt = k_lo + i * BK, i < n
struct Range {
  int k_lo, n;
};

__device__ __forceinline__ Range kv_range(int q_start, int Sq, int Sk,
                                          int causal, int window,
                                          int q_offset) {
  const int q_first = q_offset + q_start;
  const int q_last = q_offset + min(q_start + BQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  int k_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  k_lo = (k_lo / BK) * BK;
  return {k_lo, k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0};
}

template <int DH, int DVH>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int Hq, int Hkv, int Sq, int Sk, int Dv, float scale_log2,
                int causal, int window, int q_offset) {
  constexpr int DVP = 64 * DVH;
  constexpr int K_BYTES = DH * BK * 128, V_BYTES = DVH * BK * 128;
  constexpr int STAGE = K_BYTES + V_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sKV = sQ + DH * BQ * 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sKV + STAGES * STAGE);

  const int tid = threadIdx.x, wgi = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int hq = blockIdx.x, b = blockIdx.y;
  const int q_start = (gridDim.z - 1 - blockIdx.z) * BQ;   // longest first
  const int hk = hq / (Hq / Hkv);
  const int q_depth = b * Hq + hq, kv_depth = b * Hkv + hk;
  const Range r = kv_range(q_start, Sq, Sk, causal, window, q_offset);

  auto load_kv = [&](int stage, int kt) {
    uint8_t* dst = sKV + stage * STAGE;
    mbar_expect_tx(&bar[1 + stage], STAGE);
    tma_tile(dst, &tk, &bar[1 + stage], DH, BK, kt, kv_depth);
    tma_tile(dst + K_BYTES, &tv, &bar[1 + stage], DVH, BK, kt, kv_depth);
  };
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[0], DH * BQ * 128);
    tma_tile(sQ, &tq, &bar[0], DH, BQ, q_start, q_depth);
    for (int i = 0; i < min(STAGES, r.n); ++i) load_kv(i, r.k_lo + i * BK);
  }

  // this warpgroup's rows: row0 + r_in + 8 i, r_in = 16 warp + lane / 4
  const int row0 = q_start + wgi * 64;
  const int r_in = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int wq_first = q_offset + row0;                     // q positions
  const int wq_last = q_offset + min(row0 + 64, Sq) - 1;
  const bool live = row0 < Sq;

  float acc[DVP / 2];
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  mbar_wait(&bar[0], 0);
  for (int it = 0; it < r.n; ++it) {
    const int st = it % STAGES, kt = r.k_lo + it * BK;
    mbar_wait(&bar[1 + st], (it / STAGES) & 1);
    const bool visible = live && !(causal && kt > wq_last) &&
                         !(window > 0 && wq_first - (kt + BK - 1) >= window);
    if (visible) {
      const uint8_t* sK = sKV + st * STAGE;
      const uint8_t* sV = sK + K_BYTES;
      float s[32];       // the first k-slice overwrites (scale-d = 0)
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * DH; ++kk)
        wgmma_ss_n64(s, desc_k(sQ, BQ * 128, wgi * 64, kk),
                     desc_k(sK, BK * 128, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      const bool edge = kt + BK > Sk || (causal && kt + BK - 1 > wq_first) ||
                        (window > 0 && wq_last - kt >= window);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q_pos = wq_first + r_in + 8 * i;
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = s[4 * j + 2 * i + c] * scale_log2;
            if (edge) {
              const int k_pos = kt + 8 * j + cq + c;
              bool ok = k_pos < Sk;
              if (causal) ok = ok && q_pos >= k_pos;
              if (window > 0) ok = ok && q_pos - k_pos < window;
              if (!ok) x = NEG_INF;
            }
            s[4 * j + 2 * i + c] = x;
            mx = fmaxf(mx, x);
          }
        mx = quad_max(mx);
        const float corr = exp2f(m[i] - mx);
        m[i] = mx;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = s[4 * j + 2 * i + c];
            const float p = x > NEG_INF ? exp2f(x - mx) : 0.f;
            rs += p;
            s[4 * j + 2 * i + c] = p;
          }
        l[i] = l[i] * corr + rs;       // this lane's share of the row sum
#pragma unroll
        for (int j = 0; j < DVP / 8; ++j) {
          acc[4 * j + 2 * i] *= corr;
          acc[4 * j + 2 * i + 1] *= corr;
        }
      }

      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t hi[4], lo[4];
        to_a_frags(s, kk, hi, lo);
        const uint64_t db = desc_mn(sV, BK * 128, kk);
        wgmma_rs_tb<DVP>(acc, hi, db, 1);
        wgmma_rs_tb<DVP>(acc, lo, db, 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
    }
    __syncthreads();                 // both warpgroups are done with `st`
    if (tid == 0 && it + STAGES < r.n)
      load_kv(st, r.k_lo + (it + STAGES) * BK);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r_in + 8 * i;
    const float lsum = quad_sum(l[i]);
    if (!live || row >= Sq) continue;
    const float l_safe = lsum == 0.f ? 1.f : lsum;
    const float inv = 1.f / l_safe;
    const size_t orow = static_cast<size_t>(q_depth) * Sq + row;
    if (lse != nullptr && (lane & 3) == 0)
      lse[orow] = m[i] == NEG_INF ? NEG_INF : m[i] * LN2 + logf(l_safe);
#pragma unroll
    for (int j = 0; j < DVP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < Dv)
        *reinterpret_cast<__nv_bfloat162*>(o + orow * Dv + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv,
                                  acc[4 * j + 2 * i + 1] * inv);
    }
  }
}

template <int DH, int DVH>
cudaError_t launch_dims(const CUtensorMap& tq, const CUtensorMap& tk,
                        const CUtensorMap& tv, void* o, float* lse, int B,
                        int Hq, int Hkv, int Sq, int Sk, int Dv, float scale,
                        int causal, int window, int q_offset,
                        cudaStream_t stream) {
  const size_t smem = 1024 + DH * BQ * 128 +
                      STAGES * (DH + DVH) * BK * 128 + 8 * (STAGES + 1);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<DH, DVH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  flash_fwd_wgmma<DH, DVH><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Hq, Hkv, Sq, Sk, Dv,
      scale * LOG2E, causal, window, q_offset);
  return cudaGetLastError();
}

// whether the tensor-core route takes these operands (o is stored in
// bf16 pairs)
bool takes(const void* q, const void* k, const void* v, const void* o,
           int Sk, int D, int Dv) {
  return Sk > 0 && tma_ok(D, q) && tma_ok(D, k) && tma_ok(Dv, v) &&
         (reinterpret_cast<uintptr_t>(o) & 3) == 0;
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                   int Dv, float scale, int causal, int window, int q_offset,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, Sq, B * Hq, BQ) ||
      !make_map(&tk, k, D, Sk, B * Hkv, BK) ||
      !make_map(&tv, v, Dv, Sk, B * Hkv, BK))
    return cudaErrorInvalidValue;
  const bool d2 = D > 64, dv2 = Dv > 64;
  if (D > 128 && dv2)
    return launch_dims<3, 2>(tq, tk, tv, o, lse, B, Hq, Hkv, Sq, Sk, Dv,
                             scale, causal, window, q_offset, stream);
  if (D > 128)
    return launch_dims<3, 1>(tq, tk, tv, o, lse, B, Hq, Hkv, Sq, Sk, Dv,
                             scale, causal, window, q_offset, stream);
  if (d2 && dv2)
    return launch_dims<2, 2>(tq, tk, tv, o, lse, B, Hq, Hkv, Sq, Sk, Dv,
                             scale, causal, window, q_offset, stream);
  if (d2)
    return launch_dims<2, 1>(tq, tk, tv, o, lse, B, Hq, Hkv, Sq, Sk, Dv,
                             scale, causal, window, q_offset, stream);
  if (dv2)
    return launch_dims<1, 2>(tq, tk, tv, o, lse, B, Hq, Hkv, Sq, Sk, Dv,
                             scale, causal, window, q_offset, stream);
  return launch_dims<1, 1>(tq, tk, tv, o, lse, B, Hq, Hkv, Sq, Sk, Dv,
                           scale, causal, window, q_offset, stream);
}

}  // namespace wg

// 1 when flash_attention_launch takes the tensor-core route for these
// operands, 0 when it takes the CUDA-core kernel (the wrapper counts the
// launches of each route)
extern "C" int flash_attention_route(const void* q, const void* k,
                                     const void* v, const void* o, int Sk,
                                     int D, int Dv, int dtype) {
  return dtype == DTYPE_BF16 && wg::takes(q, k, v, o, Sk, D, Dv) ? 1 : 0;
}

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int Hq, int Hkv, int Sq, int Sk,
                                      int D, int Dv,
                                      float scale, int causal, int window,
                                      int q_offset, int dtype, void* stream) {
  if (D < 1 || D > MAX_D || Dv < 1 || Dv > MAX_DV || Hkv < 1 || Hq % Hkv)
    return cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Sq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == DTYPE_BF16) {
    if (wg::takes(q, k, v, o, Sk, D, Dv))
      return wg::launch(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, D, Dv, scale,
                        causal, window, q_offset, s);
    return launch<__nv_bfloat16>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, D, Dv,
                                 scale, causal, window, q_offset, s);
  }
  if (dtype == DTYPE_F32)
    return launch<float>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, D, Dv, scale,
                         causal, window, q_offset, s);
  return cudaErrorInvalidValue;
}
