// GQA flash attention backward: dq, dk, dv from (q, k, v, o, do, lse).
//
// Not a TPU kernel: the JAX package differentiates flash attention through
// the custom VJP _flash_bwd_rule (src/repro/kernels/ops.py:125), which scans
// kv chunks, recomputes p = exp(s - lse) * mask from the forward's lse and
// accumulates dq across the scan while each chunk's dk/dv leave it whole.
// These kernels are the port's counterpart of that rule, for the forward
// kernel in flash_attention.cu (which replaces src/repro/kernels/
// flash_attention.py::_fa_kernel).
//
// Bound on the H100: at the train shapes ((2, 32, 2048, 128) causal) the
// work is five products of the forward's size (S, dP, dV, dK, dQ) against
// q, k, v, o, do read and dq, dk, dv written, ~300 flop/byte in bf16: the
// tensor cores bound it.
//
// Design: a TPU grid carries sums along a sequential dimension; Hopper
// blocks run in no order, and a sum across blocks needs atomics or a
// second pass.  So the backward is three passes, none with atomics, each
// output written once by one block in a fixed order: dq, dk and dv are
// bitwise the same from run to run.
//  1. delta = rowsum(o * do) in fp32, one warp a row.
//  2. dk/dv: one block per (kv tile, kv head, batch) loops over the G query
//     heads of its group and over the q tiles that can see its kv tile
//     (causal tiles above the diagonal and tiles past the window are
//     skipped), recomputing s, p = exp(s * scale - lse) where the mask
//     allows and 0 elsewhere, dp = do v^T and ds = p (dp - delta) scale;
//     dv += p^T do and dk += ds^T q stay in fp32 registers.
//  3. dq: one block per (q tile, q head, batch) sweeps the kv tiles that
//     its rows can see, as the forward does, recomputes s, p, dp and ds
//     the same way and accumulates dq = ds k in fp32 registers.
// The dq pass repeats two products of the dk/dv pass (s and dp) as the
// price of writing dq without atomics.  A fully masked row has lse =
// -1e30 and no allowed entry: it gets zero gradient.
//
// bf16 (the *_wgmma kernels): every product on the tensor cores through
// wgmma (bf16 operands, fp32 accumulators; hopper.cuh), two warpgroups a
// block.  dk/dv: a block owns 128 kv rows (64 a warpgroup), K and V loaded
// once by TMA; Q and dO tiles of 64 rows stream through a two-stage TMA
// ring (one mbarrier a stage), lse and delta through a two-slot buffer the
// block's first 64 threads fill a tile ahead.  S^T = K Q^T and dP^T =
// V dO^T come from shared memory (all K-major); p and ds are formed on the
// fp32 accumulator fragments in registers, where they are the A operands
// of dV += P^T dO and dK += dS^T Q, with dO and Q read MN-major (the
// transpose bit) from the ring: no transpose goes through shared memory.
// dq: a block owns 128 q rows (64 a warpgroup) with Q and dO loaded once,
// K and V tiles of 64 rows stream through the ring; S = Q K^T and dP =
// dO V^T from shared memory, dS in registers is the A operand of dQ += dS K
// with K read MN-major.  Tiles are 64-column halves of 128-byte swizzled
// rows, zero-filled by TMA past the tensors' edges, so D = 80 or 72 pads
// to 128 columns, and every batch of wgmma is issued without a branch
// (see flash_attention.cu).  As in the
// forward, p and ds go to the tensor cores as two bf16 parts (hi + lo,
// hopper.cuh to_a_frags): rounded once to bf16 they put up to 2x the bf16
// tolerance into dq, dk and dv at (2, 32, 2048, 128), so dV, dK and dQ
// each take two products (ten product-sized passes in all against the
// five of the bound).  Needs D and Dv multiples of 8 and 16-byte aligned
// bases; other bf16 shapes take the CUDA-core kernels.
//
// f32 (flash_bwd_dkdv_kernel and flash_bwd_dq_kernel, fmaf on the CUDA
// cores; TF32 would not hold the f32 checks' 1e-4): the same passes with
// 64-row tiles staged in shared memory as fp32 (rows padded by one float
// against bank conflicts), each thread a 4x4 patch of the 64x64 tiles and
// a 4x8 patch of the (64 x D) accumulators.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // kv rows per block
constexpr int THREADS = 256;
constexpr int MAX_D = 128;   // 16 lanes x 8 columns
constexpr int NJ = MAX_D / 16;

// delta[row] = sum_c o[row, c] * do[row, c] in fp32; one warp per row.
template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o,
                                       const T* __restrict__ dO,
                                       float* __restrict__ delta,
                                       long long rows, int Dv) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                  // whole warps leave together
  const T* orow = o + row * Dv;
  const T* drow = dO + row * Dv;
  float acc = 0.f;
  for (int c = lane; c < Dv; c += 32)
    acc = fmaf(to_f32(orow[c]), to_f32(drow[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Hq, int Hkv, int Sq, int Sk,
                      int D, int Dv, float scale, int causal, int window,
                      int q_offset) {
  extern __shared__ float smem[];
  const int DP = D + 1, DVP = Dv + 1, PP = BK + 1;
  float* sK = smem;                         // BK x DP
  float* sV = sK + BK * DP;                 // BK x DVP
  float* sQ = sV + BK * DVP;                // BQ x DP
  float* sO = sQ + BQ * DP;                 // BQ x DVP (the dO tile)
  float* sP = sO + BQ * DVP;                // BQ x PP
  float* sS = sP + BQ * PP;                 // BQ x PP (ds)
  float* sL = sS + BQ * PP;                 // BQ lse
  float* sD = sL + BQ;                      // BQ delta

  const int tid = threadIdx.x;
  const int ty = tid >> 4;                  // rows ty*4 .. ty*4+3
  const int tx = tid & 15;                  // cols tx + 16*j
  const int kt = blockIdx.x * BK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;

  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * Dv;
  for (int idx = tid; idx < BK * D; idx += THREADS) {
    const int r = idx / D, c = idx - r * D;
    const int row = kt + r;
    sK[r * DP + c] =
        row < Sk ? to_f32(kb[static_cast<size_t>(row) * D + c]) : 0.f;
  }
  for (int idx = tid; idx < BK * Dv; idx += THREADS) {
    const int r = idx / Dv, c = idx - r * Dv;
    const int row = kt + r;
    sV[r * DVP + c] =
        row < Sk ? to_f32(vb[static_cast<size_t>(row) * Dv + c]) : 0.f;
  }

  // the q rows that can see some kv row of this tile
  const int k_last = min(kt + BK, Sk) - 1;
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, kt - q_offset);
  if (window > 0) q_hi = min(Sq, max(0, k_last + window - q_offset));
  q_lo = (q_lo / BQ) * BQ;

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int hq = hk * G + g;
    const size_t head = static_cast<size_t>(b) * Hq + hq;
    const T* qb = q + head * Sq * D;
    const T* ob = dO + head * Sq * Dv;
    const float* lb = lse + head * Sq;
    const float* db = delta + head * Sq;

    for (int qt = q_lo; qt < q_hi; qt += BQ) {
      __syncthreads();  // the previous tile's shared reads are done
      for (int idx = tid; idx < BQ * D; idx += THREADS) {
        const int r = idx / D, c = idx - r * D;
        const int row = qt + r;
        sQ[r * DP + c] =
            row < Sq ? to_f32(qb[static_cast<size_t>(row) * D + c]) : 0.f;
      }
      for (int idx = tid; idx < BQ * Dv; idx += THREADS) {
        const int r = idx / Dv, c = idx - r * Dv;
        const int row = qt + r;
        sO[r * DVP + c] =
            row < Sq ? to_f32(ob[static_cast<size_t>(row) * Dv + c]) : 0.f;
      }
      if (tid < BQ) {
        const int row = qt + tid;
        sL[tid] = row < Sq ? lb[row] : 0.f;
        sD[tid] = row < Sq ? db[row] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
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
      const float* orow = sO + (ty * 4) * DVP;
      const float* vrow = sV + tx * DVP;
#pragma unroll 4
      for (int d = 0; d < Dv; ++d) {
        float ov[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ov[i] = orow[i * DVP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = vrow[(16 * j) * DVP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const int q_row = qt + r;
        const int q_pos = q_offset + q_row;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int k_pos = kt + c;
          bool ok = q_row < Sq && k_pos < Sk;
          if (causal) ok = ok && (q_pos >= k_pos);
          if (window > 0) ok = ok && (q_pos - k_pos < window);
          const float p = ok ? expf(s[i][j] * scale - sL[r]) : 0.f;
          sP[r * PP + c] = p;
          sS[r * PP + c] = p * (dp[i][j] - sD[r]) * scale;
        }
      }
      __syncthreads();

      // dv += p^T do and dk += ds^T q over this tile's q rows
#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[4], sv[4], ov[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sP[qq * PP + ty * 4 + i];
          sv[i] = sS[qq * PP + ty * 4 + i];
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int c = tx + 16 * jj;
          ov[jj] = c < Dv ? sO[qq * DVP + c] : 0.f;
          qv[jj] = c < D ? sQ[qq * DP + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            dv_acc[i][jj] = fmaf(pv[i], ov[jj], dv_acc[i][jj]);
            dk_acc[i][jj] = fmaf(sv[i], qv[jj], dk_acc[i][jj]);
          }
      }
    }
  }

  T* dkb = dk + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  T* dvb = dv + (static_cast<size_t>(b) * Hkv + hk) * Sk * Dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = kt + ty * 4 + i;
    if (row >= Sk) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D)
        dkb[static_cast<size_t>(row) * D + c] = from_f32<T>(dk_acc[i][jj]);
      if (c < Dv)
        dvb[static_cast<size_t>(row) * Dv + c] = from_f32<T>(dv_acc[i][jj]);
    }
  }
}

// dq = ds k for one (q tile of 64 rows, q head, batch), the kv tiles the
// rows can see swept in order; s, p, dp and ds as in the dk/dv kernel.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Hq, int Hkv, int Sq, int Sk, int D, int Dv,
                    float scale, int causal, int window, int q_offset) {
  extern __shared__ float smem[];
  const int DP = D + 1, DVP = Dv + 1, PP = BK + 1;
  float* sQ = smem;                         // BQ x DP
  float* sO = sQ + BQ * DP;                 // BQ x DVP (the dO tile)
  float* sK = sO + BQ * DVP;                // BK x DP
  float* sV = sK + BK * DP;                 // BK x DVP
  float* sS = sV + BK * DVP;                // BQ x PP (ds)
  float* sL = sS + BQ * PP;                 // BQ lse
  float* sD = sL + BQ;                      // BQ delta

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int qt = blockIdx.x * BQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const size_t head = static_cast<size_t>(b) * Hq + hq;
  const T* qb = q + head * Sq * D;
  const T* ob = dO + head * Sq * Dv;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * Dv;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx - r * D;
    const int row = qt + r;
    sQ[r * DP + c] =
        row < Sq ? to_f32(qb[static_cast<size_t>(row) * D + c]) : 0.f;
  }
  for (int idx = tid; idx < BQ * Dv; idx += THREADS) {
    const int r = idx / Dv, c = idx - r * Dv;
    const int row = qt + r;
    sO[r * DVP + c] =
        row < Sq ? to_f32(ob[static_cast<size_t>(row) * Dv + c]) : 0.f;
  }
  if (tid < BQ) {
    const int row = qt + tid;
    sL[tid] = row < Sq ? lse[head * Sq + row] : 0.f;
    sD[tid] = row < Sq ? delta[head * Sq + row] : 0.f;
  }

  const int q_first = q_offset + qt;
  const int q_last = q_offset + min(qt + BQ, Sq) - 1;
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q_last + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q_first - window + 1);
  k_lo = (k_lo / BK) * BK;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;

  for (int kt = k_lo; kt < k_hi; kt += BK) {
    __syncthreads();  // the previous tile's shared reads are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx - r * D;
      const int row = kt + r;
      sK[r * DP + c] =
          row < Sk ? to_f32(kb[static_cast<size_t>(row) * D + c]) : 0.f;
    }
    for (int idx = tid; idx < BK * Dv; idx += THREADS) {
      const int r = idx / Dv, c = idx - r * Dv;
      const int row = kt + r;
      sV[r * DVP + c] =
          row < Sk ? to_f32(vb[static_cast<size_t>(row) * Dv + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
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
    const float* orow = sO + (ty * 4) * DVP;
    const float* vrow = sV + tx * DVP;
#pragma unroll 4
    for (int d = 0; d < Dv; ++d) {
      float ov[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ov[i] = orow[i * DVP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = vrow[(16 * j) * DVP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int q_row = qt + r;
      const int q_pos = q_offset + q_row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int k_pos = kt + c;
        bool ok = q_row < Sq && k_pos < Sk;
        if (causal) ok = ok && (q_pos >= k_pos);
        if (window > 0) ok = ok && (q_pos - k_pos < window);
        const float p = ok ? expf(s[i][j] * scale - sL[r]) : 0.f;
        sS[r * PP + c] = p * (dp[i][j] - sD[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float sv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sS[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int c = tx + 16 * jj;
        kv[jj] = c < D ? sK[kk * DP + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          acc[i][jj] = fmaf(sv[i], kv[jj], acc[i][jj]);
    }
  }

  T* dqb = dq + head * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt + ty * 4 + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D)
        dqb[static_cast<size_t>(row) * D + c] = from_f32<T>(acc[i][jj]);
    }
  }
}

template <typename T>
cudaError_t launch_cuda_cores(const void* q, const void* k, const void* v,
                              const void* dO, const float* lse,
                              const float* delta, void* dq, void* dk,
                              void* dv, int B, int Hq, int Hkv, int Sq,
                              int Sk, int D, int Dv, float scale, int causal,
                              int window, int q_offset, cudaStream_t stream) {
  const size_t tiles = static_cast<size_t>(BK) * (D + 1) +
                       static_cast<size_t>(BK) * (Dv + 1) +
                       static_cast<size_t>(BQ) * (D + 1) +
                       static_cast<size_t>(BQ) * (Dv + 1);
  const size_t smem_kv = sizeof(float) * (tiles + 2 * BQ * (BK + 1) + 2 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T><<<dim3((Sk + BK - 1) / BK, Hkv, B), THREADS,
                             smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, Sq, Sk, D, Dv,
      scale, causal, window, q_offset);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem_q = sizeof(float) * (tiles + BQ * (BK + 1) + 2 * BQ);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T><<<dim3((Sq + BQ - 1) / BQ, Hq, B), THREADS, smem_q,
                           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, delta,
      static_cast<T*>(dq), Hq, Hkv, Sq, Sk, D, Dv, scale, causal, window,
      q_offset);
  return cudaGetLastError();
}

}  // namespace

// ----------------------------------------------------- bf16, tensor cores

namespace wg {

using namespace hopper;

constexpr int ROWS = 128;    // rows a block owns (two warpgroups of 64)
constexpr int TILE = 64;     // rows of a streamed ring tile
constexpr int STAGES = 2;
constexpr int THREADS = 256;

__device__ __forceinline__ uint8_t* align_smem(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// dk, dv for 128 kv rows of one kv head: the G query heads of its group
// and the 64-row q tiles that see the rows, in order.
template <int DH, int DVH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Hq, int Hkv, int Sq,
                     int Sk, int D, int Dv, float scale, float scale_log2,
                     int causal, int window, int q_offset) {
  constexpr int DP = 64 * DH, DVP = 64 * DVH;
  constexpr int Q_BYTES = DH * TILE * 128, DO_BYTES = DVH * TILE * 128;
  constexpr int STAGE = Q_BYTES + DO_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align_smem(smem_raw);
  uint8_t* sV = sK + DH * ROWS * 128;
  uint8_t* sRing = sV + DVH * ROWS * 128;
  float* sLD = reinterpret_cast<float*>(sRing + STAGES * STAGE);  // [2][2][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sLD + 4 * TILE);

  const int tid = threadIdx.x, wgi = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int kt = blockIdx.z * ROWS;          // kv tile 0 has the most work
  const int G = Hq / Hkv;

  // the q rows that can see some kv row of this block
  const int k_last = min(kt + ROWS, Sk) - 1;
  int q_lo = causal ? max(0, kt - q_offset) : 0;
  const int q_hi = window > 0 ? min(Sq, max(0, k_last + window - q_offset))
                              : Sq;
  q_lo = (q_lo / TILE) * TILE;
  const int nq = q_hi > q_lo ? (q_hi - q_lo + TILE - 1) / TILE : 0;
  const int n = G * nq;

  auto depth = [&](int it) { return b * Hq + hk * G + it / nq; };
  auto q_tile = [&](int it) { return q_lo + (it % nq) * TILE; };
  auto load_item = [&](int stage, int it) {
    uint8_t* dst = sRing + stage * STAGE;
    mbar_expect_tx(&bar[1 + stage], STAGE);
    tma_tile(dst, &tq, &bar[1 + stage], DH, TILE, q_tile(it), depth(it));
    tma_tile(dst + Q_BYTES, &tdo, &bar[1 + stage], DVH, TILE, q_tile(it),
             depth(it));
  };
  // lse (times log2 e) and delta of item it's rows into slot it % 2
  auto load_ld = [&](int it) {
    if (tid < TILE && it < n) {
      const int row = q_tile(it) + tid;
      const size_t at = static_cast<size_t>(depth(it)) * Sq + row;
      float* slot = sLD + (it & 1) * 2 * TILE;
      slot[tid] = row < Sq ? lse[at] * LOG2E : 0.f;
      slot[TILE + tid] = row < Sq ? delta[at] : 0.f;
    }
  };

  load_ld(0);
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[0], (DH + DVH) * ROWS * 128);
    tma_tile(sK, &tk, &bar[0], DH, ROWS, kt, b * Hkv + hk);
    tma_tile(sV, &tv, &bar[0], DVH, ROWS, kt, b * Hkv + hk);
    for (int i = 0; i < min(STAGES, n); ++i) load_item(i, i);
  }

  // this warpgroup's kv rows: wk0 + r_in + 8 i
  const int wk0 = kt + wgi * 64;
  const int r_in = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int wk_last = min(wk0 + 63, Sk - 1);
  const bool live = wk0 < Sk;

  float dk_acc[DP / 2], dv_acc[DVP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) dv_acc[i] = 0.f;

  mbar_wait(&bar[0], 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES, qt = q_tile(it);
    mbar_wait(&bar[1 + st], (it / STAGES) & 1);
    const int qp_first = q_offset + qt, qp_last = q_offset + qt + TILE - 1;
    const bool visible = live && !(causal && qp_last < wk0) &&
                         !(window > 0 && qp_first - wk_last >= window);
    if (visible) {
      const uint8_t* sQ = sRing + st * STAGE;
      const uint8_t* sdO = sQ + Q_BYTES;
      const float* sL = sLD + (it & 1) * 2 * TILE;
      const float* sD = sL + TILE;
      float s[32], dp[32];   // the first k-slice overwrites (scale-d = 0)
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * DH; ++kk)
        wgmma_ss_n64(s, desc_k(sK, ROWS * 128, wgi * 64, kk),
                     desc_k(sQ, TILE * 128, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4 * DVH; ++kk)
        wgmma_ss_n64(dp, desc_k(sV, ROWS * 128, wgi * 64, kk),
                     desc_k(sdO, TILE * 128, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      fence_regs(dp);

      // s^T and dp^T: rows are kv rows, columns q rows of the tile
      const bool edge = qt + TILE > Sq || wk0 + 64 > Sk ||
                        (causal && qp_first < wk_last) ||
                        (window > 0 && qp_last - wk0 >= window);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k_pos = wk0 + r_in + 8 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * j + cq + c, e = 4 * j + 2 * i + c;
            bool ok = true;
            if (edge) {
              const int q_pos = qp_first + col;
              ok = qt + col < Sq && k_pos < Sk;
              if (causal) ok = ok && q_pos >= k_pos;
              if (window > 0) ok = ok && q_pos - k_pos < window;
            }
            const float p = ok ? exp2f(s[e] * scale_log2 - sL[col]) : 0.f;
            s[e] = p;
            dp[e] = p * (dp[e] - sD[col]) * scale;
          }
      }

      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        uint32_t hi[4], lo[4];
        to_a_frags(s, kk, hi, lo);
        const uint64_t db = desc_mn(sdO, TILE * 128, kk);
        wgmma_rs_tb<DVP>(dv_acc, hi, db, 1);
        wgmma_rs_tb<DVP>(dv_acc, lo, db, 1);
      }
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        uint32_t hi[4], lo[4];
        to_a_frags(dp, kk, hi, lo);
        const uint64_t db = desc_mn(sQ, TILE * 128, kk);
        wgmma_rs_tb<DP>(dk_acc, hi, db, 1);
        wgmma_rs_tb<DP>(dk_acc, lo, db, 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    load_ld(it + 1);                  // the slot item it - 1 used
    __syncthreads();                  // stage st and slot it % 2 are free
    if (tid == 0 && it + STAGES < n) load_item(st, it + STAGES);
  }

  const size_t kv_head = static_cast<size_t>(b) * Hkv + hk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wk0 + r_in + 8 * i;
    if (row >= Sk) continue;
    const size_t at = kv_head * Sk + row;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(dk + at * D + col) =
            __floats2bfloat162_rn(dk_acc[4 * j + 2 * i],
                                  dk_acc[4 * j + 2 * i + 1]);
    }
#pragma unroll
    for (int j = 0; j < DVP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < Dv)
        *reinterpret_cast<__nv_bfloat162*>(dv + at * Dv + col) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * i],
                                  dv_acc[4 * j + 2 * i + 1]);
    }
  }
}

// dq for 128 query rows of one head: the kv tiles its rows see, in order.
template <int DH, int DVH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int Hq, int Hkv, int Sq,
                   int Sk, int D, float scale, float scale_log2, int causal,
                   int window, int q_offset) {
  constexpr int DP = 64 * DH;
  constexpr int K_BYTES = DH * TILE * 128, V_BYTES = DVH * TILE * 128;
  constexpr int STAGE = K_BYTES + V_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_smem(smem_raw);
  uint8_t* sdO = sQ + DH * ROWS * 128;
  uint8_t* sRing = sdO + DVH * ROWS * 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sRing + STAGES * STAGE);

  const int tid = threadIdx.x, wgi = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int hq = blockIdx.x, b = blockIdx.y;
  const int q_start = (gridDim.z - 1 - blockIdx.z) * ROWS;  // longest first
  const int hk = hq / (Hq / Hkv);
  const int q_depth = b * Hq + hq, kv_depth = b * Hkv + hk;

  const int q_first = q_offset + q_start;
  const int q_last = q_offset + min(q_start + ROWS, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  int k_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  k_lo = (k_lo / TILE) * TILE;
  const int n = k_hi > k_lo ? (k_hi - k_lo + TILE - 1) / TILE : 0;

  auto load_kv = [&](int stage, int kt) {
    uint8_t* dst = sRing + stage * STAGE;
    mbar_expect_tx(&bar[1 + stage], STAGE);
    tma_tile(dst, &tk, &bar[1 + stage], DH, TILE, kt, kv_depth);
    tma_tile(dst + K_BYTES, &tv, &bar[1 + stage], DVH, TILE, kt, kv_depth);
  };
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[0], (DH + DVH) * ROWS * 128);
    tma_tile(sQ, &tq, &bar[0], DH, ROWS, q_start, q_depth);
    tma_tile(sdO, &tdo, &bar[0], DVH, ROWS, q_start, q_depth);
    for (int i = 0; i < min(STAGES, n); ++i) load_kv(i, k_lo + i * TILE);
  }

  const int row0 = q_start + wgi * 64;
  const int r_in = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int wq_first = q_offset + row0;
  const int wq_last = q_offset + min(row0 + 64, Sq) - 1;
  const bool live = row0 < Sq;

  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r_in + 8 * i;
    const size_t at = static_cast<size_t>(q_depth) * Sq + row;
    lse2[i] = row < Sq ? lse[at] * LOG2E : 0.f;
    dl[i] = row < Sq ? delta[at] : 0.f;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  mbar_wait(&bar[0], 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES, kt = k_lo + it * TILE;
    mbar_wait(&bar[1 + st], (it / STAGES) & 1);
    const bool visible = live && !(causal && kt > wq_last) &&
                         !(window > 0 && wq_first - (kt + TILE - 1) >= window);
    if (visible) {
      const uint8_t* sK = sRing + st * STAGE;
      const uint8_t* sV = sK + K_BYTES;
      float s[32], dp[32];   // the first k-slice overwrites (scale-d = 0)
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * DH; ++kk)
        wgmma_ss_n64(s, desc_k(sQ, ROWS * 128, wgi * 64, kk),
                     desc_k(sK, TILE * 128, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4 * DVH; ++kk)
        wgmma_ss_n64(dp, desc_k(sdO, ROWS * 128, wgi * 64, kk),
                     desc_k(sV, TILE * 128, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      fence_regs(dp);

      const bool edge = kt + TILE > Sk ||
                        (causal && kt + TILE - 1 > wq_first) ||
                        (window > 0 && wq_last - kt >= window);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q_pos = wq_first + r_in + 8 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            bool ok = true;
            if (edge) {
              const int k_pos = kt + 8 * j + cq + c;
              ok = k_pos < Sk;
              if (causal) ok = ok && q_pos >= k_pos;
              if (window > 0) ok = ok && q_pos - k_pos < window;
            }
            const float p = ok ? exp2f(s[e] * scale_log2 - lse2[i]) : 0.f;
            dp[e] = p * (dp[e] - dl[i]) * scale;
          }
      }

      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        uint32_t hi[4], lo[4];
        to_a_frags(dp, kk, hi, lo);
        const uint64_t db = desc_mn(sK, TILE * 128, kk);
        wgmma_rs_tb<DP>(acc, hi, db, 1);
        wgmma_rs_tb<DP>(acc, lo, db, 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
    }
    __syncthreads();                 // both warpgroups are done with `st`
    if (tid == 0 && it + STAGES < n) load_kv(st, k_lo + (it + STAGES) * TILE);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r_in + 8 * i;
    if (row >= Sq) continue;
    const size_t at = static_cast<size_t>(q_depth) * Sq + row;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(dq + at * D + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

struct Maps {
  CUtensorMap q, k, v, dO;
};

template <int DH, int DVH>
cudaError_t launch_dims(const Maps& kv_pass, const Maps& q_pass,
                        const float* lse, const float* delta, void* dq,
                        void* dk, void* dv, int B, int Hq, int Hkv, int Sq,
                        int Sk, int D, int Dv, float scale, int causal,
                        int window, int q_offset, cudaStream_t stream) {
  const float scale_log2 = scale * LOG2E;
  const size_t smem_kv = 1024 + (DH + DVH) * ROWS * 128 +
                         STAGES * (DH + DVH) * TILE * 128 +
                         4 * TILE * sizeof(float) + 8 * (STAGES + 1);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma<DH, DVH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wgmma<DH, DVH><<<dim3(Hkv, B, (Sk + ROWS - 1) / ROWS),
                                  THREADS, smem_kv, stream>>>(
      kv_pass.q, kv_pass.k, kv_pass.v, kv_pass.dO, lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Hq,
      Hkv, Sq, Sk, D, Dv, scale, scale_log2, causal, window, q_offset);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem_q = 1024 + (DH + DVH) * ROWS * 128 +
                        STAGES * (DH + DVH) * TILE * 128 + 8 * (STAGES + 1);
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<DH, DVH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma<DH, DVH><<<dim3(Hq, B, (Sq + ROWS - 1) / ROWS), THREADS,
                                smem_q, stream>>>(
      q_pass.q, q_pass.k, q_pass.v, q_pass.dO, lse, delta,
      static_cast<__nv_bfloat16*>(dq), Hq, Hkv, Sq, Sk, D, scale,
      scale_log2, causal, window, q_offset);
  return cudaGetLastError();
}

// whether the tensor-core passes take these operands (dq, dk and dv are
// stored in bf16 pairs)
bool takes(const void* q, const void* k, const void* v, const void* dO,
           const void* dq, const void* dk, const void* dv, int D, int Dv) {
  return tma_ok(D, q) && tma_ok(D, k) && tma_ok(Dv, v) && tma_ok(Dv, dO) &&
         ((reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
           reinterpret_cast<uintptr_t>(dv)) & 3) == 0;
}

// passes 2 and 3 on the tensor cores
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dO, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, int B, int Hq, int Hkv,
                   int Sq, int Sk, int D, int Dv, float scale, int causal,
                   int window, int q_offset, cudaStream_t stream) {
  // the dk/dv pass streams 64-row q tiles past 128 kv rows; the dq pass
  // the other way round
  Maps kv_pass, q_pass;
  if (!make_map(&kv_pass.q, q, D, Sq, B * Hq, TILE) ||
      !make_map(&kv_pass.dO, dO, Dv, Sq, B * Hq, TILE) ||
      !make_map(&kv_pass.k, k, D, Sk, B * Hkv, ROWS) ||
      !make_map(&kv_pass.v, v, Dv, Sk, B * Hkv, ROWS) ||
      !make_map(&q_pass.q, q, D, Sq, B * Hq, ROWS) ||
      !make_map(&q_pass.dO, dO, Dv, Sq, B * Hq, ROWS) ||
      !make_map(&q_pass.k, k, D, Sk, B * Hkv, TILE) ||
      !make_map(&q_pass.v, v, Dv, Sk, B * Hkv, TILE))
    return cudaErrorInvalidValue;
  const bool d2 = D > 64, dv2 = Dv > 64;
  if (d2 && dv2)
    return launch_dims<2, 2>(kv_pass, q_pass, lse, delta, dq, dk, dv, B, Hq,
                             Hkv, Sq, Sk, D, Dv, scale, causal, window,
                             q_offset, stream);
  if (d2)
    return launch_dims<2, 1>(kv_pass, q_pass, lse, delta, dq, dk, dv, B, Hq,
                             Hkv, Sq, Sk, D, Dv, scale, causal, window,
                             q_offset, stream);
  if (dv2)
    return launch_dims<1, 2>(kv_pass, q_pass, lse, delta, dq, dk, dv, B, Hq,
                             Hkv, Sq, Sk, D, Dv, scale, causal, window,
                             q_offset, stream);
  return launch_dims<1, 1>(kv_pass, q_pass, lse, delta, dq, dk, dv, B, Hq,
                           Hkv, Sq, Sk, D, Dv, scale, causal, window,
                           q_offset, stream);
}

}  // namespace wg

// delta (B*Hq*Sq floats) is scratch the caller allocates; dq, dk, dv are
// written whole, each element by one block.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int Sq, int Sk, int D, int Dv,
    float scale, int causal, int window, int q_offset, int dtype,
    void* stream) {
  if (D < 1 || D > MAX_D || Dv < 1 || Dv > MAX_D || Hkv < 1 || Hq % Hkv ||
      (dtype != DTYPE_BF16 && dtype != DTYPE_F32))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const size_t esize = dtype == DTYPE_BF16 ? 2 : 4;
  const long long rows = static_cast<long long>(B) * Hq * Sq;
  const size_t kv = static_cast<size_t>(B) * Hkv * Sk;
  cudaError_t err;
  if (rows == 0 || Sk == 0) {  // nothing flows back: zero gradients
    if ((err = cudaMemsetAsync(dq, 0, esize * rows * D, s)) != cudaSuccess)
      return err;
    if ((err = cudaMemsetAsync(dk, 0, esize * kv * D, s)) != cudaSuccess)
      return err;
    return cudaMemsetAsync(dv, 0, esize * kv * Dv, s);
  }
  const unsigned blocks = static_cast<unsigned>((rows * 32 + 255) / 256);
  if (dtype == DTYPE_BF16)
    flash_bwd_delta_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dO), dl, rows, Dv);
  else
    flash_bwd_delta_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dO), dl,
        rows, Dv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (dtype == DTYPE_BF16) {
    if (wg::takes(q, k, v, dO, dq, dk, dv, D, Dv))
      return wg::launch(q, k, v, dO, l, dl, dq, dk, dv, B, Hq, Hkv, Sq, Sk,
                        D, Dv, scale, causal, window, q_offset, s);
    return launch_cuda_cores<__nv_bfloat16>(q, k, v, dO, l, dl, dq, dk, dv,
                                            B, Hq, Hkv, Sq, Sk, D, Dv, scale,
                                            causal, window, q_offset, s);
  }
  return launch_cuda_cores<float>(q, k, v, dO, l, dl, dq, dk, dv, B, Hq, Hkv,
                                  Sq, Sk, D, Dv, scale, causal, window,
                                  q_offset, s);
}
