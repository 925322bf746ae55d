// GQA flash attention backward: dq, dk, dv from (q, k, v, o, do, lse).
//
// Not a TPU kernel: the JAX package differentiates flash attention through
// the custom VJP _flash_bwd_rule (src/repro/kernels/ops.py:125), which scans
// kv chunks, recomputes p = exp(s - lse) * mask from the forward's lse and
// accumulates dq across the scan while each chunk's dk/dv leave it whole.
// This kernel is the port's counterpart of that rule, for the forward kernel
// in flash_attention.cu (which replaces src/repro/kernels/flash_attention.py
// ::_fa_kernel).
//
// Bound on the H100: at the train shapes ((2, 32, 2048, 128) causal) the
// work is ~2.5x the forward's flops (five products of the 64x64 tiles
// against the forward's two) over the same kind of bytes (q, k, v, o, do
// read, dq, dk, dv written), ~300 flop/byte in bf16: the tensor cores would
// bound it, but this kernel does its arithmetic in fp32 on the CUDA cores
// and is far from either bound.
//
// Design: a TPU grid carries sums along a sequential dimension; Hopper
// blocks run in no order.  So each block owns one (kv tile of 64 rows, kv
// head, batch) and loops over the G query heads of its group and over
// the 64-row q tiles that can see its kv tile (causal tiles above the
// diagonal and tiles past the window are skipped).  dk and dv accumulate
// in fp32 registers (each thread a 4 x 8 patch of both) and are written
// once, so the GQA sum over the group needs no atomics.  dq gets
// contributions from every kv tile, so each block adds its (64 x D) dq
// tile into an fp32 scratch buffer with atomicAdd; a last pass casts the
// scratch to the output dtype.  A first pass computes delta = rowsum(o *
// do) in fp32.  Per q tile the block stages Q and dO (and holds K and V)
// as fp32 in shared memory, rows padded by one float against bank
// conflicts, computes the 64x64 tiles S = Q K^T and dP = dO V^T (each
// thread a 4x4 patch), p = exp(s * scale - lse) where the mask allows and 0
// elsewhere (a fully masked row has lse = -1e30 and gets zero gradient),
// ds = p * (dp - delta) * scale, writes p and ds to shared memory, and then
// accumulates dv += p^T do, dk += ds^T q and its dq tile ds k.  Shared
// memory is 162 KB at D = Dv = 128 (one block an SM).
//
// The order of the atomic adds into dq changes from run to run, so dq is
// reproducible only to fp32 rounding (about 1e-7 relative); a bf16 dq may
// land one bf16 step apart between runs.
#include "common.cuh"

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
__global__ void cast_kernel(const float* __restrict__ x, T* __restrict__ y,
                            long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    y[i] = from_f32<T>(x[i]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dO,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq_acc,
                 T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv,
                 int Sq, int Sk, int D, int Dv, float scale, int causal,
                 int window, int q_offset) {
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
    float* dqb = dq_acc + head * Sq * D;

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

      // this kv tile's share of dq = ds k, added into the fp32 scratch
      float dq[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) dq[i][jj] = 0.f;
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
            dq[i][jj] = fmaf(sv[i], kv[jj], dq[i][jj]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = qt + ty * 4 + i;
        if (row >= Sq) continue;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int c = tx + 16 * jj;
          if (c < D) atomicAdd(dqb + static_cast<size_t>(row) * D + c,
                               dq[i][jj]);
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

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dO, const float* lse, float* delta,
                   float* dq_acc, void* dq, void* dk, void* dv, int B, int Hq,
                   int Hkv, int Sq, int Sk, int D, int Dv, float scale,
                   int causal, int window, int q_offset, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * Hq * Sq;
  const long long n_dq = rows * D;
  cudaError_t err;
  if (rows > 0) {
    flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows * 32 + 255) / 256),
                                256, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dO), delta, rows, Dv);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = cudaMemsetAsync(dq_acc, 0, sizeof(float) * n_dq, stream);
    if (err != cudaSuccess) return err;
  }
  if (Sk > 0 && rows > 0) {
    const size_t smem =
        sizeof(float) * (static_cast<size_t>(BK) * (D + 1) +
                         static_cast<size_t>(BK) * (Dv + 1) +
                         static_cast<size_t>(BQ) * (D + 1) +
                         static_cast<size_t>(BQ) * (Dv + 1) +
                         2 * BQ * (BK + 1) + 2 * BQ);
    err = cudaFuncSetAttribute(flash_bwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid((Sk + BK - 1) / BK, Hkv, B);
    flash_bwd_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dO), lse, delta,
        dq_acc, static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, Sq, Sk, D,
        Dv, scale, causal, window, q_offset);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  } else if (Sk > 0) {  // no query rows: nothing flows back to k and v
    const size_t kv = static_cast<size_t>(B) * Hkv * Sk;
    err = cudaMemsetAsync(dk, 0, sizeof(T) * kv * D, stream);
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(dv, 0, sizeof(T) * kv * Dv, stream);
    if (err != cudaSuccess) return err;
  }
  if (n_dq > 0) {
    const long long want = (n_dq + 255) / 256;
    const unsigned blocks = static_cast<unsigned>(want < 65536 ? want : 65536);
    cast_kernel<T><<<blocks, 256, 0, stream>>>(dq_acc, static_cast<T*>(dq),
                                               n_dq);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// delta (B*Hq*Sq floats) and dq_acc (B*Hq*Sq*D floats) are scratch the
// caller allocates; dq, dk, dv are written whole.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* delta, void* dq_acc, void* dq,
    void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk, int D, int Dv,
    float scale, int causal, int window, int q_offset, int dtype,
    void* stream) {
  if (D < 1 || D > MAX_D || Dv < 1 || Dv > MAX_D || Hkv < 1 || Hq % Hkv)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k, v, o, dO, l, dl, acc, dq, dk, dv, B,
                                 Hq, Hkv, Sq, Sk, D, Dv, scale, causal, window,
                                 q_offset, s);
  if (dtype == DTYPE_F32)
    return launch<float>(q, k, v, o, dO, l, dl, acc, dq, dk, dv, B, Hq, Hkv,
                         Sq, Sk, D, Dv, scale, causal, window, q_offset, s);
  return cudaErrorInvalidValue;
}
