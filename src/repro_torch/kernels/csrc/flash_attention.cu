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
// limit: memory bounds the least time, and this kernel, which does its
// arithmetic in fp32 on the CUDA cores, is far from both bounds.
//
// Design: one thread block (256 threads) per (q tile of 64 rows, q head,
// batch).  The kv dimension becomes a loop inside the block: each step
// stages a 64-row K and V tile in shared memory as fp32, computes the
// 64x64 score tile (each thread a 4x4 patch), updates m and l per row in
// fp32 registers (16 lanes share a row and reduce with shuffles), writes
// the probabilities to shared memory and accumulates P.V into a 4x8 fp32
// patch of the (64 x Dv) output per thread.  The kv head is hq / G, so a
// GQA group re-reads the same K/V tiles from L2, not from device memory.
// Masks are exact: k_pos < Sk, q_pos >= k_pos with q_pos = q_offset + row
// when causal, and q_pos - k_pos < window when window > 0; kv tiles wholly
// above the diagonal or left of the window are never loaded.  A row left
// fully masked ends with l = 0 and is divided by 1, as the TPU kernel
// does.  D and Dv up to 128; shared memory is 115.5 KB at D = Dv = 128,
// which needs cudaFuncSetAttribute above 48 KB and lets two blocks share
// an SM.
//
// Training: when the lse pointer is not null, the kernel also writes each
// row's log-sum-exp, lse = m + log(l_safe) in fp32 with l_safe = l or 1
// where l = 0 (as _flash_fwd_impl in src/repro/kernels/ops.py), shape
// (B, Hq, Sq); the backward (flash_attention_bwd.cu) recomputes the
// probabilities from it.  A fully masked row keeps m = NEG_INF, so its lse
// is -1e30.  Serving passes null and writes nothing more.
#include "common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // kv rows per tile
constexpr int THREADS = 256;
constexpr int MAX_DV = 128;  // 16 lanes x 8 columns
constexpr int NJ = MAX_DV / 16;

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

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int Hq, int Hkv, int Sq, int Sk,
                                      int D, int Dv,
                                      float scale, int causal, int window,
                                      int q_offset, int dtype, void* stream) {
  if (D < 1 || D > 128 || Dv < 1 || Dv > MAX_DV || Hkv < 1 || Hq % Hkv)
    return cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Sq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, D, Dv,
                                 scale, causal, window, q_offset, s);
  if (dtype == DTYPE_F32)
    return launch<float>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, D, Dv, scale,
                         causal, window, q_offset, s);
  return cudaErrorInvalidValue;
}
