// Mamba2 SSD chunked scan: y = the state-space recurrence
//     h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = C_t . h_t + D x_t
// per (batch, head), evaluated chunk by chunk in its state-space-dual
// form, with an initial state h0 and the final state written out.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel
// (wrapper ssd_scan_pallas), whose (B, H, n_chunks) grid carries the (P, N)
// fp32 state across its sequential chunk dimension in VMEM scratch.  That
// wrapper takes no h0 and recomputes the final state with the jnp path;
// here both come from the kernel's own carry.
//
// Bound on the H100: memory at zamba2_2p7b's prefill shape (x (4, 1000,
// 80, 64) bf16, N = 64, chunk 256).  x and y are 41 MB each and dt, B, C,
// h0 and the final state ~13 MB together, ~0.028 ms at 3.35 TB/s; the
// ~16 GFLOP of the chunked form (C.B^T and the weighted sum over j <= t
// within a chunk, the inter-chunk product and the state update) would take
// 0.016 ms at the bf16 tensor-core peak.  This kernel does them in fp32 on
// the CUDA cores (67 TFLOP/s peak), so arithmetic, not memory, sets its
// time.
//
// Design: one block (256 threads) per (head, batch) sweeps the chunks in
// order, as the TPU grid does, with the state in shared memory, stored
// transposed [n][p] in fp32.  A chunk of Q rows is cut into 64-row tiles:
// its x, B and C do not fit shared memory whole in fp32 beside the (Q, Q)
// decay matrix.  Per chunk:
//   1. dt of the chunk is read (0 past the chunk and past the sequence:
//      the ragged tail needs no padded copy), one thread takes the
//      inclusive sum a of dt * A in sequence order (a few microseconds a
//      chunk), and w_j = exp(a_last - a_j) dt_j;
//   2. for each output tile i: the inter-chunk term C_t . h from the old
//      state; then for each tile j <= i, C_i B_j^T (64 x 64), weighted by
//      exp(a_t - a_j) dt_j where t >= j and 0 elsewhere (the exponent is
//      taken only where t >= j, so it never overflows: a is falling, so
//      a_t - a_j <= 0 and a large |a| underflows cleanly to 0), times x_j;
//      y = exp(a_t) (C_t . h) + intra + D x_t, written in x's dtype for
//      rows inside the sequence;
//   3. during the last tile's sweep over j, which loads every tile of the
//      chunk, the carry sum_j w_j B_j^T x_j accumulates in registers; after
//      all outputs (which read the old state) h = exp(a_last) h + it.
// Every product is a 64-row shared-memory tile product in which each
// thread owns a 4 x 4 patch and reads float4s (tiles padded to 68 floats a
// row).  Shared memory is 6 tiles (104 KB) plus 3 floats a chunk row (3 KB
// at Q = 256), so two blocks share an SM; P and N up to 64.  x, B and C
// are read through their (batch, sequence) strides, so the slices of the
// conv output need no copy.  Tensor cores, TMA, one C.B^T for all heads
// and parallelism across chunks are left for later.
#include "common.cuh"

namespace {

constexpr int TILE = 64;         // rows of a chunk tile
constexpr int LD = TILE + 4;     // fp32 row of a shared tile, 16-byte rows
constexpr int THREADS = 256;     // 16 x 16, each a 4 x 4 patch of 64 x 64

// acc[r][c] += sum_{k < K} At[k][4 ty + r] * Bm[k][4 tx + c]
__device__ __forceinline__ void tile_mma(float (&acc)[4][4],
                                         const float* __restrict__ At,
                                         const float* __restrict__ Bm, int K,
                                         int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(At + k * LD + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(Bm + k * LD + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dv,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_final, int S, int H, int P, int N,
                int Q, long long x_sb, long long x_ss, long long b_sb,
                long long b_ss, long long c_sb, long long c_ss) {
  extern __shared__ __align__(16) float smem[];
  const int nt = (Q + TILE - 1) / TILE;
  const int R = nt * TILE;
  float* sHt = smem;               // [n][p] the state, transposed
  float* sCt = sHt + TILE * LD;    // [n][t] C of output tile i
  float* sBt = sCt + TILE * LD;    // [n][j] B of tile j
  float* sBw = sBt + TILE * LD;    // [j][n] B of tile j times w_j
  float* sX = sBw + TILE * LD;     // [j][p] x of tile j
  float* sWt = sX + TILE * LD;     // [j][t] the masked decay weights
  float* s_dt = sWt + TILE * LD;   // R: dt of the chunk
  float* s_a = s_dt + R;           // R: cumulative sum of dt * A
  float* s_w = s_a + R;            // R: exp(a_last - a_j) * dt_j

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float a_h = A[h], d_h = Dv[h];
  const T* xb = x + b * x_sb + static_cast<long long>(h) * P;
  const T* Bb = Bm + b * b_sb;
  const T* Cb = Cm + b * c_sb;
  const float* dtb = dt + static_cast<long long>(b) * S * H + h;
  T* yb = y + (static_cast<long long>(b) * S * H + h) * P;
  const long long hoff = (static_cast<long long>(b) * H + h) * P * N;
  const bool out_p = tx * 4 < P;                  // owns some y / h column
  const bool out_n = ty * 4 < N;                  // owns some h row

  for (int e = tid; e < P * N; e += THREADS)
    sHt[(e % N) * LD + e / N] = h0 != nullptr ? h0[hoff + e] : 0.f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int s0 = ck * Q;
    for (int r = tid; r < R; r += THREADS) {
      const int s = s0 + r;
      s_dt[r] = (r < Q && s < S) ? dtb[static_cast<long long>(s) * H] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      // in order, each product and sum rounded on its own (no FMA), as a
      // cumulative sum along the sequence takes them: a_t - a_j is a
      // difference of two large sums, so a different order would move
      // the decay weights by ulps of |a|
      float run = 0.f;
      for (int r = 0; r < R; ++r) {
        run = __fadd_rn(run, __fmul_rn(s_dt[r], a_h));
        s_a[r] = run;
      }
    }
    __syncthreads();
    const float a_last = s_a[Q - 1];
    for (int r = tid; r < R; r += THREADS)
      s_w[r] = r < Q ? expf(a_last - s_a[r]) * s_dt[r] : 0.f;

    float hacc[4][4];
    zero(hacc);
    for (int i = 0; i < nt; ++i) {
      const int t0 = i * TILE;
      for (int e = tid; e < TILE * N; e += THREADS) {
        const int t = e / N, n = e - t * N, s = s0 + t0 + t;
        sCt[n * LD + t] =
            (t0 + t < Q && s < S) ? to_f32(Cb[s * c_ss + n]) : 0.f;
      }
      __syncthreads();
      float inter[4][4], acc[4][4];
      zero(inter);
      zero(acc);
      if (out_p) tile_mma(inter, sCt, sHt, N, ty, tx);   // C_t . h
      for (int j = 0; j <= i; ++j) {
        const int j0 = j * TILE;
        for (int e = tid; e < TILE * N; e += THREADS) {
          const int jj = e / N, n = e - jj * N, s = s0 + j0 + jj;
          const float v =
              (j0 + jj < Q && s < S) ? to_f32(Bb[s * b_ss + n]) : 0.f;
          sBt[n * LD + jj] = v;
          sBw[jj * LD + n] = v * s_w[j0 + jj];
        }
        for (int e = tid; e < TILE * P; e += THREADS) {
          const int jj = e / P, p = e - jj * P, s = s0 + j0 + jj;
          sX[jj * LD + p] =
              (j0 + jj < Q && s < S) ? to_f32(xb[s * x_ss + p]) : 0.f;
        }
        __syncthreads();
        float cb[4][4];
        zero(cb);
        tile_mma(cb, sCt, sBt, N, ty, tx);               // C_t . B_j
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jr = j0 + tx * 4 + c;
          float w[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int tr = t0 + ty * 4 + r;
            w[r] = tr >= jr ? cb[r][c] * expf(s_a[tr] - s_a[jr]) * s_dt[jr]
                            : 0.f;
          }
          *reinterpret_cast<float4*>(sWt + (tx * 4 + c) * LD + ty * 4) =
              make_float4(w[0], w[1], w[2], w[3]);
        }
        __syncthreads();
        if (out_p) tile_mma(acc, sWt, sX, TILE, ty, tx);
        if (i == nt - 1 && out_p && out_n)
          tile_mma(hacc, sBw, sX, TILE, ty, tx);         // B_j w_j x_j
        __syncthreads();
      }
      // sX holds x of tile i (the sweep ended at j = i): the D skip
      if (out_p) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = ty * 4 + r, s = s0 + t0 + t;
          if (t0 + t >= Q || s >= S) continue;
          const float ea = expf(s_a[t0 + t]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = tx * 4 + c;
            if (p < P)
              yb[static_cast<long long>(s) * H * P + p] = from_f32<T>(
                  (inter[r][c] * ea + acc[r][c]) + sX[t * LD + p] * d_h);
          }
        }
      }
    }
    // every output of the chunk has read the old state
    __syncthreads();
    if (out_p && out_n) {
      const float decay = expf(a_last);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx * 4 + c;
          if (n < N && p < P)
            sHt[n * LD + p] = sHt[n * LD + p] * decay + hacc[r][c];
        }
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < P * N; e += THREADS)
    h_final[hoff + e] = sHt[(e % N) * LD + e / N];
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, const void* D,
                   const void* h0, void* y, void* h_final, int Bt, int S,
                   int H, int P, int N, int Q, long long x_sb, long long x_ss,
                   long long b_sb, long long b_ss, long long c_sb,
                   long long c_ss, cudaStream_t stream) {
  const int R = (Q + TILE - 1) / TILE * TILE;
  const size_t smem = (6 * TILE * LD + 3 * R) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T><<<dim3(H, Bt), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_final), S, H, P, N, Q, x_sb, x_ss, b_sb, b_ss,
      c_sb, c_ss);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, const void* D,
                               const void* h0, void* y, void* h_final,
                               int Bt, int S, int H, int P, int N, int Q,
                               long long x_sb, long long x_ss,
                               long long b_sb, long long b_ss,
                               long long c_sb, long long c_ss, int dtype,
                               void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, dt, A, B, C, D, h0, y, h_final, Bt, S, H,
                                 P, N, Q, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss,
                                 st);
  return launch<float>(x, dt, A, B, C, D, h0, y, h_final, Bt, S, H, P, N, Q,
                       x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, st);
}
