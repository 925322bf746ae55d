// Mamba2 SSD chunked scan: y = the state-space recurrence
//     h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = C_t . h_t + D x_t
// per (batch, head), evaluated chunk by chunk in its state-space-dual
// form, with an initial state h0 and the final state written out.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel
// (wrapper ssd_scan_pallas), whose (B, H, n_chunks) grid carries the (P, N)
// fp32 state across its sequential chunk dimension in VMEM scratch.  That
// wrapper takes no h0 and recomputes the final state with the jnp path;
// here both come from the kernels' own arithmetic.
//
// Bound on the H100: memory at zamba2_2p7b's prefill shape (x (4, 1000,
// 80, 64) bf16, N = 64, chunk 256).  x and y are 41 MB each and dt, B, C,
// h0 and the final state ~13 MB together, ~0.028 ms at 3.35 TB/s; the
// ~16 GFLOP of the chunked form (C.B^T and the weighted sum over j <= t
// within a chunk, the inter-chunk product and the state update) would take
// 0.016 ms at the bf16 tensor-core peak.
//
// Design: two routes, chosen by the wrapper (kernels/ssd_scan.py
// chunked_route) from dtype, shape and alignment.
//
// The chunked route (ssd_scan_chunked_launch: bf16 x, B and C; P and N
// multiples of 16 up to 64; chunks of at most 256 positions; 16-byte
// aligned bases and (batch, sequence) strides).  The Mamba2 paper's own
// decomposition (Dao & Gu, arXiv:2405.21060, section 6), every chunk in
// parallel, four device kernels a call, in this order:
//   1. ssd_scan_cb_kernel: C.B^T once per (batch, chunk) for all heads (B
//      and C are shared by the heads), by 64 x 64 tile pairs on and below
//      the diagonal -> cb (Bt, nc, Qp, Qp) fp32, 4.2 MB at the prefill
//      shape, read back from L2;
//   2. ssd_scan_chunk_state_kernel, one block per (batch, chunk, head):
//      the within-chunk cumulative sum a of dt * A, taken by one thread in
//      sequence order with each product and sum rounded on its own (no
//      FMA: a_t - a_j is a difference of two large sums, and a warp-scan
//      order moved the fp32 final state to 0.81 of its tolerance) while
//      the tiles load -> acum (Bt, H, nc, Qp); then the chunk's state from
//      zero, sum_j w_j x_j B_j^T with w_j = exp(a_last - a_j) dt_j ->
//      states (Bt, nc, H, P, N);
//   3. ssd_scan_state_pass_kernel: h_c = exp(a_last) h_{c-1} + local_c per
//      (batch, head), elementwise over P x N, from h0; overwrites states
//      in place with the state entering each chunk and writes h_final;
//   4. ssd_scan_output_kernel: one block of 8 warps per (batch, chunk,
//      head); y = exp(a_t) (C_t . h_in) + sum_{j<=t} CB[t, j] exp(a_t -
//      a_j) dt_j x_j + D x_t, written once in bf16.  Warp w owns the
//      16-row tiles w and 15 - w, so every warp does the same share of
//      the causal triangle.  Below a tile's diagonal the decay factors as
//      exp(a_t - a_t0) exp(a_t0 - a_j) about the tile's first row t0,
//      both exponents <= 0, and the column factors (times dt_j) are one
//      shared table a block.
// acum, cb and the entering states are the buffers the SSD backward reads.
//
// Every product runs on the tensor cores with mma.sync m16n8k16 (bf16
// operands, fp32 accumulators), not wgmma: the products are small (K of 64
// or of one chunk) and one operand of each is an fp32 value built per
// fragment in registers (the masked decay weights, w_j x_j), which is the
// register A operand a warp's mma.sync takes as it is; the products are
// not what paces the kernels (the output kernel is bound by the latency
// of its k-loop and its lockstep loads, PERF.md).  Operands that are bf16
// in the inputs (x, B, C) are exact.  The three fp32 operands are split
// into bf16 parts, each the rounding of what the parts before it leave,
// one product each: one bf16 value would be off by 2^-9 relative and put
// h_final outside 1e-4; hi + lo is off by ~2^-17, which holds the
// tolerances but doubles the bf16 outputs that land a step from the
// plain version's and leaves h_final ~40 times farther from it than the
// scalar route; so the weights CB exp(a_t - a_j) dt_j and w_j x_j take
// three parts (~2^-26), the entering state h in C.h two (its rounding
// moves neither).  Tiles reach shared memory by
// cp.async (zero-filled past the chunk and the sequence) with rows padded
// by 16 bytes, and fragments are read by ldmatrix (.trans where the
// operand is stored k-major), without bank conflicts.
//
// The scalar route (ssd_scan_launch: fp32, and any shape or alignment the
// chunked route refuses) is the first design: one block (256 threads) per
// (head, batch) sweeps the chunks in order, as the TPU grid does, with the
// state in shared memory, stored transposed [n][p] in fp32.  A chunk of Q
// rows is cut into 64-row tiles: its x, B and C do not fit shared memory
// whole in fp32 beside the (Q, Q) decay matrix.  Per chunk:
//   1. dt of the chunk is read (0 past the chunk and past the sequence:
//      the ragged tail needs no padded copy), one thread takes the
//      inclusive sum a of dt * A in sequence order, and
//      w_j = exp(a_last - a_j) dt_j;
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
// Every product is a 64-row shared-memory tile product in fp32 on the CUDA
// cores, each thread a 4 x 4 patch read as float4s (tiles padded to 68
// floats a row).  Shared memory is 6 tiles (104 KB) plus 3 floats a chunk
// row (3 KB at Q = 256), so two blocks share an SM; P and N up to 64.
// x, B and C are read through their (batch, sequence) strides, so the
// slices of the conv output need no copy.
#include <cstdint>

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

// ===================================================== the chunked route

namespace chunked {

using bf16 = __nv_bfloat16;
using ll = long long;

constexpr int QMAX = 256;    // chunk rows at most
constexpr int PNMAX = 64;    // P and N at most
constexpr int PAD = 8;       // bf16 a shared row is padded by: 16 bytes

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

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ void zero(float (&acc)[PNMAX / 8][4]) {
#pragma unroll
  for (int i = 0; i < PNMAX / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
}

// 1. cb[b, c] = C_c B_c^T, tile pair (ti, tj <= ti) of 64 x 64; the
// blocks past the tile pairs take the cumulative sums a of dt * A of 32
// heads each -> acum.
constexpr int CUMSUM_HEADS = 32;

__device__ void cumsum_block(const float* __restrict__ dt,
                             const float* __restrict__ A,
                             float* __restrict__ acum, float* sdt, int hg,
                             int c, int b, int S, int H, int Q, int Qp,
                             int nc) {
  constexpr int LD = CUMSUM_HEADS + 1;   // a column read without conflicts
  const int h0 = hg * CUMSUM_HEADS, nh = min(CUMSUM_HEADS, H - h0);
  const int s0 = c * Q, valid = min(Q, S - s0);
  const float* db = dt + (static_cast<ll>(b) * S + s0) * H + h0;
  // every element of the chunk in flight at once (4-byte cp.async,
  // zeros past the sequence and the heads)
  const int hl = threadIdx.x % CUMSUM_HEADS;
  for (int r = threadIdx.x / CUMSUM_HEADS; r < Qp;
       r += blockDim.x / CUMSUM_HEADS) {
    const bool ok = r < valid && hl < nh;
    cp4(sdt + r * LD + hl, ok ? db + static_cast<ll>(r) * H + hl : dt, ok);
  }
  cp_wait_all();
  __syncthreads();
  if (threadIdx.x < nh) {
    // thread hl: head h0 + hl in sequence order, each product and sum
    // rounded on its own (no FMA); 16 values read before any is written
    const float a_h = A[h0 + hl];
    float run = 0.f;
    for (int r0 = 0; r0 < Qp; r0 += 16) {
      float v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = sdt[(r0 + u) * LD + hl];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        run = __fadd_rn(run, __fmul_rn(v[u], a_h));
        sdt[(r0 + u) * LD + hl] = run;
      }
    }
  }
  __syncthreads();
  // 16 values read before their stores (a store through a generic
  // pointer would otherwise hold back the next read)
  for (int e0 = threadIdx.x; e0 < nh * Qp; e0 += 16 * blockDim.x) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int e = e0 + u * blockDim.x, k = e / Qp, r = e - k * Qp;
      v[u] = e < nh * Qp ? sdt[r * LD + k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int e = e0 + u * blockDim.x, k = e / Qp, r = e - k * Qp;
      if (e < nh * Qp)
        acum[((static_cast<ll>(b) * H + h0 + k) * nc + c) * Qp + r] = v[u];
    }
  }
}

__global__ void __launch_bounds__(128)
ssd_scan_cb_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                   const float* __restrict__ dt, const float* __restrict__ A,
                   float* __restrict__ cb, float* __restrict__ acum, int S,
                   int H, int N, int Q, int Qp, int nc, int pairs, ll b_sb,
                   ll b_ss, ll c_sb, ll c_ss) {
  // two 64-row tiles, or a chunk of dt for 32 heads (33.8 KB)
  __shared__ __align__(16) float sbuf[QMAX * (CUMSUM_HEADS + 1)];
  bf16* sC = reinterpret_cast<bf16*>(sbuf);
  bf16* sB = sC + 64 * (PNMAX + PAD);
  const int c = blockIdx.y, b = blockIdx.z;
  if (static_cast<int>(blockIdx.x) >= pairs) {
    cumsum_block(dt, A, acum, sbuf, blockIdx.x - pairs, c, b, S, H, Q, Qp,
                 nc);
    return;
  }
  int p = blockIdx.x, ti = 0;
  while (p > ti) p -= ++ti;
  const int tj = p;
  const int ld = N + PAD, t0 = ti * 64, j0 = tj * 64;
  const int s0 = c * Q, valid = min(Q, S - s0);
  load_rows<128>(sC, ld, Cm, Cm + b * c_sb + (s0 + t0) * c_ss, c_ss, 64,
                 valid - t0, N);
  load_rows<128>(sB, ld, Bm, Bm + b * b_sb + (s0 + j0) * b_ss, b_ss, 64,
                 valid - j0, N);
  cp_wait_all();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int m0 = warp * 16;
  if (t0 + m0 >= Qp) return;
  float acc[PNMAX / 8][4];
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < PNMAX; kk += 16) {
    if (kk >= N) break;
    uint32_t a[4];
    // A[t][n] = C[t][n], stored row-major
    ldsm_x4(a, sC + (m0 + (mi & 1) * 8 + r8) * ld + kk + (mi >> 1) * 8);
#pragma unroll
    for (int nn = 0; nn < 64; nn += 16) {
      if (j0 + nn < Qp) {
        uint32_t bq[4];
        // B[n][j] = B_j[n], stored [j][n]: column-major as mma wants it
        ldsm_x4(bq, sB + (nn + (mi >> 1) * 8 + r8) * ld + kk + (mi & 1) * 8);
        mma(acc[nn / 8], a, bq[0], bq[1]);
        mma(acc[nn / 8 + 1], a, bq[2], bq[3]);
      }
    }
  }
  float* o = cb + (static_cast<ll>(b) * nc + c) * Qp * Qp;
  const int t = t0 + m0 + g;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = j0 + nt * 8 + 2 * q;
    if (j0 + nt * 8 < Qp) {
      *reinterpret_cast<float2*>(o + static_cast<ll>(t) * Qp + j) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(o + static_cast<ll>(t + 8) * Qp + j) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// 2. states[b, c, h] = sum_j w_j x_j B_j^T (P x N), w_j = exp(a_last -
// a_j) dt_j.  Warp w owns rows p of 16 (w % 4) .. + 15 and the first (w < 4)
// or second half of the chunk's k-steps; the halves are added in that
// order through shared memory.
constexpr int STATE_THREADS = 256;

__global__ void __launch_bounds__(STATE_THREADS, 2)
ssd_scan_chunk_state_kernel(const bf16* __restrict__ x,
                            const float* __restrict__ dt,
                            const bf16* __restrict__ Bm,
                            const float* __restrict__ acum,
                            float* __restrict__ states, int S, int H, int P,
                            int N, int Q, int Qp, int nc, ll x_sb, ll x_ss,
                            ll b_sb, ll b_ss) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ldx = P + PAD, ldb = N + PAD;
  bf16* sX = reinterpret_cast<bf16*>(smem);               // [Qp][ldx]
  bf16* sB = sX + Qp * ldx;                               // [Qp][ldb]
  float* sRed = reinterpret_cast<float*>(sB + Qp * ldb);  // [P][N]
  float* s_a = sRed + P * N;                              // [Qp]
  float* s_w = s_a + Qp;              // [Qp]: dt, then exp(a_last - a) dt
  const int s0 = c * Q, valid = min(Q, S - s0);
  load_rows<STATE_THREADS>(sX, ldx, x, x + b * x_sb + s0 * x_ss + h * P,
                           x_ss, Qp, valid, P);
  load_rows<STATE_THREADS>(sB, ldb, Bm, Bm + b * b_sb + s0 * b_ss, b_ss, Qp,
                           valid, N);
  const float* db = dt + (static_cast<ll>(b) * S + s0) * H + h;
  const float* ab = acum + ((static_cast<ll>(b) * H + h) * nc + c) * Qp;
  for (int j = tid; j < Qp; j += STATE_THREADS) {
    cp4(s_a + j, ab + j, true);
    cp4(s_w + j, j < valid ? db + static_cast<ll>(j) * H : dt, j < valid);
  }
  cp_wait_all();
  __syncthreads();
  const float a_last = s_a[Q - 1];
  for (int j = tid; j < Qp; j += STATE_THREADS)
    s_w[j] = expf(a_last - s_a[j]) * s_w[j];      // 0 past the sequence
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int m0 = (warp & 3) * 16, kh = warp >> 2;
  const int nk = Qp / 16, k_mid = (nk + 1) / 2 * 16;
  const int k_lo = kh ? k_mid : 0, k_hi = kh ? Qp : k_mid;
  const bool live = m0 < P;
  float acc[PNMAX / 8][4];
  zero(acc);
  if (live) {
    for (int k0 = k_lo; k0 < k_hi; k0 += 16) {
      // A[p][j] = x_j[p] w_j: x is stored [j][p], read transposed
      uint32_t a[4], ahi[4], amid[4], alo[4];
      ldsm_x4_t(a, sX + (k0 + (mi >> 1) * 8 + r8) * ldx + m0 + (mi & 1) * 8);
      const float2 wlo = *reinterpret_cast<const float2*>(s_w + k0 + 2 * q);
      const float2 whi =
          *reinterpret_cast<const float2*>(s_w + k0 + 8 + 2 * q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 xv = unpack(a[i]);
        const float2 w = i < 2 ? wlo : whi;
        split3(xv.x * w.x, xv.y * w.y, ahi[i], amid[i], alo[i]);
      }
#pragma unroll
      for (int nn = 0; nn < PNMAX; nn += 16) {
        if (nn < N) {
          uint32_t bq[4];
          // B[j][n] = B_j[n], stored [j][n]: read transposed
          ldsm_x4_t(bq, sB + (k0 + (mi & 1) * 8 + r8) * ldb + nn +
                            (mi >> 1) * 8);
          mma(acc[nn / 8], ahi, bq[0], bq[1]);
          mma(acc[nn / 8], amid, bq[0], bq[1]);
          mma(acc[nn / 8], alo, bq[0], bq[1]);
          mma(acc[nn / 8 + 1], ahi, bq[2], bq[3]);
          mma(acc[nn / 8 + 1], amid, bq[2], bq[3]);
          mma(acc[nn / 8 + 1], alo, bq[2], bq[3]);
        }
      }
    }
  }
  if (live && kh == 1) {
#pragma unroll
    for (int nt = 0; nt < PNMAX / 8; ++nt) {
      if (nt * 8 < N) {
        const int n = nt * 8 + 2 * q;
        *reinterpret_cast<float2*>(sRed + (m0 + g) * N + n) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(sRed + (m0 + g + 8) * N + n) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
  }
  __syncthreads();
  if (!live || kh == 1) return;
  float* st = states + ((static_cast<ll>(b) * nc + c) * H + h) * P * N;
#pragma unroll
  for (int nt = 0; nt < PNMAX / 8; ++nt) {
    if (nt * 8 < N) {
      const int n = nt * 8 + 2 * q;
      const float2 u = *reinterpret_cast<const float2*>(sRed + (m0 + g) * N +
                                                        n);
      const float2 v = *reinterpret_cast<const float2*>(
          sRed + (m0 + g + 8) * N + n);
      *reinterpret_cast<float2*>(st + (m0 + g) * N + n) =
          make_float2(acc[nt][0] + u.x, acc[nt][1] + u.y);
      *reinterpret_cast<float2*>(st + (m0 + g + 8) * N + n) =
          make_float2(acc[nt][2] + v.x, acc[nt][3] + v.y);
    }
  }
}

// 3. h_c = exp(a_last) h_{c-1} + local_c, from h0 (or zeros); states
// becomes the state entering each chunk, h_final the last.  Four elements
// a thread; the local states of four chunks are loaded before any of them
// is overwritten.
__global__ void ssd_scan_state_pass_kernel(const float* __restrict__ acum,
                                           const float* __restrict__ h0,
                                           float* __restrict__ states,
                                           float* __restrict__ h_final, int H,
                                           int PN, int Q, int Qp, int nc) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const ll bh = static_cast<ll>(b) * H + h;
  float hv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) hv[i] = h0 != nullptr ? h0[bh * PN + e + i] : 0.f;
  const float* al = acum + bh * nc * Qp + (Q - 1);
  float* sb = states + (static_cast<ll>(b) * nc * H + h) * PN + e;
  const ll cstride = static_cast<ll>(H) * PN;
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float4 local[4];
    float decay[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (c0 + i < nc) {
        local[i] = *reinterpret_cast<const float4*>(sb + (c0 + i) * cstride);
        decay[i] = expf(al[static_cast<ll>(c0 + i) * Qp]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (c0 + i < nc) {
        *reinterpret_cast<float4*>(sb + (c0 + i) * cstride) =
            make_float4(hv[0], hv[1], hv[2], hv[3]);
        hv[0] = hv[0] * decay[i] + local[i].x;
        hv[1] = hv[1] * decay[i] + local[i].y;
        hv[2] = hv[2] * decay[i] + local[i].z;
        hv[3] = hv[3] * decay[i] + local[i].w;
      }
    }
  }
  *reinterpret_cast<float4*>(h_final + bh * PN + e) =
      make_float4(hv[0], hv[1], hv[2], hv[3]);
}

// 4. y = exp(a_t) (C_t . h_in) + sum_{j <= t} CB[t][j] exp(a_t - a_j) dt_j
// x_j + D x_t for one (b, c, h).  Warp w owns the 16-row tiles w and
// 15 - w.  x arrives in two cp.async groups: rows up to 128, which the
// first tiles need, then the rest, while the first tiles compute.
constexpr int OUT_THREADS = 256;
constexpr int OUT_FIRST_ROWS = 128;

__global__ void __launch_bounds__(OUT_THREADS, 2)
ssd_scan_output_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const bf16* __restrict__ Cm,
                       const float* __restrict__ Dv,
                       const float* __restrict__ acum,
                       const float* __restrict__ cb,
                       const float* __restrict__ states,
                       bf16* __restrict__ y, int S, int H, int P, int N, int Q,
                       int Qp, int nc, ll x_sb, ll x_ss, ll c_sb, ll c_ss) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ldx = P + PAD, ldc = N + PAD;
  bf16* sX = reinterpret_cast<bf16*>(smem);          // [Qp][ldx]
  bf16* sC = sX + Qp * ldx;                          // [Qp][ldc]
  bf16* sHh = sC + Qp * ldc;                         // [P][ldc], hi
  bf16* sHl = sHh + P * ldc;                         // [P][ldc], lo
  float* s_a = reinterpret_cast<float*>(sHl + P * ldc);   // [Qp]
  float* s_dt = s_a + Qp;                                  // [Qp]
  // the entering state in fp32 [P][N] as it lands, then the column
  // decays sE [Qp / 16][Qp]
  float* sE = s_dt + Qp;
  const int s0 = c * Q, valid = min(Q, S - s0);
  const int q1 = min(Qp, OUT_FIRST_ROWS);
  const bf16* x0 = x + b * x_sb + s0 * x_ss + h * P;
  // every load of the prologue in flight at once: C, the state, a, dt
  // and the first rows of x, then the rest of x
  load_rows<OUT_THREADS>(sC, ldc, Cm, Cm + b * c_sb + s0 * c_ss, c_ss, Qp,
                         valid, N);
  const ll bch = (static_cast<ll>(b) * nc + c) * H + h;
  const float* hin = states + bch * P * N;
  for (int e = tid * 4; e < P * N; e += OUT_THREADS * 4)
    cp16(sE + e, hin + e, true);
  const float* ab = acum + ((static_cast<ll>(b) * H + h) * nc + c) * Qp;
  const float* db = dt + (static_cast<ll>(b) * S + s0) * H + h;
  for (int j = tid; j < Qp; j += OUT_THREADS) {
    cp4(s_a + j, ab + j, true);
    cp4(s_dt + j, j < valid ? db + static_cast<ll>(j) * H : dt, j < valid);
  }
  load_rows<OUT_THREADS>(sX, ldx, x, x0, x_ss, q1, valid, P);
  cp_commit();
  load_rows<OUT_THREADS>(sX + q1 * ldx, ldx, x, x0 + q1 * x_ss, x_ss,
                         Qp - q1, valid - q1, P);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  // the state as bf16 hi + lo
  for (int e = tid * 4; e < P * N; e += OUT_THREADS * 4) {
    const float4 v = *reinterpret_cast<const float4*>(sE + e);
    const int p = e / N, n = e - p * N;
    uint32_t hi[2], lo[2];
    split(v.x, v.y, hi[0], lo[0]);
    split(v.z, v.w, hi[1], lo[1]);
    *reinterpret_cast<uint2*>(sHh + p * ldc + n) = make_uint2(hi[0], hi[1]);
    *reinterpret_cast<uint2*>(sHl + p * ldc + n) = make_uint2(lo[0], lo[1]);
  }
  __syncthreads();
  // below the diagonal tile of 16-row tile m: exp(a_t - a_j) = exp(a_t -
  // a_16m) exp(a_16m - a_j), both exponents <= 0; sE[m][j] = exp(a_16m -
  // a_j) dt_j for j < 16 m
  for (int e = tid; e < Qp * Qp / 16; e += OUT_THREADS) {
    const int m = e / Qp, j = e - m * Qp;
    if (j < 16 * m) sE[e] = expf(s_a[16 * m] - s_a[j]) * s_dt[j];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const float d_h = Dv[h];
  const float* cbb = cb + (static_cast<ll>(b) * nc + c) * Qp * Qp;
  bf16* yb = y + (static_cast<ll>(b) * S + s0) * H * P + h * P;
  for (int half = 0; half < 2; ++half) {
    if (half == 1) {     // the rest of x
      cp_wait<0>();
      __syncthreads();
    }
    const int t0 = (half == 0 ? warp : 15 - warp) * 16;
    if (t0 >= Qp) continue;
    float acc[PNMAX / 8][4];
    zero(acc);
    // inter-chunk: C_t . h_in, h_in as hi + lo
#pragma unroll
    for (int kk = 0; kk < PNMAX; kk += 16) {
      if (kk >= N) break;
      uint32_t a[4];
      ldsm_x4(a, sC + (t0 + (mi & 1) * 8 + r8) * ldc + kk + (mi >> 1) * 8);
#pragma unroll
      for (int np = 0; np < PNMAX; np += 16) {
        if (np < P) {
          // B[n][p] = h_in[p][n], stored [p][n]: column-major
          const int off = (np + (mi >> 1) * 8 + r8) * ldc + kk + (mi & 1) * 8;
          uint32_t bh[4], bl[4];
          ldsm_x4(bh, sHh + off);
          ldsm_x4(bl, sHl + off);
          mma(acc[np / 8], a, bh[0], bh[1]);
          mma(acc[np / 8], a, bl[0], bl[1]);
          mma(acc[np / 8 + 1], a, bh[2], bh[3]);
          mma(acc[np / 8 + 1], a, bl[2], bl[3]);
        }
      }
    }
    const int tA = t0 + g, tB = tA + 8;
    const float aA = s_a[tA], aB = s_a[tB], a0 = s_a[t0];
    {
      const float eA = expf(aA), eB = expf(aB);
#pragma unroll
      for (int nt = 0; nt < PNMAX / 8; ++nt) {
        acc[nt][0] *= eA;
        acc[nt][1] *= eA;
        acc[nt][2] *= eB;
        acc[nt][3] *= eB;
      }
    }
    // intra-chunk: W[t][j] = CB[t][j] exp(a_t - a_j) dt_j for j <= t (the
    // exponent is taken only there: a falls, so it is <= 0), times x_j;
    // below the diagonal tile from the row factor and sE
    const float rA = expf(aA - a0), rB = expf(aB - a0);
    const float* eRow = sE + (t0 / 16) * Qp + 2 * q;
    const float* cbA = cbb + static_cast<ll>(tA) * Qp + 2 * q;
    const float* cbB = cbA + 8 * Qp;
    float2 nx1[4], nx2[4];
    auto load_cb = [&](float2 (&dst)[4], int k0) {
      if (k0 > t0) return;
      dst[0] = *reinterpret_cast<const float2*>(cbA + k0);
      dst[1] = *reinterpret_cast<const float2*>(cbB + k0);
      dst[2] = *reinterpret_cast<const float2*>(cbA + k0 + 8);
      dst[3] = *reinterpret_cast<const float2*>(cbB + k0 + 8);
    };
    load_cb(nx1, 0);
    load_cb(nx2, 16);
    for (int k0 = 0; k0 <= t0; k0 += 16) {
      float2 cur[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        cur[i] = nx1[i];
        nx1[i] = nx2[i];
      }
      load_cb(nx2, k0 + 32);
      uint32_t ahi[4], amid[4], alo[4];
      if (k0 < t0) {
        const float2 col[2] = {
            *reinterpret_cast<const float2*>(eRow + k0),
            *reinterpret_cast<const float2*>(eRow + k0 + 8)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // register i: rows tA (i even) or tB, columns j + 8 (i / 2)
          const float r = (i & 1) ? rB : rA;
          split3(cur[i].x * r * col[i >> 1].x, cur[i].y * r * col[i >> 1].y,
                 ahi[i], amid[i], alo[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = (i & 1) ? tB : tA;
          const float at = (i & 1) ? aB : aA;
          const int j = k0 + 2 * q + (i >> 1) * 8;
          const float w0 =
              t >= j ? cur[i].x * expf(at - s_a[j]) * s_dt[j] : 0.f;
          const float w1 = t >= j + 1
                               ? cur[i].y * expf(at - s_a[j + 1]) *
                                     s_dt[j + 1]
                               : 0.f;
          split3(w0, w1, ahi[i], amid[i], alo[i]);
        }
      }
#pragma unroll
      for (int np = 0; np < PNMAX; np += 16) {
        if (np < P) {
          uint32_t bq[4];
          // B[j][p] = x_j[p], stored [j][p]: read transposed
          ldsm_x4_t(bq, sX + (k0 + (mi & 1) * 8 + r8) * ldx + np +
                            (mi >> 1) * 8);
          mma(acc[np / 8], ahi, bq[0], bq[1]);
          mma(acc[np / 8], amid, bq[0], bq[1]);
          mma(acc[np / 8], alo, bq[0], bq[1]);
          mma(acc[np / 8 + 1], ahi, bq[2], bq[3]);
          mma(acc[np / 8 + 1], amid, bq[2], bq[3]);
          mma(acc[np / 8 + 1], alo, bq[2], bq[3]);
        }
      }
    }
    // the D skip; rows inside the chunk and the sequence
#pragma unroll
    for (int nt = 0; nt < PNMAX / 8; ++nt) {
      if (nt * 8 >= P) continue;
      const int p = nt * 8 + 2 * q;
      if (tA < valid) {
        const float2 xv = unpack(
            *reinterpret_cast<const uint32_t*>(sX + tA * ldx + p));
        *reinterpret_cast<__nv_bfloat162*>(yb + static_cast<ll>(tA) * H * P +
                                           p) =
            __floats2bfloat162_rn(acc[nt][0] + xv.x * d_h,
                                  acc[nt][1] + xv.y * d_h);
      }
      if (tB < valid) {
        const float2 xv = unpack(
            *reinterpret_cast<const uint32_t*>(sX + tB * ldx + p));
        *reinterpret_cast<__nv_bfloat162*>(yb + static_cast<ll>(tB) * H * P +
                                           p) =
            __floats2bfloat162_rn(acc[nt][2] + xv.x * d_h,
                                  acc[nt][3] + xv.y * d_h);
      }
    }
  }
}

size_t state_smem(int P, int N, int Qp) {
  return static_cast<size_t>(Qp) * (P + PAD + N + PAD) * sizeof(bf16) +
         (static_cast<size_t>(P) * N + 2 * Qp) * sizeof(float);
}

size_t output_smem(int P, int N, int Qp) {
  const size_t table = static_cast<size_t>(Qp) * Qp / 16 >
                               static_cast<size_t>(P) * N
                           ? static_cast<size_t>(Qp) * Qp / 16
                           : static_cast<size_t>(P) * N;
  return (static_cast<size_t>(Qp) * (P + PAD + N + PAD) +
          2 * static_cast<size_t>(P) * (N + PAD)) * sizeof(bf16) +
         (2 * static_cast<size_t>(Qp) + table) * sizeof(float);
}

}  // namespace chunked

// The chunked route; acum (Bt, H, nc, Qp), cb (Bt, nc, Qp, Qp) and states
// (Bt, nc, H, P, N) are fp32 scratch the caller allocates, with nc =
// ceil(S / Q) and Qp = Q rounded up to 16.  x, B and C are bf16.
extern "C" int ssd_scan_chunked_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* D, const void* h0, void* y, void* h_final,
    void* acum, void* cb, void* states, int Bt, int S, int H, int P, int N,
    int Q, long long x_sb, long long x_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, void* stream) {
  using namespace chunked;
  auto st = static_cast<cudaStream_t>(stream);
  if (P < 16 || P > PNMAX || P % 16 || N < 16 || N > PNMAX || N % 16 ||
      Q < 1 || Q > QMAX || Q > S || Bt < 1 || Bt > 65535 || H < 1)
    return cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q, Qp = (Q + 15) / 16 * 16;
  if (nc > 65535) return cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* Bb = static_cast<const bf16*>(B);
  const auto* Cb = static_cast<const bf16*>(C);
  const auto* dtf = static_cast<const float*>(dt);
  auto* af = static_cast<float*>(acum);
  auto* cbf = static_cast<float*>(cb);
  auto* stf = static_cast<float*>(states);

  cudaError_t err;
  const int T = (Qp + 63) / 64, pairs = T * (T + 1) / 2;
  const int groups = (H + CUMSUM_HEADS - 1) / CUMSUM_HEADS;
  ssd_scan_cb_kernel<<<dim3(pairs + groups, nc, Bt), 128, 0, st>>>(
      Bb, Cb, dtf, static_cast<const float*>(A), cbf, af, S, H, N, Q, Qp,
      nc, pairs, b_sb, b_ss, c_sb, c_ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t s_state = state_smem(P, N, Qp);
  err = cudaFuncSetAttribute(ssd_scan_chunk_state_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s_state));
  if (err != cudaSuccess) return err;
  ssd_scan_chunk_state_kernel<<<dim3(H, nc, Bt), STATE_THREADS, s_state,
                                st>>>(xb, dtf, Bb, af, stf, S, H, P, N, Q,
                                      Qp, nc, x_sb, x_ss, b_sb, b_ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int PN = P * N;
  ssd_scan_state_pass_kernel<<<dim3((PN / 4 + 255) / 256, H, Bt), 256, 0,
                               st>>>(
      af, static_cast<const float*>(h0), stf, static_cast<float*>(h_final), H,
      PN, Q, Qp, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t s_out = output_smem(P, N, Qp);
  err = cudaFuncSetAttribute(ssd_scan_output_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s_out));
  if (err != cudaSuccess) return err;
  ssd_scan_output_kernel<<<dim3(H, nc, Bt), OUT_THREADS, s_out, st>>>(
      xb, dtf, Cb, static_cast<const float*>(D), af, cbf, stf,
      static_cast<bf16*>(y), S, H, P, N, Q, Qp, nc, x_sb, x_ss, c_sb, c_ss);
  return cudaGetLastError();
}
