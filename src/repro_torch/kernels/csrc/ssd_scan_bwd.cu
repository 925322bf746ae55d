// Backward of the Mamba2 SSD chunked scan (csrc/ssd_scan.cu): from the
// cotangents dy of y and dh_final of the final state, the cotangents dx,
// ddt, dA, dB, dC, dD and dh0 of the scan's inputs.
//
// Replaces autodiff of src/repro/kernels/ops.py::_ssd_jnp (body
// _ssd_jnp_body), the reference's differentiable path (its Pallas kernel
// has no VJP).  Not a TPU kernel.
//
// Bound on the H100: memory, at zamba2_2p7b's train shape (x (2, 2048, 80,
// 64) bf16, N = 64, chunk 256): x, dy and dx are 42 MB each, dt and ddt 2.6
// MB together, B, C, dB and dC 2 MB: ~0.04 ms at 3.35 TB/s.  The chunked
// form's ~40 GFLOP would take as long at the bf16 tensor-core peak; this
// first design does them in fp32 on the CUDA cores (67 TFLOP/s at most),
// so the products, not the bytes, pace it.
//
// Design: right and simple first.  Every product is a 64 x 64 fp32 tile
// product in shared memory on the CUDA cores (256 threads, each a 4 x 4
// patch), as the forward's scalar route does; one design serves bf16 and
// fp32 x, B, C and dy (read through their (batch, sequence) strides; all
// arithmetic in fp32).  The backward recomputes what it needs (the
// cumulative sums a, C.B^T, the entering states) from the inputs, so it
// does not depend on which forward route ran.  a is summed exactly as the
// forward sums it: in sequence order by one thread, each product and sum
// rounded on its own (no FMA), so the decay weights are the forward's bit
// for bit.  Seven device kernels, all chunks in parallel; no atomics, and
// every sum in a fixed order, so two calls give the same bits:
//   1. bwd_chunk (batch, chunk, head): a -> acum; the chunk's state from
//      zero, sum_j exp(a_Q - a_j) dt_j x_j B_j^T -> hs; and its share of
//      the entering state's cotangent, sum_t exp(a_t) dy_t C_t^T -> gs;
//   2. bwd_state (batch, head, 1024 of the P x N state elements): the
//      entering states forward from h0 (hs becomes h_in) and, in reverse
//      from dh_final, the cotangent G_c of the state leaving chunk c (gs
//      becomes G); dh0; each block's share of the state's term of da at
//      the chunk's last row, exp(a_Q) <G_c, h_in_c>;
//   3. bwd_cb (batch, chunk, 64 x 64 tile pair on and below the diagonal):
//      C.B^T once -> cb; then over the heads in order, dW = dy_t . x_j and
//      dCB = sum_h dW exp(a_t - a_j) dt_j (the exponent taken only where t
//      >= j) -> dcb, with each head's row and column sums of M = CB exp(a_t
//      - a_j) dt_j dW (the intra-chunk share of da) and the column sums of
//      CB exp(a_t - a_j) dW (of ddt) -> mpart;
//   4. bwd_dx (batch, chunk, head): dx_j = sum_{t >= j} W[t, j] dy_t +
//      exp(a_Q - a_j) dt_j (G B_j) + D dy_j, W = CB exp(a_t - a_j) dt_j;
//   5. bwd_dbc (batch, chunk, 64-row tile, group of heads): over the
//      group's heads in order, dC += exp(a_t) dy_t h_in and dB +=
//      exp(a_Q - a_j) dt_j x_j G, with each head's dot products with C_t
//      and B_j (the inter-chunk and state shares of da); group 0 adds
//      dC += dCB B and dB += dCB^T C -> one fp32 partial per group;
//   6. bwd_da (batch, chunk, head): da per row from mpart (summed over the
//      tile pairs in order), the inter-chunk and state shares; its reverse
//      sum in the chunk, d(dt A)_j = sum_{t >= j} da_t (one thread, in
//      order), gives ddt and this chunk's share of dA; and its share of
//      dD, sum dy x;
//   7. bwd_sum: dB and dC, the groups' partials summed in order; dA and dD,
//      the chunks' shares summed in order.
// The heads are summed by blocks that loop over them (3, 5), not by
// atomics.  Tensor cores, wgmma and pipelining are later work (ROADMAP.md
// queue 2b).
#include "common.cuh"

namespace ssd_bwd {

using ll = long long;

constexpr int TILE = 64;         // rows of a chunk tile
constexpr int LD = TILE + 4;     // fp32 row of a shared tile, 16-byte rows
constexpr int THREADS = 256;     // 16 x 16, each a 4 x 4 patch of 64 x 64
constexpr int TILE_F = TILE * LD;
constexpr int MPART = 3 * TILE;  // per (head, tile pair): rows, cols, ddt
constexpr int STATE_THREADS = 256;   // bwd_state: a block's threads
constexpr int STATE_EL = 4;          // and each thread's state elements

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

// A 64 x 64 tile into shared memory, [r][c] or, with trans, [c][r]:
// element (r, c) is base[(row0 + r) * stride + c] for r < valid and c <
// cols, times rscale[r] when given, and 0 elsewhere (past the chunk, the
// sequence, P or N).  A thread's 16 loads are all issued before its first
// store: a load after a store through a generic pointer would wait for it.
constexpr int PER_THREAD = TILE * TILE / THREADS;

template <typename T>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ base,
                                          ll stride, int row0, int valid,
                                          int cols, bool trans,
                                          const float* rscale = nullptr) {
  const int c = threadIdx.x % TILE, r0 = threadIdx.x / TILE;
  float v[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int r = r0 + k * (THREADS / TILE);
    v[k] = r < valid && c < cols
               ? to_f32(base[static_cast<ll>(row0 + r) * stride + c])
               : 0.f;
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int r = r0 + k * (THREADS / TILE);
    const float x = rscale != nullptr ? v[k] * rscale[r] : v[k];
    if (trans)
      dst[c * LD + r] = x;
    else
      dst[r * LD + c] = x;
  }
}

// Sum over the 16 lanes of a half warp (the threads of one ty), the same
// order in every lane.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block, in a fixed order; the result in thread 0.  red holds
// blockDim.x / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) s += red[w];
  __syncthreads();
  return s;
}

// The work's shape and where each scratch buffer lies in the workspace.
struct Dims {
  int Bt, S, H, P, N, Q;
  int nc, nt, Qr, pairs, hg, hpg, sblk;
  ll acum, hs, gs, cb, dcb, mpart, dain, dwb, dast, dap, ddp, dbp, dcp, total;
};

__host__ __device__ inline int pair_index(int ti, int tj) {
  return ti * (ti + 1) / 2 + tj;
}

// groups of heads for bwd_dbc: enough blocks to fill the card twice over
// (132 SMs), each group summing its heads in order
inline Dims make_dims(int Bt, int S, int H, int P, int N, int Q) {
  Dims d{};
  d.Bt = Bt, d.S = S, d.H = H, d.P = P, d.N = N, d.Q = Q;
  d.nc = (S + Q - 1) / Q;
  d.nt = (Q + TILE - 1) / TILE;
  d.Qr = d.nt * TILE;
  d.pairs = d.nt * (d.nt + 1) / 2;
  d.sblk = (P * N + STATE_EL * STATE_THREADS - 1) / (STATE_EL * STATE_THREADS);
  const ll tiles = static_cast<ll>(d.nt) * d.nc * Bt;
  ll want = (264 + tiles - 1) / tiles;
  if (want > H) want = H;
  if (want < 1) want = 1;
  d.hpg = static_cast<int>((H + want - 1) / want);
  d.hg = (H + d.hpg - 1) / d.hpg;
  const ll bch = static_cast<ll>(Bt) * d.nc * H;
  const ll PN = static_cast<ll>(P) * N;
  ll off = 0;
  auto take = [&](ll n) {
    const ll at = off;
    off += (n + 3) / 4 * 4;      // 16-byte aligned buffers
    return at;
  };
  d.acum = take(bch * d.Qr);
  d.hs = take(bch * PN);
  d.gs = take(bch * PN);
  d.cb = take(static_cast<ll>(Bt) * d.nc * d.Qr * d.Qr);
  d.dcb = take(static_cast<ll>(Bt) * d.nc * d.Qr * d.Qr);
  d.mpart = take(bch * d.pairs * MPART);
  d.dain = take(bch * d.Qr);
  d.dwb = take(bch * d.Qr);
  d.dast = take(bch * d.sblk);
  d.dap = take(bch);
  d.ddp = take(bch);
  d.dbp = take(static_cast<ll>(d.hg) * Bt * S * N);
  d.dcp = take(static_cast<ll>(d.hg) * Bt * S * N);
  d.total = off;
  return d;
}

// Strides: x, B, C by (batch, sequence) as given; dy contiguous (Bt, S, H,
// P); dt contiguous (Bt, S, H).
struct Strides {
  ll x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
};

// ---------------------------------------------------------------- 1. chunk

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, const T* __restrict__ dy,
                 float* __restrict__ ws, Dims d, Strides st) {
  extern __shared__ __align__(16) float smem[];
  float* sX = smem;                 // [j][p] x_j w_j
  float* sB = sX + TILE_F;          // [j][n]
  float* sDy = sB + TILE_F;         // [t][p] dy_t exp(a_t)
  float* sC = sDy + TILE_F;         // [t][n]
  float* s_dt = sC + TILE_F;        // Qr
  float* s_a = s_dt + d.Qr;         // Qr
  float* s_w = s_a + d.Qr;          // Qr: exp(a_Q - a_j) dt_j
  float* s_e = s_w + d.Qr;          // Qr: exp(a_t)
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int s0 = c * d.Q, valid = min(d.Q, d.S - s0);
  for (int r = tid; r < d.Qr; r += THREADS)
    s_dt[r] = r < valid ? dt[(static_cast<ll>(b) * d.S + s0 + r) * d.H + h]
                        : 0.f;
  __syncthreads();
  float* acum = ws + d.acum + ((static_cast<ll>(b) * d.H + h) * d.nc + c) *
                                  d.Qr;
  if (tid == 0) {
    // in sequence order, each product and sum rounded on its own (no
    // FMA), as the forward takes them; 16 values read before any is
    // written (Qr is a multiple of 64)
    const float a_h = A[h];
    float run = 0.f;
    for (int r0 = 0; r0 < d.Qr; r0 += 16) {
      float v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = s_dt[r0 + u];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        run = __fadd_rn(run, __fmul_rn(v[u], a_h));
        s_a[r0 + u] = run;
      }
    }
  }
  __syncthreads();
  const float a_last = s_a[d.Q - 1];
  for (int r = tid; r < d.Qr; r += THREADS) {
    acum[r] = s_a[r];
    s_w[r] = r < d.Q ? expf(a_last - s_a[r]) * s_dt[r] : 0.f;
    s_e[r] = r < d.Q ? expf(s_a[r]) : 0.f;
  }
  __syncthreads();
  const T* xb = x + b * st.x_sb + static_cast<ll>(h) * d.P;
  const T* dyb = dy + static_cast<ll>(b) * d.S * d.H * d.P +
                 static_cast<ll>(h) * d.P;
  const ll dy_ss = static_cast<ll>(d.H) * d.P;
  float loc[4][4], dyc[4][4];
  zero(loc);
  zero(dyc);
  for (int k0 = 0; k0 < d.Qr; k0 += TILE) {
    load_tile(sX, xb, st.x_ss, s0 + k0, valid - k0, d.P, false, s_w + k0);
    load_tile(sB, Bm + b * st.b_sb, st.b_ss, s0 + k0, valid - k0, d.N, false);
    load_tile(sDy, dyb, dy_ss, s0 + k0, valid - k0, d.P, false, s_e + k0);
    load_tile(sC, Cm + b * st.c_sb, st.c_ss, s0 + k0, valid - k0, d.N, false);
    __syncthreads();
    tile_mma(loc, sX, sB, TILE, ty, tx);     // [p][n]
    tile_mma(dyc, sDy, sC, TILE, ty, tx);    // [p][n]
    __syncthreads();
  }
  const ll PN = static_cast<ll>(d.P) * d.N;
  const ll o = ((static_cast<ll>(b) * d.nc + c) * d.H + h) * PN;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = ty * 4 + r;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int n = tx * 4 + cc;
      if (p < d.P && n < d.N) {
        ws[d.hs + o + p * d.N + n] = loc[r][cc];
        ws[d.gs + o + p * d.N + n] = dyc[r][cc];
      }
    }
  }
}

// ---------------------------------------------------------------- 2. state

// Four state elements a thread, STATE_THREADS threads a block, blocks
// over P x N (as the forward's state pass); four chunks' values are loaded
// before any of them is stored.

__global__ void __launch_bounds__(STATE_THREADS)
bwd_state_kernel(const float* __restrict__ h0,
                 const float* __restrict__ dh_final, float* __restrict__ dh0,
                 float* __restrict__ ws, Dims d) {
  __shared__ float red[STATE_THREADS / 32];
  const int e = (blockIdx.x * STATE_THREADS + threadIdx.x) * STATE_EL;
  const int h = blockIdx.y, b = blockIdx.z;
  const ll bh = static_cast<ll>(b) * d.H + h;
  const int PN = d.P * d.N;
  const float* acum = ws + d.acum + bh * d.nc * d.Qr + (d.Q - 1);
  auto at = [&](ll base, int c) {
    return ws + base + ((static_cast<ll>(b) * d.nc + c) * d.H + h) * PN + e;
  };
  float hv[STATE_EL], gv[STATE_EL];
#pragma unroll
  for (int i = 0; i < STATE_EL; ++i) {
    const bool ok = e + i < PN;
    hv[i] = ok && h0 != nullptr ? h0[bh * PN + e + i] : 0.f;
    gv[i] = ok && dh_final != nullptr ? dh_final[bh * PN + e + i] : 0.f;
  }
  // forward: hs holds each chunk's state from zero, then the state
  // entering it
  for (int c0 = 0; c0 < d.nc; c0 += 4) {
    float l[4][STATE_EL], dec[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      if (c >= d.nc) continue;
      dec[j] = expf(acum[static_cast<ll>(c) * d.Qr]);
      const float* hs = at(d.hs, c);
#pragma unroll
      for (int i = 0; i < STATE_EL; ++i) l[j][i] = e + i < PN ? hs[i] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      if (c >= d.nc) continue;
      float* hs = at(d.hs, c);
#pragma unroll
      for (int i = 0; i < STATE_EL; ++i) {
        if (e + i < PN) hs[i] = hv[i];
        hv[i] = hv[i] * dec[j] + l[j][i];
      }
    }
  }
  // reverse: gs holds each chunk's share of the entering state's
  // cotangent, then G_c, the cotangent of the state leaving it; this
  // block's share of exp(a_Q) <G_c, h_in_c> per chunk -> dast
  for (int c0 = d.nc - 1; c0 >= 0; c0 -= 4) {
    float l[4][STATE_EL], hin[4][STATE_EL], dec[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 - j;
      if (c < 0) continue;
      dec[j] = expf(acum[static_cast<ll>(c) * d.Qr]);
      const float* gs = at(d.gs, c);
      const float* hs = at(d.hs, c);
#pragma unroll
      for (int i = 0; i < STATE_EL; ++i) {
        l[j][i] = e + i < PN ? gs[i] : 0.f;
        hin[j][i] = e + i < PN ? hs[i] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 - j;
      if (c < 0) continue;
      float* gs = at(d.gs, c);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < STATE_EL; ++i) {
        if (e + i < PN) gs[i] = gv[i];
        dot += gv[i] * hin[j][i];
        gv[i] = gv[i] * dec[j] + l[j][i];
      }
      dot = block_sum(dot, red);
      if (threadIdx.x == 0)
        ws[d.dast + (bh * d.nc + c) * d.sblk + blockIdx.x] = dec[j] * dot;
    }
  }
#pragma unroll
  for (int i = 0; i < STATE_EL; ++i)
    if (e + i < PN) dh0[bh * PN + e + i] = gv[i];
}

// ------------------------------------------------------------------ 3. cb

// two blocks an SM: the train shape's 160 blocks in one wave
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
bwd_cb_kernel(const T* __restrict__ x, const float* __restrict__ dt,
              const T* __restrict__ Bm, const T* __restrict__ Cm,
              const T* __restrict__ dy, float* __restrict__ ws, Dims d,
              Strides st) {
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                  // [k][t]: C^T, then dy^T of a head
  float* sB = sA + TILE_F;           // [k][j]: B^T, then x^T of a head
  float* red = sB + TILE_F;          // [2][16][64]: column sums by ty
  float* s_at = red + 2 * 16 * TILE; // 64: a of rows t
  float* s_aj = s_at + TILE;         // 64: a of columns j
  float* s_dtj = s_aj + TILE;        // 64: dt of columns j
  int p = blockIdx.x, ti = 0;
  while (p > ti) p -= ++ti;
  const int tj = p;
  const int c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = ti * TILE, j0 = tj * TILE;
  const int s0 = c * d.Q, valid = min(d.Q, d.S - s0);
  load_tile(sA, Cm + b * st.c_sb, st.c_ss, s0 + t0, valid - t0, d.N, true);
  load_tile(sB, Bm + b * st.b_sb, st.b_ss, s0 + j0, valid - j0, d.N, true);
  __syncthreads();
  float cbv[4][4];
  zero(cbv);
  tile_mma(cbv, sA, sB, d.N, ty, tx);
  const ll tile_o = (static_cast<ll>(b) * d.nc + c) * d.Qr * d.Qr;
  float* cbg = ws + d.cb + tile_o;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      cbg[static_cast<ll>(t0 + ty * 4 + r) * d.Qr + j0 + tx * 4 + cc] =
          cbv[r][cc];
  __syncthreads();
  const T* dyb = dy + static_cast<ll>(b) * d.S * d.H * d.P;
  const T* xb = x + b * st.x_sb;
  const ll dy_ss = static_cast<ll>(d.H) * d.P;
  float dcb[4][4];
  zero(dcb);
  for (int h = 0; h < d.H; ++h) {
    load_tile(sA, dyb + static_cast<ll>(h) * d.P, dy_ss, s0 + t0, valid - t0,
              d.P, true);
    load_tile(sB, xb + static_cast<ll>(h) * d.P, st.x_ss, s0 + j0,
              valid - j0, d.P, true);
    const float* acum =
        ws + d.acum + ((static_cast<ll>(b) * d.H + h) * d.nc + c) * d.Qr;
    if (tid < TILE) {
      s_at[tid] = acum[t0 + tid];
      s_aj[tid] = acum[j0 + tid];
      s_dtj[tid] = j0 + tid < valid
                       ? dt[(static_cast<ll>(b) * d.S + s0 + j0 + tid) * d.H + h]
                       : 0.f;
    }
    __syncthreads();
    float dW[4][4];
    zero(dW);
    tile_mma(dW, sA, sB, d.P, ty, tx);
    float rowm[4] = {0.f, 0.f, 0.f, 0.f}, colm[4] = {0.f, 0.f, 0.f, 0.f},
          colq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = t0 + ty * 4 + r;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = j0 + tx * 4 + cc;
        if (t >= j) {
          const float dwl =
              dW[r][cc] * expf(s_at[ty * 4 + r] - s_aj[tx * 4 + cc]);
          const float dtj = s_dtj[tx * 4 + cc];
          dcb[r][cc] += dwl * dtj;
          const float q = cbv[r][cc] * dwl;
          const float m = q * dtj;
          rowm[r] += m;
          colm[cc] += m;
          colq[cc] += q;
        }
      }
    }
    float* mp = ws + d.mpart +
                (((static_cast<ll>(b) * d.nc + c) * d.H + h) * d.pairs +
                 blockIdx.x) * MPART;
#pragma unroll
    for (int r = 0; r < 4; ++r) rowm[r] = half_warp_sum(rowm[r]);
    if (tx == 0)
#pragma unroll
      for (int r = 0; r < 4; ++r) mp[ty * 4 + r] = rowm[r];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      red[ty * TILE + tx * 4 + cc] = colm[cc];
      red[16 * TILE + ty * TILE + tx * 4 + cc] = colq[cc];
    }
    __syncthreads();
    if (tid < 2 * TILE) {
      const int k = tid / TILE, j = tid % TILE;
      float s = 0.f;
      for (int y = 0; y < 16; ++y) s += red[k * 16 * TILE + y * TILE + j];
      mp[(1 + k) * TILE + j] = s;
    }
    __syncthreads();
  }
  float* dcbg = ws + d.dcb + tile_o;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      dcbg[static_cast<ll>(t0 + ty * 4 + r) * d.Qr + j0 + tx * 4 + cc] =
          dcb[r][cc];
}

// ------------------------------------------------------------------ 4. dx

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dx_kernel(const float* __restrict__ dt, const T* __restrict__ Bm,
              const float* __restrict__ Dv, const T* __restrict__ dy,
              T* __restrict__ dx, const float* __restrict__ ws, Dims d,
              Strides st) {
  extern __shared__ __align__(16) float smem[];
  float* sW = smem;                 // [t][j] the masked weights
  float* sDy = sW + TILE_F;         // [t][p]
  float* sBt = sDy + TILE_F;        // [n][j]
  float* sGt = sBt + TILE_F;        // [n][p]
  float* s_a = sGt + TILE_F;        // Qr
  float* s_dt = s_a + d.Qr;         // Qr
  float* s_w = s_dt + d.Qr;         // Qr
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int s0 = c * d.Q, valid = min(d.Q, d.S - s0);
  const float* acum =
      ws + d.acum + ((static_cast<ll>(b) * d.H + h) * d.nc + c) * d.Qr;
  for (int r = tid; r < d.Qr; r += THREADS) {
    s_a[r] = acum[r];
    s_dt[r] = r < valid ? dt[(static_cast<ll>(b) * d.S + s0 + r) * d.H + h]
                        : 0.f;
  }
  const ll PN = static_cast<ll>(d.P) * d.N;
  load_tile(sGt, ws + d.gs + ((static_cast<ll>(b) * d.nc + c) * d.H + h) * PN,
            d.N, 0, d.P, d.N, true);
  __syncthreads();
  const float a_last = s_a[d.Q - 1];
  for (int r = tid; r < d.Qr; r += THREADS)
    s_w[r] = r < d.Q ? expf(a_last - s_a[r]) * s_dt[r] : 0.f;
  const float* cbg = ws + d.cb + (static_cast<ll>(b) * d.nc + c) * d.Qr * d.Qr;
  const T* dyb = dy + static_cast<ll>(b) * d.S * d.H * d.P +
                 static_cast<ll>(h) * d.P;
  const ll dy_ss = static_cast<ll>(d.H) * d.P;
  const float d_h = Dv[h];
  for (int tj = 0; tj < d.nt; ++tj) {
    const int j0 = tj * TILE;
    load_tile(sBt, Bm + b * st.b_sb, st.b_ss, s0 + j0, valid - j0, d.N, true);
    __syncthreads();
    // the state term: exp(a_Q - a_j) dt_j sum_n B_j[n] G[p][n]
    float acc[4][4], tmp[4][4];
    zero(tmp);
    tile_mma(tmp, sBt, sGt, d.N, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        acc[r][cc] = s_w[j0 + ty * 4 + r] * tmp[r][cc];
    for (int ti = tj; ti < d.nt; ++ti) {
      const int t0 = ti * TILE;
      {
        const int jl = tid % TILE, r0 = tid / TILE, j = j0 + jl;
        float v[PER_THREAD];
#pragma unroll
        for (int k = 0; k < PER_THREAD; ++k)
          v[k] = cbg[static_cast<ll>(t0 + r0 + k * (THREADS / TILE)) * d.Qr +
                     j];
#pragma unroll
        for (int k = 0; k < PER_THREAD; ++k) {
          const int tl = r0 + k * (THREADS / TILE), t = t0 + tl;
          sW[tl * LD + jl] =
              t >= j ? v[k] * expf(s_a[t] - s_a[j]) * s_dt[j] : 0.f;
        }
      }
      load_tile(sDy, dyb, dy_ss, s0 + t0, valid - t0, d.P, false);
      __syncthreads();
      tile_mma(acc, sW, sDy, TILE, ty, tx);   // sum_t W[t][j] dy_t[p]
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ty * 4 + r;
      if (j >= valid) continue;
      const ll row = (static_cast<ll>(b) * d.S + s0 + j) * d.H * d.P +
                     static_cast<ll>(h) * d.P;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int p = tx * 4 + cc;
        if (p < d.P)
          dx[row + p] = from_f32<T>(acc[r][cc] + d_h * to_f32(dy[row + p]));
      }
    }
  }
}

// ------------------------------------------------------------- 5. dB, dC

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dbc_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ Bm, const T* __restrict__ Cm,
               const T* __restrict__ dy, float* __restrict__ ws, Dims d,
               Strides st) {
  extern __shared__ __align__(16) float smem[];
  float* sDyT = smem;               // [p][t]
  float* sXT = sDyT + TILE_F;       // [p][j]
  float* sHin = sXT + TILE_F;       // [p][n]
  float* sG = sHin + TILE_F;        // [p][n]
  float* sC = sG + TILE_F;          // [t][n]
  float* sB = sC + TILE_F;          // [j][n]
  float* s_e = sB + TILE_F;         // 64: exp(a_t)
  float* s_w = s_e + TILE;          // 64: exp(a_Q - a_j) dt_j
  const int rt = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / d.hg, g = blockIdx.z % d.hg;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = rt * TILE;
  const int s0 = c * d.Q, valid = min(d.Q, d.S - s0);
  const int h_lo = g * d.hpg, h_hi = min(d.H, h_lo + d.hpg);
  load_tile(sC, Cm + b * st.c_sb, st.c_ss, s0 + t0, valid - t0, d.N, false);
  load_tile(sB, Bm + b * st.b_sb, st.b_ss, s0 + t0, valid - t0, d.N, false);
  const T* dyb = dy + static_cast<ll>(b) * d.S * d.H * d.P;
  const T* xb = x + b * st.x_sb;
  const ll dy_ss = static_cast<ll>(d.H) * d.P;
  const ll PN = static_cast<ll>(d.P) * d.N;
  float dC[4][4], dB[4][4];
  zero(dC);
  zero(dB);
  for (int h = h_lo; h < h_hi; ++h) {
    const ll bch = (static_cast<ll>(b) * d.nc + c) * d.H + h;
    load_tile(sDyT, dyb + static_cast<ll>(h) * d.P, dy_ss, s0 + t0,
              valid - t0, d.P, true);
    load_tile(sXT, xb + static_cast<ll>(h) * d.P, st.x_ss, s0 + t0,
              valid - t0, d.P, true);
    load_tile(sHin, ws + d.hs + bch * PN, d.N, 0, d.P, d.N, false);
    load_tile(sG, ws + d.gs + bch * PN, d.N, 0, d.P, d.N, false);
    if (tid < TILE) {
      const float* acum =
          ws + d.acum + ((static_cast<ll>(b) * d.H + h) * d.nc + c) * d.Qr;
      const int t = t0 + tid;
      const float dtt =
          t < valid ? dt[(static_cast<ll>(b) * d.S + s0 + t) * d.H + h] : 0.f;
      s_e[tid] = t < d.Q ? expf(acum[t]) : 0.f;
      s_w[tid] = t < d.Q ? expf(acum[d.Q - 1] - acum[t]) * dtt : 0.f;
    }
    __syncthreads();
    float U[4][4], V[4][4];
    zero(U);
    zero(V);
    tile_mma(U, sDyT, sHin, d.P, ty, tx);    // [t][n]: dy_t h_in
    tile_mma(V, sXT, sG, d.P, ty, tx);       // [j][n]: x_j G
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty * 4 + r;
      const float er = s_e[i], wr = s_w[i];
      float du = 0.f, dv = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int n = tx * 4 + cc;
        dC[r][cc] += er * U[r][cc];
        dB[r][cc] += wr * V[r][cc];
        du += sC[i * LD + n] * U[r][cc];
        dv += sB[i * LD + n] * V[r][cc];
      }
      du = half_warp_sum(du);
      dv = half_warp_sum(dv);
      if (tx == 0) {
        ws[d.dain + bch * d.Qr + t0 + i] = er * du;
        ws[d.dwb + bch * d.Qr + t0 + i] = dv;
      }
    }
    __syncthreads();
  }
  if (g == 0) {
    // the intra-chunk terms, once: dC_t += sum_{j <= t} dCB[t][j] B_j and
    // dB_j += sum_{t >= j} dCB[t][j] C_t
    const float* dcbg =
        ws + d.dcb + (static_cast<ll>(b) * d.nc + c) * d.Qr * d.Qr;
    for (int tj = 0; tj <= rt; ++tj) {
      load_tile(sDyT, dcbg + tj * TILE, d.Qr, t0, TILE, TILE, true);  // [j][t]
      load_tile(sXT, Bm + b * st.b_sb, st.b_ss, s0 + tj * TILE,
                valid - tj * TILE, d.N, false);                       // [j][n]
      __syncthreads();
      tile_mma(dC, sDyT, sXT, TILE, ty, tx);
      __syncthreads();
    }
    for (int ti = rt; ti < d.nt; ++ti) {
      load_tile(sDyT, dcbg + t0, d.Qr, ti * TILE, TILE, TILE, false); // [t][j]
      load_tile(sXT, Cm + b * st.c_sb, st.c_ss, s0 + ti * TILE,
                valid - ti * TILE, d.N, false);                       // [t][n]
      __syncthreads();
      tile_mma(dB, sDyT, sXT, TILE, ty, tx);
      __syncthreads();
    }
  }
  const ll part = (static_cast<ll>(g) * d.Bt + b) * d.S;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = t0 + ty * 4 + r;
    if (t >= valid) continue;
    const ll row = (part + s0 + t) * d.N;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int n = tx * 4 + cc;
      if (n < d.N) {
        ws[d.dcp + row + n] = dC[r][cc];
        ws[d.dbp + row + n] = dB[r][cc];
      }
    }
  }
}

// ------------------------------------------------------------------ 6. da

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_da_kernel(const T* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const T* __restrict__ dy,
              float* __restrict__ ddt, float* __restrict__ ws, Dims d,
              Strides st) {
  extern __shared__ __align__(16) float smem[];
  float* s_da = smem;               // Qr
  float* s_ddt = s_da + d.Qr;       // Qr
  float* s_wdw = s_ddt + d.Qr;      // Qr
  float* s_dt = s_wdw + d.Qr;       // Qr
  float* red = s_dt + d.Qr;         // THREADS / 32
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int s0 = c * d.Q, valid = min(d.Q, d.S - s0);
  const ll bch = (static_cast<ll>(b) * d.nc + c) * d.H + h;
  const float* acum =
      ws + d.acum + ((static_cast<ll>(b) * d.H + h) * d.nc + c) * d.Qr;
  const float* mp = ws + d.mpart + bch * d.pairs * MPART;
  const float a_last = acum[d.Q - 1];
  for (int t = tid; t < d.Q; t += THREADS) {
    const int r = t / TILE, i = t % TILE;
    float rs = 0.f, cs = 0.f, qs = 0.f;
    for (int tj = 0; tj <= r; ++tj) rs += mp[pair_index(r, tj) * MPART + i];
    for (int ti = r; ti < d.nt; ++ti) {
      const float* m = mp + pair_index(ti, r) * MPART;
      cs += m[TILE + i];
      qs += m[2 * TILE + i];
    }
    const float dtt =
        t < valid ? dt[(static_cast<ll>(b) * d.S + s0 + t) * d.H + h] : 0.f;
    const float ew = expf(a_last - acum[t]);
    const float dw = ws[d.dwb + bch * d.Qr + t];
    const float wdw = ew * dtt * dw;
    s_da[t] = (rs - cs) + ws[d.dain + bch * d.Qr + t] - wdw;
    s_ddt[t] = qs + ew * dw;
    s_wdw[t] = wdw;
    s_dt[t] = dtt;
  }
  // this chunk's share of dD: sum over its rows of dy . x
  float acc = 0.f;
  const T* xb = x + b * st.x_sb + static_cast<ll>(h) * d.P;
  const T* dyb = dy + static_cast<ll>(b) * d.S * d.H * d.P +
                 static_cast<ll>(h) * d.P;
  for (int e = tid; e < valid * d.P; e += THREADS) {
    const int r = e / d.P, p = e % d.P;
    acc += to_f32(dyb[static_cast<ll>(s0 + r) * d.H * d.P + p]) *
           to_f32(xb[static_cast<ll>(s0 + r) * st.x_ss + p]);
  }
  acc = block_sum(acc, red);       // its barriers also publish s_*
  if (tid == 0) {
    float swdw = 0.f;
    for (int t = 0; t < d.Q; ++t) swdw += s_wdw[t];
    const float* dast =
        ws + d.dast + ((static_cast<ll>(b) * d.H + h) * d.nc + c) * d.sblk;
    float da_state = 0.f;
    for (int k = 0; k < d.sblk; ++k) da_state += dast[k];
    s_da[d.Q - 1] += da_state + swdw;
    // d(dt A)_j = sum_{t >= j} da_t, in order from the chunk's end
    const float a_h = A[h];
    float run = 0.f, dap = 0.f;
    for (int t = d.Q - 1; t >= 0; --t) {
      run += s_da[t];
      s_ddt[t] += a_h * run;
      dap += s_dt[t] * run;
    }
    ws[d.dap + bch] = dap;
    ws[d.ddp + bch] = acc;
  }
  __syncthreads();
  for (int t = tid; t < valid; t += THREADS)
    ddt[(static_cast<ll>(b) * d.S + s0 + t) * d.H + h] = s_ddt[t];
}

// ----------------------------------------------------------------- 7. sum

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_sum_kernel(T* __restrict__ dB, T* __restrict__ dC,
               float* __restrict__ dA, float* __restrict__ dD,
               const float* __restrict__ ws, Dims d) {
  const ll nel = static_cast<ll>(d.Bt) * d.S * d.N;
  if (blockIdx.x + 1 < gridDim.x) {
    const ll e = static_cast<ll>(blockIdx.x) * THREADS + threadIdx.x;
    if (e >= nel) return;
    float sb = 0.f, sc = 0.f;
    for (int g = 0; g < d.hg; ++g) {
      sb += ws[d.dbp + g * nel + e];
      sc += ws[d.dcp + g * nel + e];
    }
    dB[e] = from_f32<T>(sb);
    dC[e] = from_f32<T>(sc);
    return;
  }
  for (int h = threadIdx.x; h < d.H; h += THREADS) {
    float sa = 0.f, sd = 0.f;
    for (int b = 0; b < d.Bt; ++b)
      for (int c = 0; c < d.nc; ++c) {
        const ll bch = (static_cast<ll>(b) * d.nc + c) * d.H + h;
        sa += ws[d.dap + bch];
        sd += ws[d.ddp + bch];
      }
    dA[h] = sa;
    dD[h] = sd;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, const void* D,
                   const void* h0, const void* dy, const void* dh_final,
                   void* dx, void* ddt, void* dA, void* dB, void* dC, void* dD,
                   void* dh0, void* ws, const Dims& d, const Strides& st,
                   cudaStream_t stream) {
  const auto* xt = static_cast<const T*>(x);
  const auto* Bp = static_cast<const T*>(B);
  const auto* Cp = static_cast<const T*>(C);
  const auto* dyt = static_cast<const T*>(dy);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  auto* wsf = static_cast<float*>(ws);
  const size_t tile = TILE_F * sizeof(float);
  cudaError_t err;

  const size_t s1 = 4 * tile + 4 * d.Qr * sizeof(float);
  if ((err = allow_smem(bwd_chunk_kernel<T>, s1)) != cudaSuccess) return err;
  bwd_chunk_kernel<T><<<dim3(d.H, d.nc, d.Bt), THREADS, s1, stream>>>(
      xt, dtf, Af, Bp, Cp, dyt, wsf, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  bwd_state_kernel<<<dim3(d.sblk, d.H, d.Bt), STATE_THREADS, 0, stream>>>(
      static_cast<const float*>(h0), static_cast<const float*>(dh_final),
      static_cast<float*>(dh0), wsf, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t s3 = 2 * tile + (2 * 16 * TILE + 3 * TILE) * sizeof(float);
  if ((err = allow_smem(bwd_cb_kernel<T>, s3)) != cudaSuccess) return err;
  bwd_cb_kernel<T><<<dim3(d.pairs, d.nc, d.Bt), THREADS, s3, stream>>>(
      xt, dtf, Bp, Cp, dyt, wsf, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t s4 = 4 * tile + 3 * d.Qr * sizeof(float);
  if ((err = allow_smem(bwd_dx_kernel<T>, s4)) != cudaSuccess) return err;
  bwd_dx_kernel<T><<<dim3(d.H, d.nc, d.Bt), THREADS, s4, stream>>>(
      dtf, Bp, static_cast<const float*>(D), dyt, static_cast<T*>(dx), wsf,
      d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t s5 = 6 * tile + 2 * TILE * sizeof(float);
  if ((err = allow_smem(bwd_dbc_kernel<T>, s5)) != cudaSuccess) return err;
  bwd_dbc_kernel<T><<<dim3(d.nt, d.nc, d.Bt * d.hg), THREADS, s5, stream>>>(
      xt, dtf, Bp, Cp, dyt, wsf, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t s6 = (4 * d.Qr + THREADS / 32) * sizeof(float);
  if ((err = allow_smem(bwd_da_kernel<T>, s6)) != cudaSuccess) return err;
  bwd_da_kernel<T><<<dim3(d.H, d.nc, d.Bt), THREADS, s6, stream>>>(
      xt, dtf, Af, dyt, static_cast<float*>(ddt), wsf, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const ll nel = static_cast<ll>(d.Bt) * d.S * d.N;
  const unsigned blocks = static_cast<unsigned>((nel + THREADS - 1) / THREADS);
  bwd_sum_kernel<T><<<blocks + 1, THREADS, 0, stream>>>(
      static_cast<T*>(dB), static_cast<T*>(dC), static_cast<float*>(dA),
      static_cast<float*>(dD), wsf, d);
  return cudaGetLastError();
}

bool dims_ok(int Bt, int S, int H, int P, int N, int Q) {
  return Bt >= 1 && Bt <= 65535 && S >= 1 && H >= 1 && H <= 65535 &&
         P >= 1 && P <= TILE && N >= 1 && N <= TILE && Q >= 1 && Q <= S &&
         Q <= 4096 && (S + Q - 1) / Q <= 65535;
}

}  // namespace ssd_bwd

// fp32 elements of the workspace a call needs (its scratch buffers), or
// -1 for dimensions the kernels do not take.
extern "C" long long ssd_scan_bwd_workspace(int Bt, int S, int H, int P,
                                            int N, int Q) {
  if (!ssd_bwd::dims_ok(Bt, S, H, P, N, Q)) return -1;
  return ssd_bwd::make_dims(Bt, S, H, P, N, Q).total;
}

// x, B, C, dy (and dx, dB, dC) in the dtype given (bf16 or f32), x, B and
// C through their (batch, sequence) strides, dy, dx, dB and dC contiguous;
// dt, A, D, h0 (or null), dh_final (or null), ddt, dA, dD, dh0 fp32,
// contiguous; ws of ssd_scan_bwd_workspace's size.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* D, const void* h0, const void* dy,
    const void* dh_final, void* dx, void* ddt, void* dA, void* dB, void* dC,
    void* dD, void* dh0, void* ws, int Bt, int S, int H, int P, int N, int Q,
    long long x_sb, long long x_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, int dtype, void* stream) {
  using namespace ssd_bwd;
  if (!dims_ok(Bt, S, H, P, N, Q)) return cudaErrorInvalidValue;
  const Dims d = make_dims(Bt, S, H, P, N, Q);
  const Strides st{x_sb, x_ss, b_sb, b_ss, c_sb, c_ss};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, dt, A, B, C, D, h0, dy, dh_final, dx, ddt,
                                 dA, dB, dC, dD, dh0, ws, d, st, s);
  return launch<float>(x, dt, A, B, C, D, h0, dy, dh_final, dx, ddt, dA, dB,
                       dC, dD, dh0, ws, d, st, s);
}
