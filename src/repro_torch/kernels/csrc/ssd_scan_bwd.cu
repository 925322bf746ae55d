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
// form's ~24 GFLOP would take ~0.025 ms at the bf16 tensor-core peak.
//
// Two routes, chosen by the wrapper (kernels/ssd_scan.py bwd_chunked_route)
// from dtype, shape and alignment.  Both recompute what they need (the
// cumulative sums a, C.B^T, the entering states) from the inputs, so they
// do not depend on which forward route ran; both sum a exactly as the
// forward sums it: in sequence order by one thread, each product and sum
// rounded on its own (no FMA), so the decay weights are the forward's bit
// for bit.  No atomics, and every sum in a fixed order, so two calls give
// the same bits.  Both take the same seven passes, all chunks in parallel:
//   1. chunk (batch, chunk, head): a -> acum; the chunk's state from zero,
//      sum_j exp(a_Q - a_j) dt_j x_j B_j^T -> hs; and its share of the
//      entering state's cotangent, sum_t exp(a_t) dy_t C_t^T -> gs;
//   2. bwd_state (batch, head, 1024 of the P x N state elements): the
//      entering states forward from h0 (hs becomes h_in) and, in reverse
//      from dh_final, the cotangent G_c of the state leaving chunk c (gs
//      becomes G); dh0; each block's share of the state's term of da at
//      the chunk's last row, exp(a_Q) <G_c, h_in_c>;
//   3. cb (batch, chunk, 64 x 64 tile pair on and below the diagonal):
//      C.B^T -> cb; then over the heads in order, dW = dy_t . x_j and dCB =
//      sum_h dW exp(a_t - a_j) dt_j (the exponent taken only where t >= j)
//      -> dcb, with each head's row and column sums of M = CB exp(a_t -
//      a_j) dt_j dW (the intra-chunk share of da) and the column sums of
//      CB exp(a_t - a_j) dW (of ddt) -> mpart;
//   4. dx (batch, chunk, head): dx_j = sum_{t >= j} W[t, j] dy_t + exp(a_Q -
//      a_j) dt_j (G B_j) + D dy_j, W = CB exp(a_t - a_j) dt_j;
//   5. dbc (batch, chunk, 64-row tile, group of heads): over the group's
//      heads in order, dC += exp(a_t) dy_t h_in and dB += exp(a_Q - a_j)
//      dt_j x_j G, with each head's dot products with C_t and B_j (the
//      inter-chunk and state shares of da); the intra-chunk terms dC +=
//      dCB B and dB += dCB^T C once -> one fp32 partial per group;
//   6. bwd_da (batch, chunk, head): da per row from mpart (summed over the
//      tile pairs in order), the inter-chunk and state shares; its reverse
//      sum in the chunk, d(dt A)_j = sum_{t >= j} da_t (one thread, in
//      order), gives ddt and this chunk's share of dA; and its share of
//      dD, sum dy x;
//   7. bwd_sum: dB and dC, the groups' partials summed in order; dA and dD,
//      the chunks' shares summed in order.
//
// The scalar route (ssd_scan_bwd_launch: fp32, and any shape or alignment
// the other refuses) is the first design: bwd_chunk, bwd_cb, bwd_dx and
// bwd_dbc take every product as a 64 x 64 fp32 tile product in shared
// memory on the CUDA cores (256 threads, each a 4 x 4 patch), bf16 and
// fp32 x, B, C and dy alike; bwd_cb loops one block per tile pair over all
// the heads, summing dCB in registers, and group 0 of bwd_dbc adds the
// intra-chunk terms.
//
// The tensor-core route (ssd_scan_bwd_tc_launch: bf16 x, B, C and dy; P
// and N multiples of 16 up to 64; chunks of at most 256 rows; 16-byte
// aligned bases and strides) runs every product on mma.sync m16n8k16 (bf16
// operands, fp32 accumulators): tc_acum takes pass 1's cumulative sums
// (one thread a head), tc_chunk, tc_cb, tc_dx and tc_dbc passes 1, 3, 4
// and 5, tc_dcb sums dCB's partials between them (below); bwd_state,
// bwd_da and bwd_sum are shared with the scalar route.  What paced the
// scalar route and what this one does about it:
//   - CUDA-core tile products (8-23 TFLOP/s): products of two bf16 inputs
//     (C.B^T, dy_t . x_j, those with B and C) are exact on the tensor
//     cores; an fp32 operand (w_j x_j, exp(a_t) dy_t, h_in, G, W, dCB) is
//     the sum of two bf16 parts, each the rounding of what the parts
//     before it leave, one product each (kernels/ssd_scan.py
//     BWD_KERNEL_PARTS: one part puts dh0 and the fp32 cotangents far
//     outside their tolerances, two hold them);
//   - bwd_cb's 80 heads in one block's loop (160 blocks): tc_cb takes the
//     heads in 8 groups (1,280 blocks at the train shape), each writing
//     its partial of dCB, which tc_dcb sums in group order into bf16 parts
//     for dbc's intra-chunk terms; the epilogue works on the accumulator
//     fragments (the column sums by a reduce-scatter of shuffles, the
//     trace of each diagonal dW, the tile's share of dD, -> ddx, so that
//     bwd_da reads no x or dy);
//   - tiles landing one at a time before each product: every tile reaches
//     shared memory by cp.async (zeros past the chunk and the sequence,
//     rows padded by 16 bytes, fragments read by ldmatrix), and the head
//     loops of tc_cb and tc_dbc load the next head's tiles while this
//     one's products run;
//   - decay exponents per element: below a diagonal block tc_cb and tc_dx
//     factor exp(a_t - a_j) about a row between t and j, both exponents <=
//     0, one factor from a table;
//   - dbc's U = dy_t h_in and V = x_j G in one block: tc_dbc gives each
//     its own blocks (one side each), h_in and G read as the bf16 parts
//     that bwd_state writes beside the entering states.
#include "common.cuh"
#include "mma_sync.cuh"

namespace ssd_bwd {

using namespace mma_sync;
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
// hg groups of hpg heads each take a share of dB and dC (bwd_dbc's, and the
// tensor-core route's tc_dbc, which adds one group for the intra-chunk
// terms): nparts partials, summed in order by bwd_sum.  The tensor-core
// route's tc_cb takes the heads in cbg groups of cb_hpg, each writing its
// partial of dCB (dcb), which tc_dcb sums into bf16 parts (dcbp), and the
// traces of dW (ddx); tc_dx and tc_dbc read the entering states and their
// cotangents as STATE_PARTS bf16 parts (hpart, gpart).
struct Dims {
  int Bt, S, H, P, N, Q;
  int nc, nt, Qr, pairs, hg, hpg, sblk, nparts, tc, cbg, cb_hpg;
  ll acum, hs, gs, cb, dcb, mpart, dain, dwb, dast, dap, ddp, dbp, dcp,
      hpart, gpart, ddx, dcbp, total;
};

__host__ __device__ inline int pair_index(int ti, int tj) {
  return ti * (ti + 1) / 2 + tj;
}

// bf16 parts of the tensor-core route's fp32 operands
// (kernels/ssd_scan.py BWD_KERNEL_PARTS)
constexpr int CHUNK_PARTS = 2;    // w_j x_j, exp(a_t) dy_t
constexpr int STATE_PARTS = 2;    // h_in, G
constexpr int WEIGHT_PARTS = 2;   // W[t, j] of dx
constexpr int DCB_PARTS = 2;      // dCB of the intra-chunk dB and dC
constexpr int CB_GROUPS = 8;     // tc_cb's groups of heads, at most
constexpr int SMS = 132;         // the H100's streaming multiprocessors

inline int ceil_div(ll a, ll b) { return static_cast<int>((a + b - 1) / b); }

// groups of heads for bwd_dbc and tc_dbc: enough blocks to fill the card
// twice over, each group summing its heads in order
inline Dims make_dims(int Bt, int S, int H, int P, int N, int Q, bool tc) {
  Dims d{};
  d.Bt = Bt, d.S = S, d.H = H, d.P = P, d.N = N, d.Q = Q;
  d.tc = tc;
  d.nc = (S + Q - 1) / Q;
  d.nt = (Q + TILE - 1) / TILE;
  d.Qr = d.nt * TILE;
  d.pairs = d.nt * (d.nt + 1) / 2;
  d.sblk = (P * N + STATE_EL * STATE_THREADS - 1) / (STATE_EL * STATE_THREADS);
  const ll tiles = static_cast<ll>(d.nt) * d.nc * Bt;
  ll want = (2 * SMS + tiles - 1) / tiles;
  if (want > H) want = H;
  if (want < 1) want = 1;
  d.hpg = ceil_div(H, want);
  d.hg = ceil_div(H, d.hpg);
  d.cb_hpg = ceil_div(H, CB_GROUPS < H ? CB_GROUPS : H);
  d.cbg = ceil_div(H, d.cb_hpg);
  d.nparts = tc ? d.hg + 1 : d.hg;
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
  d.dcb = take((tc ? d.cbg : 1) * static_cast<ll>(Bt) * d.nc * d.Qr * d.Qr);
  d.mpart = take(bch * d.pairs * MPART);
  d.dain = take(bch * d.Qr);
  d.dwb = take(bch * d.Qr);
  d.dast = take(bch * d.sblk);
  d.dap = take(bch);
  d.ddp = take(bch);
  d.dbp = take(static_cast<ll>(d.nparts) * Bt * S * N);
  d.dcp = take(static_cast<ll>(d.nparts) * Bt * S * N);
  // bf16 parts: STATE_PARTS bf16 values an element, two to an fp32 word
  d.hpart = take(tc ? bch * PN * STATE_PARTS / 2 : 0);
  d.gpart = take(tc ? bch * PN * STATE_PARTS / 2 : 0);
  d.ddx = take(tc ? bch * d.nt : 0);   // tc_cb: sum of dy_t . x_t a tile
  // tc_dcb: the summed dCB as DCB_PARTS bf16 parts
  d.dcbp = take(tc ? static_cast<ll>(Bt) * d.nc * d.Qr * d.Qr * DCB_PARTS / 2
                   : 0);
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

// The tensor-core route's copy of four state elements e..e+3 of (b, c,
// h) as STATE_PARTS bf16 parts: part k at base[((b nc + c) H + h) PN
// STATE_PARTS + k PN + e]
__device__ __forceinline__ void store_parts(float* base, ll bch, int PN,
                                            int e, const float (&v)[4]) {
  bf16* p = reinterpret_cast<bf16*>(base) + bch * STATE_PARTS * PN + e;
  uint32_t lo[STATE_PARTS], hi[STATE_PARTS];
  split_n<STATE_PARTS>(v[0], v[1], lo);
  split_n<STATE_PARTS>(v[2], v[3], hi);
#pragma unroll
  for (int k = 0; k < STATE_PARTS; ++k)
    *reinterpret_cast<uint2*>(p + static_cast<ll>(k) * PN) =
        make_uint2(lo[k], hi[k]);
}

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
      const ll bch = (static_cast<ll>(b) * d.nc + c) * d.H + h;
      if (d.tc && e < PN) store_parts(ws + d.hpart, bch, PN, e, hv);
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
      const ll bch = (static_cast<ll>(b) * d.nc + c) * d.H + h;
      if (d.tc && e < PN) store_parts(ws + d.gpart, bch, PN, e, gv);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < STATE_EL; ++i) {
        if (!d.tc && e + i < PN) gs[i] = gv[i];   // tc: the parts only
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
  // this chunk's share of dD: sum over its rows of dy . x (the tensor-core
  // route's tc_cb has summed each 64-row tile's: the traces of dW)
  float acc = 0.f;
  const T* xb = x + b * st.x_sb + static_cast<ll>(h) * d.P;
  const T* dyb = dy + static_cast<ll>(b) * d.S * d.H * d.P +
                 static_cast<ll>(h) * d.P;
  for (int e = tid; !d.tc && e < valid * d.P; e += THREADS) {
    const int r = e / d.P, p = e % d.P;
    acc += to_f32(dyb[static_cast<ll>(s0 + r) * d.H * d.P + p]) *
           to_f32(xb[static_cast<ll>(s0 + r) * st.x_ss + p]);
  }
  acc = block_sum(acc, red);       // its barriers also publish s_*
  if (tid == 0 && d.tc)
    for (int ti = 0; ti < d.nt; ++ti) acc += ws[d.ddx + bch * d.nt + ti];
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
    for (int g = 0; g < d.nparts; ++g) {
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

// ===================================================== the tensor-core route
//
// bf16 x, B, C and dy; P and N multiples of 16 up to 64; chunks of at most
// 256 rows; 16-byte aligned bases and strides.  The same seven passes, with
// tc_acum and tc_chunk in place of bwd_chunk, tc_cb, tc_dx and tc_dbc in
// place of bwd_cb, bwd_dx and bwd_dbc, and tc_dcb between tc_dx and tc_dbc:
// every product on mma.sync m16n8k16 (bf16 operands, fp32 accumulators).  Products of two bf16 inputs (C.B^T, dy_t . x_j, the
// products with B and C) are exact; an fp32 operand is the sum of bf16
// parts, each the rounding of what the parts before it leave
// (kernels/ssd_scan.py BWD_KERNEL_PARTS: two for each, ~2^-17 relative,
// which holds every cotangent's tolerance where one part does not).  Tiles
// reach shared memory by cp.async (zeros past the chunk and the sequence),
// rows padded by 16 bytes, and fragments are read by ldmatrix.

constexpr int TPAD = 8;           // bf16 a shared row is padded by

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
}

__device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// ------------------------------------------------------------- 1. tc_acum

// The cumulative sums a of dt * A -> acum, one thread a head in sequence
// order, each product and sum rounded on its own (no FMA): the forward's
// and bwd_chunk's arithmetic, bit for bit.  One block per (32 heads,
// chunk, batch); the chunk's dt of its heads lands in shared memory
// first, every element in flight at once.
constexpr int ACUM_HEADS = 32;
constexpr int ACUM_THREADS = 256;
constexpr int QMAX_TC = 256;     // the tensor-core route's chunk rows

__global__ void __launch_bounds__(ACUM_THREADS)
tc_acum_kernel(const float* __restrict__ dt, const float* __restrict__ A,
               float* __restrict__ ws, Dims d) {
  __shared__ float sdt[QMAX_TC * (ACUM_HEADS + 1)];   // [r][head], padded
  constexpr int LDH = ACUM_HEADS + 1;
  const int h0 = blockIdx.x * ACUM_HEADS, nh = min(ACUM_HEADS, d.H - h0);
  const int c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int s0 = c * d.Q, valid = min(d.Q, d.S - s0);
  const float* db = dt + (static_cast<ll>(b) * d.S + s0) * d.H + h0;
  const int hl = tid % ACUM_HEADS;
  for (int r = tid / ACUM_HEADS; r < d.Qr; r += ACUM_THREADS / ACUM_HEADS) {
    const bool ok = r < valid && hl < nh;
    cp4(sdt + r * LDH + hl, ok ? db + static_cast<ll>(r) * d.H + hl : dt, ok);
  }
  cp_wait_all();
  __syncthreads();
  if (tid < nh) {
    // 16 values read before any is written
    const float a_h = A[h0 + tid];
    float run = 0.f;
    for (int r0 = 0; r0 < d.Qr; r0 += 16) {
      float v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = sdt[(r0 + u) * LDH + tid];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        run = __fadd_rn(run, __fmul_rn(v[u], a_h));
        sdt[(r0 + u) * LDH + tid] = run;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nh * d.Qr; e += ACUM_THREADS) {
    const int k = e / d.Qr, r = e - k * d.Qr;
    ws[d.acum + ((static_cast<ll>(b) * d.H + h0 + k) * d.nc + c) * d.Qr + r] =
        sdt[r * LDH + k];
  }
}

// ------------------------------------------------------------ 1. tc_chunk

// Blocks [0, H): the chunk's state from zero, sum_j (w_j x_j)^T B_j -> hs;
// blocks [H, 2H): the local sum of the entering state's cotangent, sum_t
// (exp(a_t) dy_t)^T C_t -> gs.  Each is the forward's chunk-state kernel:
// warp w owns rows p of 16 (w % 4) .. + 15 and the first (w < 4) or second
// half of the chunk's k-steps, the halves added in that order through
// shared memory.
constexpr int CHUNK_THREADS = 256;

__global__ void __launch_bounds__(CHUNK_THREADS, 2)
tc_chunk_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                float* __restrict__ ws, Dims d, Strides st) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int cot = blockIdx.x >= static_cast<unsigned>(d.H);
  const int h = blockIdx.x - cot * d.H, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ldx = d.P + TPAD, ldb = d.N + TPAD;
  bf16* sX = reinterpret_cast<bf16*>(tc_smem);                 // [Qr][ldx]
  bf16* sB = sX + d.Qr * ldx;                               // [Qr][ldb]
  float* sRed = reinterpret_cast<float*>(sB + d.Qr * ldb);  // [P][N]
  float* s_dt = sRed + d.P * d.N;                           // [Qr]
  float* s_a = s_dt + d.Qr;                                 // [Qr]
  float* s_w = s_a + d.Qr;     // [Qr]: exp(a_Q - a_j) dt_j, or exp(a_t)
  const int s0 = c * d.Q, valid = min(d.Q, d.S - s0), kend = round16(valid);
  const float* db = dt + (static_cast<ll>(b) * d.S + s0) * d.H + h;
  const float* ac = ws + d.acum + ((static_cast<ll>(b) * d.H + h) * d.nc + c) *
                                      d.Qr;
  for (int r = tid; r < d.Qr; r += CHUNK_THREADS) {
    if ((r & 3) == 0) cp16(s_a + r, ac + r, true);
    cp4(s_dt + r, r < valid ? db + static_cast<ll>(r) * d.H : dt, r < valid);
  }
  if (cot) {
    const ll dy_ss = static_cast<ll>(d.H) * d.P;
    load_rows8<CHUNK_THREADS>(
        sX, ldx, dy, dy + (static_cast<ll>(b) * d.S + s0) * dy_ss + h * d.P,
        dy_ss, kend, valid, d.P);
    load_rows8<CHUNK_THREADS>(sB, ldb, Cm, Cm + b * st.c_sb + s0 * st.c_ss,
                             st.c_ss, kend, valid, d.N);
  } else {
    load_rows8<CHUNK_THREADS>(sX, ldx, x,
                             x + b * st.x_sb + s0 * st.x_ss + h * d.P,
                             st.x_ss, kend, valid, d.P);
    load_rows8<CHUNK_THREADS>(sB, ldb, Bm, Bm + b * st.b_sb + s0 * st.b_ss,
                             st.b_ss, kend, valid, d.N);
  }
  cp_wait_all();
  __syncthreads();
  const float a_last = s_a[d.Q - 1];
  for (int r = tid; r < d.Qr; r += CHUNK_THREADS)
    s_w[r] = r >= d.Q ? 0.f
             : cot    ? expf(s_a[r])
                      : expf(a_last - s_a[r]) * s_dt[r];
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int m0 = (warp & 3) * 16, kh = warp >> 2;
  const int nk = kend / 16, k_mid = (nk + 1) / 2 * 16;
  const int k_lo = kh ? k_mid : 0, k_hi = kh ? kend : k_mid;
  const bool live = m0 < d.P;
  float acc[8][4];
  zero(acc);
  if (live) {
    for (int k0 = k_lo; k0 < k_hi; k0 += 16) {
      // A[p][j] = x_j[p] w_j (or dy_t[p] exp(a_t)): stored [j][p], read
      // transposed, scaled and split in registers
      uint32_t a[4], ap[CHUNK_PARTS][4];
      ldsm_x4_t(a, sX + (k0 + (mi >> 1) * 8 + r8) * ldx + m0 + (mi & 1) * 8);
      const float2 wlo = *reinterpret_cast<const float2*>(s_w + k0 + 2 * q);
      const float2 whi =
          *reinterpret_cast<const float2*>(s_w + k0 + 8 + 2 * q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 xv = unpack(a[i]);
        const float2 w = i < 2 ? wlo : whi;
        uint32_t p[CHUNK_PARTS];
        split_n<CHUNK_PARTS>(xv.x * w.x, xv.y * w.y, p);
#pragma unroll
        for (int k = 0; k < CHUNK_PARTS; ++k) ap[k][i] = p[k];
      }
#pragma unroll
      for (int nn = 0; nn < 64; nn += 16) {
        if (nn < d.N) {
          uint32_t bq[4];
          // B[j][n] = B_j[n] (or C_t[n]), stored [j][n]: read transposed
          ldsm_x4_t(bq, sB + (k0 + (mi & 1) * 8 + r8) * ldb + nn +
                            (mi >> 1) * 8);
#pragma unroll
          for (int k = 0; k < CHUNK_PARTS; ++k) {
            mma(acc[nn / 8], ap[k], bq[0], bq[1]);
            mma(acc[nn / 8 + 1], ap[k], bq[2], bq[3]);
          }
        }
      }
    }
  }
  if (live && kh == 1) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt * 8 < d.N) {
        const int n = nt * 8 + 2 * q;
        *reinterpret_cast<float2*>(sRed + (m0 + g) * d.N + n) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(sRed + (m0 + g + 8) * d.N + n) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
  }
  __syncthreads();
  if (!live || kh == 1) return;
  float* out = ws + (cot ? d.gs : d.hs) +
               ((static_cast<ll>(b) * d.nc + c) * d.H + h) * d.P * d.N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt * 8 < d.N) {
      const int n = nt * 8 + 2 * q;
      const float2 u =
          *reinterpret_cast<const float2*>(sRed + (m0 + g) * d.N + n);
      const float2 v =
          *reinterpret_cast<const float2*>(sRed + (m0 + g + 8) * d.N + n);
      *reinterpret_cast<float2*>(out + (m0 + g) * d.N + n) =
          make_float2(acc[nt][0] + u.x, acc[nt][1] + u.y);
      *reinterpret_cast<float2*>(out + (m0 + g + 8) * d.N + n) =
          make_float2(acc[nt][2] + v.x, acc[nt][3] + v.y);
    }
  }
}

size_t tc_chunk_smem(const Dims& d) {
  return static_cast<size_t>(d.Qr) * (d.P + TPAD + d.N + TPAD) * sizeof(bf16) +
         (static_cast<size_t>(d.P) * d.N + 3 * d.Qr) * sizeof(float);
}

// ---------------------------------------------------------------- 3. tc_cb

// One block of eight warps per (batch, chunk, 64 x 64 tile pair on and
// below the diagonal, group of heads); warp w owns rows t of 16 (w % 4) ..
// + 15 and columns j of 32 (w / 4) .. + 31.  C.B^T once (group 0 writes it
// transposed, cbT[j][t], the layout tc_dx reads); then over the group's
// heads in order, the next head's dy and x tiles in flight while this
// one's dW = dy_t . x_j runs, and on the accumulator fragments: the causal
// mask and the decay (the exponent taken only where t >= j; below the
// diagonal tile factored as exp(a_t - a_t0) exp(a_t0 - a_j) about the
// tile's first row t0, both exponents <= 0, the column factors one table a
// head), dCB += dW exp(a_t - a_j) dt_j, the row sums of M = CB exp(a_t -
// a_j) dt_j dW (a quad's shuffles, then the two column halves in order
// through shared memory), the column sums of Q = CB exp(a_t - a_j) dW (a
// reduce-scatter over the warp's rows, then the four row blocks in order
// through shared memory) and of M, dt_j times Q's -> mpart; on the
// diagonal tile pairs the trace of dW, the tile's share of dD -> ddx.
// Each group's dCB partial -> dcb.
constexpr int CB_THREADS = 256;
// a head's sums through shared memory: Q's column sums [row block][j], M's
// row sums [column half][t], the warps' traces of dW
constexpr int RED_COL = 0, RED_ROW = 4 * TILE, RED_TRACE = 6 * TILE;
constexpr int RED = 6 * TILE + 8;

// One step of a reduce-scatter across the lanes that differ in lane bit
// `bit`: of v[0 .. 2n), the lane with the bit set keeps the upper half,
// the other the lower, each plus its partner's copy of it, in v[0 .. n)
template <int n, int bit>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[8],
                                                    int lane) {
  const bool up = lane & bit;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const float send = up ? v[k] : v[n + k];
    const float keep = up ? v[n + k] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
  }
}

__global__ void __launch_bounds__(CB_THREADS, 2)
tc_cb_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
             const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
             const bf16* __restrict__ dy, float* __restrict__ ws, Dims d,
             Strides st) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int ldn = d.N + TPAD, ldp = d.P + TPAD;
  bf16* sC = reinterpret_cast<bf16*>(tc_smem);   // [64][ldn]: C_t
  bf16* sB = sC + TILE * ldn;                  // [64][ldn]: B_j
  bf16* sDy = sB + TILE * ldn;                 // [2][64][ldp]: dy_t, a head
  bf16* sX = sDy + 2 * TILE * ldp;             // [2][64][ldp]: x_j
  float* red = reinterpret_cast<float*>(sX + 2 * TILE * ldp);  // [2][RED]
  float* s_at = red + 2 * RED;                 // [heads][64]: a_t
  float* s_aj = s_at + d.cb_hpg * TILE;        // [heads][64]: a_j, then
                                               // exp(a_t0 - a_j) below the
                                               // diagonal tile
  float* s_dtj = s_aj + d.cb_hpg * TILE;       // [heads][64]: dt_j
  int pr = blockIdx.x, ti = 0;
  while (pr > ti) pr -= ++ti;
  const int tj = pr;
  const bool diag = ti == tj;
  const int c = blockIdx.y, b = blockIdx.z / d.cbg, grp = blockIdx.z % d.cbg;
  const int h_lo = grp * d.cb_hpg, nh = min(d.H - h_lo, d.cb_hpg);
  const int tid = threadIdx.x, t0 = ti * TILE, j0 = tj * TILE;
  const int s0 = c * d.Q, valid = min(d.Q, d.S - s0);
  const ll dy_ss = static_cast<ll>(d.H) * d.P;
  load_rows8<CB_THREADS>(sC, ldn, Cm, Cm + b * st.c_sb + (s0 + t0) * st.c_ss,
                         st.c_ss, TILE, valid - t0, d.N);
  load_rows8<CB_THREADS>(sB, ldn, Bm, Bm + b * st.b_sb + (s0 + j0) * st.b_ss,
                         st.b_ss, TILE, valid - j0, d.N);
  for (int e = tid; e < nh * 16; e += CB_THREADS) {
    const int hh = e >> 4, k = (e & 15) * 4;
    const float* ac = ws + d.acum +
        ((static_cast<ll>(b) * d.H + h_lo + hh) * d.nc + c) * d.Qr;
    cp16(s_at + hh * TILE + k, ac + t0 + k, true);
    cp16(s_aj + hh * TILE + k, ac + j0 + k, true);
  }
  // dt of the group's heads, neighbouring threads on neighbouring heads
  for (int e = tid; e < nh * TILE; e += CB_THREADS) {
    const int r = e / nh, hh = e - r * nh, j = j0 + r;
    cp4(s_dtj + hh * TILE + r,
        j < valid ? dt + (static_cast<ll>(b) * d.S + s0 + j) * d.H + h_lo + hh
                  : dt,
        j < valid);
  }
  auto load_head = [&](int hh, int s) {
    const int h = h_lo + hh;
    load_rows8<CB_THREADS>(
        sDy + s * TILE * ldp, ldp, dy,
        dy + (static_cast<ll>(b) * d.S + s0 + t0) * dy_ss + h * d.P, dy_ss,
        TILE, valid - t0, d.P);
    load_rows8<CB_THREADS>(
        sX + s * TILE * ldp, ldp, x,
        x + b * st.x_sb + (s0 + j0) * st.x_ss + h * d.P, st.x_ss, TILE,
        valid - j0, d.P);
  };
  load_head(0, 0);
  cp_wait_all();
  __syncthreads();
  if (!diag) {
    for (int e = tid; e < nh * TILE; e += CB_THREADS)
      s_aj[e] = expf(s_at[e & ~(TILE - 1)] - s_aj[e]);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int m0 = (warp & 3) * 16, ch = warp >> 2, c0 = ch * 32;
  const int tlA = m0 + g, tlB = tlA + 8;
  float cbv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) cbv[i][k] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    if (kk >= d.N) break;
    uint32_t a[4];
    // A[t][n] = C_t[n], row-major
    ldsm_x4(a, sC + (m0 + (mi & 1) * 8 + r8) * ldn + kk + (mi >> 1) * 8);
#pragma unroll
    for (int nn = 0; nn < 32; nn += 16) {
      uint32_t bq[4];
      // B[n][j] = B_j[n], stored [j][n]: column-major
      ldsm_x4(bq, sB + (c0 + nn + (mi >> 1) * 8 + r8) * ldn + kk +
                      (mi & 1) * 8);
      mma(cbv[nn / 8], a, bq[0], bq[1]);
      mma(cbv[nn / 8 + 1], a, bq[2], bq[3]);
    }
  }
  if (grp == 0) {
    float* cbt = ws + d.cb + (static_cast<ll>(b) * d.nc + c) * d.Qr * d.Qr;
    const int tA = t0 + tlA, tB = t0 + tlB;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const ll j = j0 + c0 + nt * 8 + 2 * q;
      cbt[j * d.Qr + tA] = cbv[nt][0];
      cbt[(j + 1) * d.Qr + tA] = cbv[nt][1];
      cbt[j * d.Qr + tB] = cbv[nt][2];
      cbt[(j + 1) * d.Qr + tB] = cbv[nt][3];
    }
  }
  __syncthreads();     // the column factors
  const ll bch0 = (static_cast<ll>(b) * d.nc + c) * d.H + h_lo;
  // head hh's sums: Q's column sums, the four row blocks' partials in
  // order, and M's (dt_j times Q's); M's row sums, the two column halves'
  // partials in order; on the diagonal, the trace of dW
  auto head_sums = [&](int hh) {
    const float* rd = red + (hh & 1) * RED;
    float* mp = ws + d.mpart + ((bch0 + hh) * d.pairs + blockIdx.x) * MPART;
    if (tid < TILE) {
      const float* v = rd + RED_COL + tid;
      const float cq = ((v[0] + v[TILE]) + v[2 * TILE]) + v[3 * TILE];
      mp[TILE + tid] = s_dtj[hh * TILE + tid] * cq;
      mp[2 * TILE + tid] = cq;
    } else if (tid < 2 * TILE) {
      const int t = tid - TILE;
      mp[t] = rd[RED_ROW + t] + rd[RED_ROW + TILE + t];
    } else if (diag && tid == 2 * TILE) {
      const float* tr = rd + RED_TRACE;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) sum += tr[w];
      ws[d.ddx + (bch0 + hh) * d.nt + ti] = sum;
    }
  };
  float dcb[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) dcb[i][k] = 0.f;
  for (int hh = 0; hh < nh; ++hh) {
    const int s = hh & 1;
    if (hh > 0) {
      cp_wait<0>();       // this head's tiles
      __syncthreads();    // ... everyone's, and the last head done
      head_sums(hh - 1);
    }
    if (hh + 1 < nh) {
      load_head(hh + 1, s ^ 1);
      cp_commit();
    }
    const bf16* sd = sDy + s * TILE * ldp;
    const bf16* sx = sX + s * TILE * ldp;
    float dW[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) dW[i][k] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      if (kk >= d.P) break;
      uint32_t a[4];
      // A[t][p] = dy_t[p], row-major
      ldsm_x4(a, sd + (m0 + (mi & 1) * 8 + r8) * ldp + kk + (mi >> 1) * 8);
#pragma unroll
      for (int nn = 0; nn < 32; nn += 16) {
        uint32_t bq[4];
        // B[p][j] = x_j[p], stored [j][p]: column-major
        ldsm_x4(bq, sx + (c0 + nn + (mi >> 1) * 8 + r8) * ldp + kk +
                        (mi & 1) * 8);
        mma(dW[nn / 8], a, bq[0], bq[1]);
        mma(dW[nn / 8 + 1], a, bq[2], bq[3]);
      }
    }
    const float* at = s_at + hh * TILE;
    const float* aj = s_aj + hh * TILE;
    const float* dtj = s_dtj + hh * TILE;
    // the row factors: exp(a_t - a_t0) below the diagonal tile, a_t on it
    const float fA = diag ? at[tlA] : expf(at[tlA] - at[0]);
    const float fB = diag ? at[tlB] : expf(at[tlB] - at[0]);
    float rowA = 0.f, rowB = 0.f, trace = 0.f;
    // v[2 nt + cc]: this lane's share, over its two rows, of the column
    // sums of Q = CB exp(a_t - a_j) dW; M = Q dt_j, so M's are dt_j times
    // Q's
    float v[8];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int jl = c0 + nt * 8 + 2 * q + cc;
        const float ajv = aj[jl], dtv = dtj[jl];
        float cq = 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 2 * r + cc, tl = r ? tlB : tlA;
          if (diag && tl == jl) trace += dW[nt][i];
          if (!diag || tl >= jl) {
            const float e = diag ? expf((r ? fB : fA) - ajv)
                                 : (r ? fB : fA) * ajv;
            const float dwl = dW[nt][i] * e;
            dcb[nt][i] += dwl * dtv;
            const float qv = cbv[nt][i] * dwl;
            if (r)
              rowB += qv * dtv;
            else
              rowA += qv * dtv;
            cq += qv;
          }
        }
        v[2 * nt + cc] = cq;
      }
    }
    // reduce-scatter over the 8 lanes of a column (lane bits 2-4): lane g
    // ends with the sum of v[g], column c0 + (g / 2) 8 + 2 q + g % 2
    reduce_scatter_step<4, 16>(v, lane);
    reduce_scatter_step<2, 8>(v, lane);
    reduce_scatter_step<1, 4>(v, lane);
    float* rd = red + s * RED;
    rd[RED_COL + (warp & 3) * TILE + c0 + (g >> 1) * 8 + 2 * q + (g & 1)] =
        v[0];
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      rowA += __shfl_xor_sync(0xffffffffu, rowA, o);
      rowB += __shfl_xor_sync(0xffffffffu, rowB, o);
    }
    if (q == 0) {
      rd[RED_ROW + ch * TILE + tlA] = rowA;
      rd[RED_ROW + ch * TILE + tlB] = rowB;
    }
    if (diag) {
      trace = warp_sum(trace);
      if (lane == 0) rd[RED_TRACE + warp] = trace;
    }
  }
  __syncthreads();
  head_sums(nh - 1);
  float* o = ws + d.dcb +
             ((static_cast<ll>(grp) * d.Bt + b) * d.nc + c) * d.Qr * d.Qr;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int j = j0 + c0 + nt * 8 + 2 * q;
    *reinterpret_cast<float2*>(o + static_cast<ll>(t0 + tlA) * d.Qr + j) =
        make_float2(dcb[nt][0], dcb[nt][1]);
    *reinterpret_cast<float2*>(o + static_cast<ll>(t0 + tlB) * d.Qr + j) =
        make_float2(dcb[nt][2], dcb[nt][3]);
  }
}

size_t tc_cb_smem(const Dims& d) {
  return (2 * static_cast<size_t>(TILE) * (d.N + TPAD) +
          4 * static_cast<size_t>(TILE) * (d.P + TPAD)) * sizeof(bf16) +
         (2 * RED + 3 * static_cast<size_t>(d.cb_hpg) * TILE) * sizeof(float);
}

// ---------------------------------------------------------------- 4. tc_dx

// One block of eight warps per (batch, chunk, head), the forward's output
// kernel transposed: dx_j = sum_{t >= j} W[t, j] dy_t + w_j (B_j . G) + D
// dy_j, W[t, j] = CB[t, j] exp(a_t - a_j) dt_j built per fragment from
// cbT and split into parts (the exponent taken only where t >= j; below
// the 16-row diagonal block factored as exp(a_t - a_k0) exp(a_k0 - a_j)
// about the k-step's first row k0, both exponents <= 0, the first factor
// one table a block); G as its parts from bwd_state.  Warp w owns the
// 16-row tiles of j w and 15 - w, so every warp does the same share of
// the causal triangle.
constexpr int DX_THREADS = 256;

__global__ void __launch_bounds__(DX_THREADS, 2)
tc_dx_kernel(const float* __restrict__ dt, const bf16* __restrict__ Bm,
             const float* __restrict__ Dv, const bf16* __restrict__ dy,
             bf16* __restrict__ dx, const float* __restrict__ ws, Dims d,
             Strides st) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ldp = d.P + TPAD, ldn = d.N + TPAD;
  bf16* sDy = reinterpret_cast<bf16*>(tc_smem);          // [Qr][ldp]
  bf16* sB = sDy + d.Qr * ldp;                        // [Qr][ldn]
  bf16* sG = sB + d.Qr * ldn;                         // [parts][P][ldn]
  float* s_a = reinterpret_cast<float*>(sG + STATE_PARTS * d.P * ldn);
  float* s_dt = s_a + d.Qr;
  float* s_e = s_dt + d.Qr;   // exp(a_t - a_16m), t in 16-row block m
  const int s0 = c * d.Q, valid = min(d.Q, d.S - s0), kend = round16(valid);
  const ll dy_ss = static_cast<ll>(d.H) * d.P;
  const ll PN = static_cast<ll>(d.P) * d.N;
  const ll bch = (static_cast<ll>(b) * d.nc + c) * d.H + h;
  const bf16* dyc = dy + (static_cast<ll>(b) * d.S + s0) * dy_ss + h * d.P;
  load_rows8<DX_THREADS>(sDy, ldp, dy, dyc, dy_ss, kend, valid, d.P);
  load_rows8<DX_THREADS>(sB, ldn, Bm, Bm + b * st.b_sb + s0 * st.b_ss,
                        st.b_ss, kend, valid, d.N);
  const bf16* gp = reinterpret_cast<const bf16*>(ws + d.gpart) +
                   bch * STATE_PARTS * PN;
#pragma unroll
  for (int k = 0; k < STATE_PARTS; ++k)
    load_rows8<DX_THREADS>(sG + k * d.P * ldn, ldn, gp, gp + k * PN, d.N, d.P,
                          d.P, d.N);
  const float* ac = ws + d.acum + ((static_cast<ll>(b) * d.H + h) * d.nc + c) *
                                      d.Qr;
  const float* db = dt + (static_cast<ll>(b) * d.S + s0) * d.H + h;
  for (int j = tid; j < d.Qr; j += DX_THREADS) {
    if ((j & 3) == 0) cp16(s_a + j, ac + j, true);
    cp4(s_dt + j, j < valid ? db + static_cast<ll>(j) * d.H : dt, j < valid);
  }
  cp_wait_all();
  __syncthreads();
  for (int t = tid; t < d.Qr; t += DX_THREADS)
    s_e[t] = expf(s_a[t] - s_a[t & ~15]);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const float a_last = s_a[d.Q - 1], d_h = Dv[h];
  const float* cbt = ws + d.cb + (static_cast<ll>(b) * d.nc + c) * d.Qr * d.Qr;
  bf16* dxc = dx + (static_cast<ll>(b) * d.S + s0) * dy_ss + h * d.P;
  for (int half = 0; half < 2; ++half) {
    const int j0 = (half == 0 ? warp : 15 - warp) * 16;
    if (j0 >= kend) continue;
    const int jA = j0 + g, jB = jA + 8;
    float acc[8][4];
    zero(acc);
    // the state term: sum_n B_j[n] G[p][n], G as its parts
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      if (kk >= d.N) break;
      uint32_t a[4];
      ldsm_x4(a, sB + (j0 + (mi & 1) * 8 + r8) * ldn + kk + (mi >> 1) * 8);
#pragma unroll
      for (int np = 0; np < 64; np += 16) {
        if (np < d.P) {
#pragma unroll
          for (int k = 0; k < STATE_PARTS; ++k) {
            uint32_t bg[4];
            // B[n][p] = G[p][n], stored [p][n]: column-major
            ldsm_x4(bg, sG + k * d.P * ldn + (np + (mi >> 1) * 8 + r8) * ldn +
                            kk + (mi & 1) * 8);
            mma(acc[np / 8], a, bg[0], bg[1]);
            mma(acc[np / 8 + 1], a, bg[2], bg[3]);
          }
        }
      }
    }
    const float ajA = s_a[jA], ajB = s_a[jB];
    const float dtA = s_dt[jA], dtB = s_dt[jB];
    {
      const float wA = jA < d.Q ? expf(a_last - ajA) * dtA : 0.f;
      const float wB = jB < d.Q ? expf(a_last - ajB) * dtB : 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] *= wA;
        acc[nt][1] *= wA;
        acc[nt][2] *= wB;
        acc[nt][3] *= wB;
      }
    }
    // the intra-chunk term over t >= j: A[j][t] = W[t][j] from cbT[j][t]
    const float* cbA = cbt + static_cast<ll>(jA) * d.Qr + 2 * q;
    const float* cbB = cbA + 8 * d.Qr;
    float2 nx[4];   // the next k-step's cbT, in flight
    auto load_cb = [&](float2 (&dst)[4], int k0) {
      if (k0 >= kend) return;
      dst[0] = *reinterpret_cast<const float2*>(cbA + k0);
      dst[1] = *reinterpret_cast<const float2*>(cbB + k0);
      dst[2] = *reinterpret_cast<const float2*>(cbA + k0 + 8);
      dst[3] = *reinterpret_cast<const float2*>(cbB + k0 + 8);
    };
    load_cb(nx, j0);
    for (int k0 = j0; k0 < kend; k0 += 16) {
      float2 cur[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cur[i] = nx[i];
      load_cb(nx, k0 + 16);
      uint32_t ap[WEIGHT_PARTS][4];
      if (k0 > j0) {
        // below the diagonal block: exp(a_t - a_j) = exp(a_t - a_k0)
        // exp(a_k0 - a_j), both exponents <= 0 (t >= k0 > j)
        const float rA = expf(s_a[k0] - ajA) * dtA;
        const float rB = expf(s_a[k0] - ajB) * dtB;
        const float2 col[2] = {
            *reinterpret_cast<const float2*>(s_e + k0 + 2 * q),
            *reinterpret_cast<const float2*>(s_e + k0 + 8 + 2 * q)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float r = (i & 1) ? rB : rA;
          uint32_t p[WEIGHT_PARTS];
          split_n<WEIGHT_PARTS>(cur[i].x * col[i >> 1].x * r,
                                cur[i].y * col[i >> 1].y * r, p);
#pragma unroll
          for (int k = 0; k < WEIGHT_PARTS; ++k) ap[k][i] = p[k];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // register i: rows jA (i even) or jB, columns t + 8 (i / 2)
          const int j = (i & 1) ? jB : jA;
          const float aj = (i & 1) ? ajB : ajA, dtj = (i & 1) ? dtB : dtA;
          const int t = k0 + 2 * q + (i >> 1) * 8;
          const float w0 = t >= j ? cur[i].x * expf(s_a[t] - aj) * dtj : 0.f;
          const float w1 =
              t + 1 >= j ? cur[i].y * expf(s_a[t + 1] - aj) * dtj : 0.f;
          uint32_t p[WEIGHT_PARTS];
          split_n<WEIGHT_PARTS>(w0, w1, p);
#pragma unroll
          for (int k = 0; k < WEIGHT_PARTS; ++k) ap[k][i] = p[k];
        }
      }
#pragma unroll
      for (int np = 0; np < 64; np += 16) {
        if (np < d.P) {
          uint32_t bq[4];
          // B[t][p] = dy_t[p], stored [t][p]: read transposed
          ldsm_x4_t(bq, sDy + (k0 + (mi & 1) * 8 + r8) * ldp + np +
                            (mi >> 1) * 8);
#pragma unroll
          for (int k = 0; k < WEIGHT_PARTS; ++k) {
            mma(acc[np / 8], ap[k], bq[0], bq[1]);
            mma(acc[np / 8 + 1], ap[k], bq[2], bq[3]);
          }
        }
      }
    }
    // the D skip; rows inside the chunk and the sequence
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt * 8 >= d.P) continue;
      const int p = nt * 8 + 2 * q;
      if (jA < valid) {
        const float2 v =
            unpack(*reinterpret_cast<const uint32_t*>(sDy + jA * ldp + p));
        *reinterpret_cast<__nv_bfloat162*>(dxc + jA * dy_ss + p) =
            __floats2bfloat162_rn(acc[nt][0] + d_h * v.x,
                                  acc[nt][1] + d_h * v.y);
      }
      if (jB < valid) {
        const float2 v =
            unpack(*reinterpret_cast<const uint32_t*>(sDy + jB * ldp + p));
        *reinterpret_cast<__nv_bfloat162*>(dxc + jB * dy_ss + p) =
            __floats2bfloat162_rn(acc[nt][2] + d_h * v.x,
                                  acc[nt][3] + d_h * v.y);
      }
    }
  }
}

size_t tc_dx_smem(const Dims& d) {
  return (static_cast<size_t>(d.Qr) * (d.P + TPAD + d.N + TPAD) +
          static_cast<size_t>(STATE_PARTS) * d.P * (d.N + TPAD)) *
             sizeof(bf16) +
         3 * static_cast<size_t>(d.Qr) * sizeof(float);
}

// --------------------------------------------------------------- 4b. tc_dcb

// dCB, the tc_cb groups' partials summed in group order, as DCB_PARTS bf16
// parts (dcbp[(b, c)][part][t][j], the tile pairs on and below the
// diagonal), for tc_dbc's intra-chunk terms.  A thread a float4.
constexpr int DCB_THREADS = 256;

__global__ void __launch_bounds__(DCB_THREADS)
tc_dcb_kernel(float* __restrict__ ws, Dims d) {
  const int c = blockIdx.y, b = blockIdx.z;
  const int e4 = blockIdx.x * DCB_THREADS + threadIdx.x;
  if (e4 >= d.pairs * TILE * TILE / 4) return;
  int pr = e4 / (TILE * TILE / 4), ti = 0;
  const int w = e4 - pr * (TILE * TILE / 4);
  while (pr > ti) pr -= ++ti;
  const int t = ti * TILE + w / (TILE / 4), j = pr * TILE + (w % (TILE / 4)) * 4;
  const ll bc = static_cast<ll>(b) * d.nc + c;
  const ll QQ = static_cast<ll>(d.Qr) * d.Qr;
  const ll gstride = static_cast<ll>(d.Bt) * d.nc * QQ;
  const float* src = ws + d.dcb + bc * QQ + static_cast<ll>(t) * d.Qr + j;
  float4 v[CB_GROUPS];
#pragma unroll
  for (int gg = 0; gg < CB_GROUPS; ++gg)
    if (gg < d.cbg)
      v[gg] = *reinterpret_cast<const float4*>(src + gg * gstride);
  float4 sum = v[0];
#pragma unroll
  for (int gg = 1; gg < CB_GROUPS; ++gg) {
    if (gg < d.cbg) {
      sum.x += v[gg].x;
      sum.y += v[gg].y;
      sum.z += v[gg].z;
      sum.w += v[gg].w;
    }
  }
  uint32_t lo[DCB_PARTS], hi[DCB_PARTS];
  split_n<DCB_PARTS>(sum.x, sum.y, lo);
  split_n<DCB_PARTS>(sum.z, sum.w, hi);
  bf16* dst = reinterpret_cast<bf16*>(ws + d.dcbp) + bc * DCB_PARTS * QQ +
              static_cast<ll>(t) * d.Qr + j;
#pragma unroll
  for (int k = 0; k < DCB_PARTS; ++k)
    *reinterpret_cast<uint2*>(dst + k * QQ) = make_uint2(lo[k], hi[k]);
}

// --------------------------------------------------------------- 5. tc_dbc

// One block of four warps per (batch, chunk, 64-row tile, group of heads,
// side); warp w owns rows 16 w .. + 15.  Groups [0, hg), over the group's
// heads in order, the next head's tiles in flight while this one's
// product runs: side 0 U = dy_t h_in, dC += exp(a_t) U and exp(a_t) C_t .
// U_t -> dain; side 1 V = x_j G, dB += w_j V and B_j . V_j -> dwb; h_in and
// G as their parts, the row dot products from the fragments.  The last
// group: the intra-chunk terms, dC_t += sum_{j <= t} dCB[t][j] B_j and dB_j
// += sum_{t >= j} dCB[t][j] C_t, each dCB tile the tc_cb groups' partials
// summed in order and split into parts.  Each group writes its partial of
// dB and dC; bwd_sum adds them in order.
constexpr int DBC_THREADS = 128;

__device__ void tc_dbc_intra(const bf16* __restrict__ Bm,
                             const bf16* __restrict__ Cm,
                             float* __restrict__ ws, const Dims& d,
                             const Strides& st, unsigned char* smem, int rt,
                             int c, int b, int side) {
  constexpr int LDT = TILE + TPAD;
  const int ldn = d.N + TPAD;
  // [2 stages]: dCB parts [parts][64][LDT], B_j or C_t rows [64][ldn]
  const int stage = DCB_PARTS * TILE * LDT + TILE * ldn;
  bf16* sS = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int m0 = warp * 16;
  const int s0 = c * d.Q, valid = min(d.Q, d.S - s0);
  const ll QQ = static_cast<ll>(d.Qr) * d.Qr;
  const bf16* parts = reinterpret_cast<const bf16*>(ws + d.dcbp) +
                      (static_cast<ll>(b) * d.nc + c) * DCB_PARTS * QQ;
  // side 0, dC: tiles (rt, tj <= rt) with B_j; side 1, dB: tiles (ti >= rt,
  // rt) with C_t
  const int n_tiles = side ? d.nt - rt : rt + 1;
  auto load_tile = [&](int k, int s) {
    const int ti = side ? rt + k : rt, tj = side ? rt : k;
    const int r0 = (side ? ti : tj) * TILE;
    bf16* sd = sS + s * stage;
    const bf16* src = parts + static_cast<ll>(ti) * TILE * d.Qr + tj * TILE;
#pragma unroll
    for (int p = 0; p < DCB_PARTS; ++p)
      load_rows8<DBC_THREADS>(sd + p * TILE * LDT, LDT, parts, src + p * QQ,
                              d.Qr, TILE, TILE, TILE);
    load_rows8<DBC_THREADS>(
        sd + DCB_PARTS * TILE * LDT, ldn, side ? Cm : Bm,
        side ? Cm + b * st.c_sb + (s0 + r0) * st.c_ss
             : Bm + b * st.b_sb + (s0 + r0) * st.b_ss,
        side ? st.c_ss : st.b_ss, TILE, valid - r0, d.N);
  };
  float acc[8][4];
  zero(acc);
  load_tile(0, 0);
  cp_commit();
  for (int k = 0; k < n_tiles; ++k) {
    const int s = k & 1;
    cp_wait<0>();
    __syncthreads();
    if (k + 1 < n_tiles) {
      load_tile(k + 1, s ^ 1);
      cp_commit();
    }
    const bf16* sT = sS + s * stage;
    const bf16* sR = sT + DCB_PARTS * TILE * LDT;
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 16) {
      uint32_t ap[DCB_PARTS][4];
#pragma unroll
      for (int p = 0; p < DCB_PARTS; ++p) {
        const bf16* t = sT + p * TILE * LDT;
        if (side)   // A[j][t] = dCB[t][j], stored [t][j]: read transposed
          ldsm_x4_t(ap[p], t + (kk + (mi >> 1) * 8 + r8) * LDT + m0 +
                               (mi & 1) * 8);
        else        // A[t][j] = dCB[t][j], row-major
          ldsm_x4(ap[p], t + (m0 + (mi & 1) * 8 + r8) * LDT + kk +
                             (mi >> 1) * 8);
      }
#pragma unroll
      for (int nn = 0; nn < 64; nn += 16) {
        if (nn < d.N) {
          uint32_t bq[4];
          // B[j][n] = B_j[n] (or C_t[n]), stored [j][n]: read transposed
          ldsm_x4_t(bq, sR + (kk + (mi & 1) * 8 + r8) * ldn + nn +
                            (mi >> 1) * 8);
#pragma unroll
          for (int p = 0; p < DCB_PARTS; ++p) {
            mma(acc[nn / 8], ap[p], bq[0], bq[1]);
            mma(acc[nn / 8 + 1], ap[p], bq[2], bq[3]);
          }
        }
      }
    }
  }
  const int tA = rt * TILE + m0 + g, tB = tA + 8;
  float* out = ws + (side ? d.dbp : d.dcp) +
               ((static_cast<ll>(d.hg) * d.Bt + b) * d.S + s0) * d.N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt * 8 >= d.N) continue;
    const int n = nt * 8 + 2 * q;
    if (tA < valid)
      *reinterpret_cast<float2*>(out + static_cast<ll>(tA) * d.N + n) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (tB < valid)
      *reinterpret_cast<float2*>(out + static_cast<ll>(tB) * d.N + n) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

__global__ void __launch_bounds__(DBC_THREADS, 3)
tc_dbc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
              const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
              const bf16* __restrict__ dy, float* __restrict__ ws, Dims d,
              Strides st) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int rt = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / (2 * d.hg + 2), z = blockIdx.z % (2 * d.hg + 2);
  if (z >= 2 * d.hg) {
    tc_dbc_intra(Bm, Cm, ws, d, st, tc_smem, rt, c, b, z - 2 * d.hg);
    return;
  }
  const int grp = z >> 1, side = z & 1;   // side 0: U, dC; 1: V, dB
  const int ldn = d.N + TPAD, ldp = d.P + TPAD;
  const int stage = TILE * ldp + STATE_PARTS * d.P * ldn;   // bf16
  bf16* sRow = reinterpret_cast<bf16*>(tc_smem);  // [64][ldn]: C_t or B_j
  // [2 stages]: dy_t or x_j [64][ldp], h_in or G parts [parts][P][ldn]
  bf16* sS = sRow + TILE * ldn;
  float* s_f = reinterpret_cast<float*>(sS + 2 * stage);  // [heads][64]
  float* s_dt = s_f + d.hpg * TILE;                        // [heads][64]
  float* s_al = s_dt + d.hpg * TILE;                       // [heads]
  const int tid = threadIdx.x, t0 = rt * TILE;
  const int s0 = c * d.Q, valid = min(d.Q, d.S - s0);
  const int h_lo = grp * d.hpg, nh = min(d.H - h_lo, d.hpg);
  const ll dy_ss = static_cast<ll>(d.H) * d.P;
  const ll PN = static_cast<ll>(d.P) * d.N;
  if (side)
    load_rows8<DBC_THREADS>(sRow, ldn, Bm,
                           Bm + b * st.b_sb + (s0 + t0) * st.b_ss, st.b_ss,
                           TILE, valid - t0, d.N);
  else
    load_rows8<DBC_THREADS>(sRow, ldn, Cm,
                           Cm + b * st.c_sb + (s0 + t0) * st.c_ss, st.c_ss,
                           TILE, valid - t0, d.N);
  // a_t and a_Q, and for side 1 dt_t
  float* s_a = s_f;
  for (int e = tid; e < nh * 16; e += DBC_THREADS) {
    const int hh = e >> 4, k = (e & 15) * 4;
    const float* ac = ws + d.acum +
        ((static_cast<ll>(b) * d.H + h_lo + hh) * d.nc + c) * d.Qr;
    cp16(s_a + hh * TILE + k, ac + t0 + k, true);
    if (k == 0) cp4(s_al + hh, ac + d.Q - 1, true);
  }
  for (int e = tid; side && e < nh * TILE; e += DBC_THREADS) {
    const int r = e / nh, hh = e - r * nh, t = t0 + r;
    cp4(s_dt + hh * TILE + r,
        t < valid ? dt + (static_cast<ll>(b) * d.S + s0 + t) * d.H + h_lo + hh
                  : dt,
        t < valid);
  }
  cp_wait_all();
  __syncthreads();
  // exp(a_t), or w_t = exp(a_Q - a_t) dt_t, in place of a_t
  for (int e = tid; e < nh * TILE; e += DBC_THREADS) {
    const int hh = e >> 6, t = t0 + (e & 63);
    const float at = s_a[e];
    s_f[e] = t >= d.Q ? 0.f
             : side   ? expf(s_al[hh] - at) * s_dt[e]
                      : expf(at);
  }
  auto load_head = [&](int hh, int s) {
    const int h = h_lo + hh;
    const ll bch = (static_cast<ll>(b) * d.nc + c) * d.H + h;
    bf16* sd = sS + s * stage;
    if (side)
      load_rows8<DBC_THREADS>(sd, ldp, x,
                             x + b * st.x_sb + (s0 + t0) * st.x_ss + h * d.P,
                             st.x_ss, TILE, valid - t0, d.P);
    else
      load_rows8<DBC_THREADS>(
          sd, ldp, dy,
          dy + (static_cast<ll>(b) * d.S + s0 + t0) * dy_ss + h * d.P, dy_ss,
          TILE, valid - t0, d.P);
    const bf16* pp = reinterpret_cast<const bf16*>(
                         ws + (side ? d.gpart : d.hpart)) +
                     bch * STATE_PARTS * PN;
#pragma unroll
    for (int k = 0; k < STATE_PARTS; ++k)
      load_rows8<DBC_THREADS>(sd + TILE * ldp + k * d.P * ldn, ldn, pp,
                             pp + k * PN, d.N, d.P, d.P, d.N);
  };
  load_head(0, 0);
  cp_commit();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int m0 = warp * 16, tlA = m0 + g, tlB = tlA + 8;
  float acc[8][4];
  zero(acc);
  for (int hh = 0; hh < nh; ++hh) {
    const int s = hh & 1;
    cp_wait<0>();         // this head's tiles
    __syncthreads();      // ... everyone's, and the last head done
    if (hh + 1 < nh) {
      load_head(hh + 1, s ^ 1);
      cp_commit();
    }
    const bf16* sa = sS + s * stage;
    const bf16* sp = sa + TILE * ldp;
    float u[8][4];
    zero(u);
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      if (kk >= d.P) break;
      uint32_t a[4];
      // A[t][p] = dy_t[p] (or x_j[p]), row-major
      ldsm_x4(a, sa + (m0 + (mi & 1) * 8 + r8) * ldp + kk + (mi >> 1) * 8);
#pragma unroll
      for (int nn = 0; nn < 64; nn += 16) {
        if (nn < d.N) {
#pragma unroll
          for (int k = 0; k < STATE_PARTS; ++k) {
            uint32_t bq[4];
            // B[p][n] = h_in[p][n] (or G), stored [p][n]: read transposed
            ldsm_x4_t(bq, sp + k * d.P * ldn + (kk + (mi & 1) * 8 + r8) * ldn +
                              nn + (mi >> 1) * 8);
            mma(u[nn / 8], a, bq[0], bq[1]);
            mma(u[nn / 8 + 1], a, bq[2], bq[3]);
          }
        }
      }
    }
    const float fA = s_f[hh * TILE + tlA], fB = s_f[hh * TILE + tlB];
    float dotA = 0.f, dotB = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt * 8 >= d.N) continue;
      const int n = nt * 8 + 2 * q;
      acc[nt][0] += fA * u[nt][0];
      acc[nt][1] += fA * u[nt][1];
      acc[nt][2] += fB * u[nt][2];
      acc[nt][3] += fB * u[nt][3];
      const float2 vA =
          unpack(*reinterpret_cast<const uint32_t*>(sRow + tlA * ldn + n));
      const float2 vB =
          unpack(*reinterpret_cast<const uint32_t*>(sRow + tlB * ldn + n));
      dotA += vA.x * u[nt][0] + vA.y * u[nt][1];
      dotB += vB.x * u[nt][2] + vB.y * u[nt][3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      dotA += __shfl_xor_sync(0xffffffffu, dotA, o);
      dotB += __shfl_xor_sync(0xffffffffu, dotB, o);
    }
    if (q == 0) {
      const ll bch = (static_cast<ll>(b) * d.nc + c) * d.H + h_lo + hh;
      float* o = ws + (side ? d.dwb : d.dain) + bch * d.Qr + t0;
      o[tlA] = side ? dotA : fA * dotA;
      o[tlB] = side ? dotB : fB * dotB;
    }
  }
  const int tA = t0 + tlA, tB = t0 + tlB;
  float* out = ws + (side ? d.dbp : d.dcp) +
               ((static_cast<ll>(grp) * d.Bt + b) * d.S + s0) * d.N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt * 8 >= d.N) continue;
    const int n = nt * 8 + 2 * q;
    if (tA < valid)
      *reinterpret_cast<float2*>(out + static_cast<ll>(tA) * d.N + n) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (tB < valid)
      *reinterpret_cast<float2*>(out + static_cast<ll>(tB) * d.N + n) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

size_t tc_dbc_smem(const Dims& d) {
  const size_t ldn = d.N + TPAD, ldp = d.P + TPAD;
  const size_t loop =
      (TILE * ldn + 2 * (TILE * ldp + STATE_PARTS * d.P * ldn)) *
          sizeof(bf16) +
      (2 * static_cast<size_t>(d.hpg) * TILE + d.hpg) * sizeof(float);
  const size_t intra =
      2 * (static_cast<size_t>(DCB_PARTS) * TILE * (TILE + TPAD) +
           TILE * ldn) * sizeof(bf16);
  return loop > intra ? loop : intra;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// passes 6 and 7, shared by the two routes
template <typename T>
cudaError_t launch_tail(const void* x, const void* dt, const void* A,
                        const void* dy, void* ddt, void* dA, void* dB,
                        void* dC, void* dD, void* ws, const Dims& d,
                        const Strides& st, cudaStream_t stream) {
  auto* wsf = static_cast<float*>(ws);
  cudaError_t err;
  const size_t s6 = (4 * d.Qr + THREADS / 32) * sizeof(float);
  if ((err = allow_smem(bwd_da_kernel<T>, s6)) != cudaSuccess) return err;
  bwd_da_kernel<T><<<dim3(d.H, d.nc, d.Bt), THREADS, s6, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(dy),
      static_cast<float*>(ddt), wsf, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const ll nel = static_cast<ll>(d.Bt) * d.S * d.N;
  const unsigned blocks = static_cast<unsigned>((nel + THREADS - 1) / THREADS);
  bwd_sum_kernel<T><<<blocks + 1, THREADS, 0, stream>>>(
      static_cast<T*>(dB), static_cast<T*>(dC), static_cast<float*>(dA),
      static_cast<float*>(dD), wsf, d);
  return cudaGetLastError();
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

  return launch_tail<T>(x, dt, A, dy, ddt, dA, dB, dC, dD, ws, d, st, stream);
}


// The tensor-core route (bf16): tc_chunk, bwd_state (writing the states'
// parts), tc_cb, tc_dx, tc_dbc, then bwd_da and bwd_sum.
cudaError_t launch_tc(const void* x, const void* dt, const void* A,
                      const void* B, const void* C, const void* D,
                      const void* h0, const void* dy, const void* dh_final,
                      void* dx, void* ddt, void* dA, void* dB, void* dC,
                      void* dD, void* dh0, void* ws, const Dims& d,
                      const Strides& st, cudaStream_t stream) {
  const auto* xt = static_cast<const bf16*>(x);
  const auto* Bp = static_cast<const bf16*>(B);
  const auto* Cp = static_cast<const bf16*>(C);
  const auto* dyt = static_cast<const bf16*>(dy);
  const auto* dtf = static_cast<const float*>(dt);
  auto* wsf = static_cast<float*>(ws);
  cudaError_t err;

  const size_t s1 = tc_chunk_smem(d);
  if ((err = allow_smem(tc_chunk_kernel, s1)) != cudaSuccess) return err;
  tc_acum_kernel<<<dim3((d.H + ACUM_HEADS - 1) / ACUM_HEADS, d.nc, d.Bt),
                   ACUM_THREADS, 0, stream>>>(
      dtf, static_cast<const float*>(A), wsf, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  tc_chunk_kernel<<<dim3(2 * d.H, d.nc, d.Bt), CHUNK_THREADS, s1, stream>>>(
      xt, dtf, Bp, Cp, dyt, wsf, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  bwd_state_kernel<<<dim3(d.sblk, d.H, d.Bt), STATE_THREADS, 0, stream>>>(
      static_cast<const float*>(h0), static_cast<const float*>(dh_final),
      static_cast<float*>(dh0), wsf, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t s3 = tc_cb_smem(d);
  if ((err = allow_smem(tc_cb_kernel, s3)) != cudaSuccess) return err;
  tc_cb_kernel<<<dim3(d.pairs, d.nc, d.Bt * d.cbg), CB_THREADS, s3,
                 stream>>>(xt, dtf, Bp, Cp, dyt, wsf, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t s4 = tc_dx_smem(d);
  if ((err = allow_smem(tc_dx_kernel, s4)) != cudaSuccess) return err;
  tc_dx_kernel<<<dim3(d.H, d.nc, d.Bt), DX_THREADS, s4, stream>>>(
      dtf, Bp, static_cast<const float*>(D), dyt, static_cast<bf16*>(dx), wsf,
      d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  tc_dcb_kernel<<<dim3((d.pairs * TILE * TILE / 4 + DCB_THREADS - 1) /
                            DCB_THREADS,
                        d.nc, d.Bt),
                   DCB_THREADS, 0, stream>>>(wsf, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t s5 = tc_dbc_smem(d);
  if ((err = allow_smem(tc_dbc_kernel, s5)) != cudaSuccess) return err;
  tc_dbc_kernel<<<dim3(d.nt, d.nc, d.Bt * (2 * d.hg + 2)), DBC_THREADS, s5,
                  stream>>>(xt, dtf, Bp, Cp, dyt, wsf, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  return launch_tail<bf16>(x, dt, A, dy, ddt, dA, dB, dC, dD, ws, d, st,
                           stream);
}

bool dims_ok(int Bt, int S, int H, int P, int N, int Q) {
  return Bt >= 1 && Bt <= 65535 && S >= 1 && H >= 1 && H <= 65535 &&
         P >= 1 && P <= TILE && N >= 1 && N <= TILE && Q >= 1 && Q <= S &&
         Q <= 4096 && (S + Q - 1) / Q <= 65535;
}

// What the tensor-core route takes: P and N multiples of 16 up to 64,
// chunks of at most 256 rows, grids and shared memory within the card's
// limits.
bool tc_dims_ok(int Bt, int S, int H, int P, int N, int Q) {
  if (!dims_ok(Bt, S, H, P, N, Q) || P % 16 || N % 16 || Q > QMAX_TC)
    return false;
  const Dims d = make_dims(Bt, S, H, P, N, Q, true);
  constexpr size_t smem_max = 232448;
  return static_cast<ll>(Bt) * d.cbg <= 65535 &&
         static_cast<ll>(Bt) * (2 * d.hg + 2) <= 65535 &&
         tc_cb_smem(d) <= smem_max && tc_dbc_smem(d) <= smem_max;
}

}  // namespace ssd_bwd

// fp32 elements of the workspace a call needs (its scratch buffers), or
// -1 for dimensions the kernels do not take.
extern "C" long long ssd_scan_bwd_workspace(int Bt, int S, int H, int P,
                                            int N, int Q) {
  if (!ssd_bwd::dims_ok(Bt, S, H, P, N, Q)) return -1;
  return ssd_bwd::make_dims(Bt, S, H, P, N, Q, false).total;
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
  const Dims d = make_dims(Bt, S, H, P, N, Q, false);
  const Strides st{x_sb, x_ss, b_sb, b_ss, c_sb, c_ss};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, dt, A, B, C, D, h0, dy, dh_final, dx, ddt,
                                 dA, dB, dC, dD, dh0, ws, d, st, s);
  return launch<float>(x, dt, A, B, C, D, h0, dy, dh_final, dx, ddt, dA, dB,
                       dC, dD, dh0, ws, d, st, s);
}

// The tensor-core route's workspace (fp32 elements), or -1 for dimensions
// it does not take (the wrapper then takes the scalar route).
extern "C" long long ssd_scan_bwd_tc_workspace(int Bt, int S, int H, int P,
                                               int N, int Q) {
  if (!ssd_bwd::tc_dims_ok(Bt, S, H, P, N, Q)) return -1;
  return ssd_bwd::make_dims(Bt, S, H, P, N, Q, true).total;
}

// The tensor-core route: the arguments of ssd_scan_bwd_launch, x, B, C, dy,
// dx, dB and dC bf16, bases and (batch, sequence) strides 16-byte aligned;
// ws of ssd_scan_bwd_tc_workspace's size.
extern "C" int ssd_scan_bwd_tc_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* D, const void* h0, const void* dy,
    const void* dh_final, void* dx, void* ddt, void* dA, void* dB, void* dC,
    void* dD, void* dh0, void* ws, int Bt, int S, int H, int P, int N, int Q,
    long long x_sb, long long x_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, void* stream) {
  using namespace ssd_bwd;
  if (!tc_dims_ok(Bt, S, H, P, N, Q)) return cudaErrorInvalidValue;
  const Dims d = make_dims(Bt, S, H, P, N, Q, true);
  const Strides st{x_sb, x_ss, b_sb, b_ss, c_sb, c_ss};
  return launch_tc(x, dt, A, B, C, D, h0, dy, dh_final, dx, ddt, dA, dB, dC,
                   dD, dh0, ws, d, st, static_cast<cudaStream_t>(stream));
}
