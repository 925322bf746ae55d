// The mLSTM chunked scan (xLSTM's matrix memory), forward and backward.
//
// Replaces no TPU kernel: the reference runs the chunk recurrence as one
// jax.lax.scan of its chunk_step (src/repro/kernels/ops.py:439, scanned at
// :473) inside the vmem_fused_mlstm scope, which XLA compiles into one
// loop on the device; the port ran it as a Python loop of ~49 launches a
// chunk forward and ~115 backward.  The backward stands for autodiff of
// that scan.
//
// Per (batch row, head), chunk of Q positions t with the carry (C, n, m)
// entering it, G the chunk's cumulative logsigmoid(f), d[t, j] = G_t - G_j
// + i_j (j <= t), mloc_t = max_j d[t, j], scale = 1 / sqrt(Dk):
//     m_t  = max(m + G_t, mloc_t),  w[t, j] = exp(d[t, j] - m_t)
//     P    = (scale q k^T) w,  X_t = scale exp(m + G_t - m_t)
//     N_t  = P v + X_t q_t C,   D'_t = sum_j P[t, j] + X_t q_t . n
//     h_t  = N_t / max(|D'_t|, exp(-m_t))
// and at the chunk's end, L = Q - 1, m' = m_L, cw_j = exp(G_L - G_j + i_j
// - m'), dec = exp(m + G_L - m'): C' = dec C + sum_j cw_j k_j v_j^T, n' =
// dec n + sum_j cw_j k_j.  Positions past S are the plain loop's padding
// (i = -1e30, f = 80, q = k = v = 0).
//
// Bound on the H100: operations.  At xlstm_350m's shape (B 4, H 4, S
// 2048, Dk 256, Dv 512, Q 256) a layer's forward is 23.6 GFLOP over the
// causal pairs (0.35 ms at 67 TFLOP/s in fp32) against ~109 MB of q, k,
// v, gates, h and carry (0.033 ms).  No (row, head) fits one SM: a
// chunk's q and k are 256 KB each in fp32, v 512 KB, the carry 512 KB.
// So the work is cut into tiles over the chunk's rows and over Dv, each
// CTA a tile, and every chunk is in flight at once:
//   1. mlstm_gates_kernel, a CTA a (row, head, chunk): G (one thread sums
//      the chunk in order) and mloc (a thread a row);
//   2. mlstm_carry_kernel, a CTA a (row, head, 64 x 128 tile of C): the
//      carry chunk by chunk, as the scan carries it (dec C + (k cw)^T v),
//      writing the carry entering each chunk; the m chain is scalar and
//      every CTA follows it;
//   3. mlstm_out_kernel, a CTA a (row, head, chunk, 64 rows, 128 of Dv):
//      q C and q . n from the entering carry, then the causal 64 x 64 tiles
//      of q k^T (the full Dk, so D' is whole in each CTA), weighted, and
//      their product with v; h in the inputs' dtype (and, for the
//      backward, in fp32 with D').
// Every product is fp32 FMAs on the CUDA cores (no TF32), a thread
// summing a 4 x 4 to 4 x 16 tile of its output from k-major slices of 16
// staged in shared memory (rows padded by one float: no bank conflicts).
// The scores are recomputed by each of the four Dv tiles of a row tile.
//
// The backward holds every m constant (h does not depend on it: N and D'
// both carry exp(-m_t)), so w, X and the decays are differentiated through
// d, G, i and the entering m alone, and the carried m's own cotangent
// cancels against the carry's; only the final carry's m path, p = dm -
// sum(C dC) - sum(n dn), goes back through the chain of maxima that set
// it (kernels/mlstm.py's mlstm_scan_bwd_torch, the same formulas in plain
// PyTorch, says why).  Six kernels, from the carries and rows the forward
// saved:
//   1. mlstm_bwd_prep_kernel, a warp a position: den, and dD' = -(dh . h)
//      / den where |D'| > exp(-m) (half at a tie) times sign(D');
//   2. mlstm_dcarry_kernel, a CTA a tile of C: the carry's cotangent in
//      reverse chunk order, dC_in = dec dC_out + (q X)^T (dh / den) (and
//      n's with dD'), writing each chunk's outgoing one, and the per-tile
//      sums of C . dC the decays' and the m path's cotangents need;
//   3. mlstm_bwd_rows_kernel, a CTA a (chunk, 64 rows): dq over the full
//      Dk (the inter term first, whose q . dq_inter is exp(m + G - m)'s
//      cotangent), the causal tiles' ds = (dP w) scale, dP = (dh / den)
//      v^T + dD', and the row sums of dd = dP P;
//   4. mlstm_bwd_dv_kernel, a CTA a (chunk, 32 columns j): dv over the
//      full Dv, cw (k dC_out) and P^T (dh / den);
//   5. mlstm_bwd_dk_kernel, a CTA a (chunk, 64 columns j): dk over the
//      full Dk, cw (v dC_out^T + dn_out) and ds^T q, the column sums of
//      dd and cw's cotangent;
//   6. mlstm_bwd_gates_kernel, a CTA a (row, head): dG and di from those
//      row and column sums, the decays' cotangents, the m path through
//      each chunk's maximum (half at a tie, the amax's ties evenly), then
//      G's cumulative sum backwards and logsigmoid's gradient.
// Every sum runs in a fixed order (no atomics): two calls on the same
// inputs give the same bits.
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;

constexpr int NT = 256;     // threads a CTA, 16 x 16
constexpr int KC = 16;      // depth of one staged slice of a product
constexpr int MAXQ = 256;   // the largest chunk
constexpr int MAXDK = 256;  // the widest q and k
constexpr int MAXDV = 512;  // the widest v
constexpr int TR = 64;      // positions a tile
constexpr int CT = 128;     // Dv columns of a carry or output tile

// ATen's CUDA forms (opmath float): logsigmoid min(0, x) - log1p(exp(-|x|))
// and its gradient grad * sigmoid(-x)
__device__ __forceinline__ float logsigmoid_f(float x) {
  return __fsub_rn(fminf(0.0f, x), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float logsigmoid_bwd(float x, float grad) {
  const bool neg = x < 0.0f;
  const float max_deriv = neg ? 1.0f : 0.0f;
  const float sign = neg ? 1.0f : -1.0f;
  const float e = expf(-fabsf(x));
  const float s = __fdiv_rn(e, __fadd_rn(1.0f, e));
  return __fmul_rn(grad, __fsub_rn(max_deriv, __fmul_rn(sign, s)));
}

// q, k, v or dh: (B, H, S, D) at strides (b, h, s) in elements, D
// contiguous
template <typename T>
struct Rows {
  const T* p;
  ll sb, sh, ss;
  __device__ __forceinline__ float at(int b, int h, int s, int d) const {
    return to_f32(p[b * sb + h * sh + s * ss + d]);
  }
};

// a gate: (B, H, S) at strides (b, h, s)
template <typename T>
struct Gate {
  const T* p;
  ll sb, sh, ss;
  __device__ __forceinline__ float at(int b, int h, int s) const {
    return to_f32(p[b * sb + h * sh + s * ss]);
  }
};

// acc[i][j] += sum_k A[k][ty TM + i] B[k][tx + 16 j] over one slice of KC,
// A and B k-major with row pitches lda and ldb; thread (ty, tx) = (tid /
// 16, tid % 16).  Within a warp the A reads are two broadcasts and the B
// reads 16 consecutive floats.
template <int TM, int TN>
__device__ __forceinline__ void mac(float (&acc)[TM][TN], const float* A,
                                    int lda, const float* Bm, int ldb) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = A[k * lda + ty * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bm[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
}

// dst[k (M + 1) + m] = f(m, k) for m < M, k < KC.  KFAST: consecutive
// threads take consecutive k (a source contiguous along k), else
// consecutive m.
template <int M, bool KFAST, class Fn>
__device__ __forceinline__ void stage(float* dst, Fn f) {
  for (int e = threadIdx.x; e < M * KC; e += NT) {
    const int m = KFAST ? e / KC : e % M;
    const int k = KFAST ? e % KC : e / M;
    dst[k * (M + 1) + m] = f(m, k);
  }
}

// the sum over the 16 threads of a row group (tx), on each of them
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the CTA's sum of v, on thread 0, in a fixed order
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// the chunk's G and i (NEG_INF past S) into shared memory
template <typename T>
__device__ __forceinline__ void load_gi(float* sG, float* si, const float* G,
                                        Gate<T> ig, int b, int h, int c,
                                        int Q, int S) {
  for (int t = threadIdx.x; t < Q; t += NT) {
    const int s = c * Q + t;
    sG[t] = G[s];
    si[t] = s < S ? ig.at(b, h, s) : NEG_INF;
  }
}

// ----------------------------------------------------------------- forward

template <typename T>
__global__ void __launch_bounds__(NT)
    mlstm_gates_kernel(Gate<T> ig, Gate<T> fg, float* __restrict__ G,
                       float* __restrict__ mloc, int H, int S, int Q) {
  __shared__ float sG[MAXQ], si[MAXQ];
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const ll row = static_cast<ll>(bh) * gridDim.x * Q + c * Q;
  for (int t = threadIdx.x; t < Q; t += NT) {
    const int s = c * Q + t;
    sG[t] = logsigmoid_f(s < S ? fg.at(b, h, s) : 80.0f);
    si[t] = s < S ? ig.at(b, h, s) : NEG_INF;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // in order, as the plain loop's cumsum
    float acc = sG[0];
    for (int t = 1; t < Q; ++t) sG[t] = acc = add(acc, sG[t]);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < Q; t += NT) {
    const float g = sG[t];
    float mx = -INFINITY;
    for (int j = 0; j <= t; ++j) mx = fmaxf(mx, add(sub(g, sG[j]), si[j]));
    G[row + t] = g;
    mloc[row + t] = mx;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) mlstm_carry_kernel(
    Rows<T> kr, Rows<T> vr, Gate<T> ig, const float* __restrict__ C0,
    const float* __restrict__ n0, const float* __restrict__ m0,
    const float* __restrict__ G, const float* __restrict__ mloc,
    float* __restrict__ Cin, float* __restrict__ nin,
    float* __restrict__ min_, float* __restrict__ Cf, float* __restrict__ nf,
    float* __restrict__ mf, int H, int S, int Q, int nc, int Dk, int Dv) {
  constexpr int TM = 4, TN = 8, M = TR, N = CT;
  __shared__ float As[KC * (M + 1)], Bs[KC * (N + 1)], scw[MAXQ];
  const int nvt = (Dv + N - 1) / N;
  const int kt = blockIdx.x / nvt, vt = blockIdx.x % nvt;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const bool n_owner = vt == 0 && tx == 0;
  const ll Sp = static_cast<ll>(nc) * Q, DD = static_cast<ll>(Dk) * Dv;
  const float* Gr = G + bh * Sp;
  const float* Mr = mloc + bh * Sp;

  float acc[TM][TN], nacc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int kk = kt * M + ty * TM + i;
    nacc[i] = (n0 && kk < Dk) ? n0[bh * Dk + kk] : 0.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int vv = vt * N + tx + 16 * j;
      acc[i][j] = (C0 && kk < Dk && vv < Dv) ? C0[bh * DD + kk * Dv + vv]
                                             : 0.0f;
    }
  }
  float m = m0 ? m0[bh] : -INFINITY;
  auto store = [&](float* Cd, float* nd) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int kk = kt * M + ty * TM + i;
      if (kk >= Dk) continue;
      if (n_owner) nd[kk] = nacc[i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int vv = vt * N + tx + 16 * j;
        if (vv < Dv) Cd[kk * Dv + vv] = acc[i][j];
      }
    }
  };
  for (int c = 0; c < nc; ++c) {
    store(Cin + (bh * nc + c) * DD, nin + (static_cast<ll>(bh) * nc + c) * Dk);
    if (blockIdx.x == 0 && threadIdx.x == 0) min_[bh * nc + c] = m;
    const float GL = Gr[c * Q + Q - 1];
    const float mL = fmaxf(add(m, GL), Mr[c * Q + Q - 1]);
    const float dec = expf(sub(add(m, GL), mL));
    for (int t = threadIdx.x; t < Q; t += NT) {
      const int s = c * Q + t;
      const float it = s < S ? ig.at(b, h, s) : NEG_INF;
      scw[t] = expf(sub(add(sub(GL, Gr[c * Q + t]), it), mL));
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      nacc[i] = mul(nacc[i], dec);
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = mul(acc[i][j], dec);
    }
    __syncthreads();
    for (int j0 = 0; j0 < Q; j0 += KC) {
      stage<M, false>(As, [&](int mm, int k) {
        const int t = j0 + k, s = c * Q + t, kk = kt * M + mm;
        return (t < Q && s < S && kk < Dk) ? mul(kr.at(b, h, s, kk), scw[t])
                                           : 0.0f;
      });
      stage<N, false>(Bs, [&](int n, int k) {
        const int t = j0 + k, s = c * Q + t, vv = vt * N + n;
        return (t < Q && s < S && vv < Dv) ? vr.at(b, h, s, vv) : 0.0f;
      });
      __syncthreads();
      mac<TM, TN>(acc, As, M + 1, Bs, N + 1);
      if (n_owner)
        for (int k = 0; k < KC; ++k)
#pragma unroll
          for (int i = 0; i < TM; ++i)
            nacc[i] += As[k * (M + 1) + ty * TM + i];
      __syncthreads();
    }
    m = mL;
  }
  store(Cf + bh * DD, nf + static_cast<ll>(bh) * Dk);
  if (blockIdx.x == 0 && threadIdx.x == 0) mf[bh] = m;
}

template <typename T>
__global__ void __launch_bounds__(NT) mlstm_out_kernel(
    Rows<T> qr, Rows<T> kr, Rows<T> vr, Gate<T> ig,
    const float* __restrict__ G, const float* __restrict__ mloc,
    const float* __restrict__ Cin, const float* __restrict__ nin,
    const float* __restrict__ min_, T* __restrict__ hout, ll hb, ll hh,
    ll hs, float* __restrict__ Dp, float* __restrict__ h32, int H, int S,
    int Q, int nc, int Dk, int Dv, float scale) {
  constexpr int TM = 4, TN = 8, M = TR, N = CT;
  __shared__ float As[KC * (M + 1)], Bs[KC * (N + 1)], Ps[M * (M + 1)];
  __shared__ float sG[MAXQ], si[MAXQ], sm[M], siw[M], sn0[MAXDK];
  const int nvt = (Dv + N - 1) / N;
  const int tt = blockIdx.x / nvt, vt = blockIdx.x % nvt, c = blockIdx.y;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const ll Sp = static_cast<ll>(nc) * Q, DD = static_cast<ll>(Dk) * Dv;
  const float m0 = min_[bh * nc + c];
  const float* C0 = Cin + (bh * nc + c) * DD;
  load_gi(sG, si, G + bh * Sp, ig, b, h, c, Q, S);
  for (int k = threadIdx.x; k < Dk; k += NT)
    sn0[k] = nin[(static_cast<ll>(bh) * nc + c) * Dk + k];
  for (int r = threadIdx.x; r < M; r += NT) {
    const int t = tt * M + r;
    const ll at = bh * Sp + c * Q + t;
    const float a = t < Q ? add(m0, G[at]) : 0.0f;
    const float mt = t < Q ? fmaxf(a, mloc[at]) : 0.0f;
    sm[r] = mt;
    siw[r] = t < Q ? expf(sub(a, mt)) : 0.0f;
  }
  auto qrow = [&](int mm, int kk) {
    const int t = tt * M + mm, s = c * Q + t;
    return (t < Q && s < S && kk < Dk) ? qr.at(b, h, s, kk) : 0.0f;
  };

  // the inter-chunk term from the entering carry: ((q C) scale) iw and
  // ((q . n) scale) iw
  float acc[TM][TN], dpart[TM], dsum[TM];
  zero(acc);
#pragma unroll
  for (int i = 0; i < TM; ++i) dpart[i] = dsum[i] = 0.0f;
  for (int k0 = 0; k0 < Dk; k0 += KC) {
    stage<M, true>(As, [&](int mm, int k) { return qrow(mm, k0 + k); });
    stage<N, false>(Bs, [&](int n, int k) {
      const int kk = k0 + k, vv = vt * N + n;
      return (kk < Dk && vv < Dv) ? C0[kk * Dv + vv] : 0.0f;
    });
    __syncthreads();
    mac<TM, TN>(acc, As, M + 1, Bs, N + 1);
    const float nv = k0 + tx < Dk ? sn0[k0 + tx] : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i)
      dpart[i] = fmaf(As[tx * (M + 1) + ty * TM + i], nv, dpart[i]);
    __syncthreads();
  }
  float dx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float iw = siw[ty * TM + i];
    dx[i] = mul(mul(sum16(dpart[i]), scale), iw);
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = mul(mul(acc[i][j], scale), iw);
  }

  // the causal tiles of the chunk: P = (scale q k^T) w, then P v
  for (int jt = 0; jt <= tt; ++jt) {
    float sc[TM][4];
    zero(sc);
    for (int k0 = 0; k0 < Dk; k0 += KC) {
      stage<M, true>(As, [&](int mm, int k) { return qrow(mm, k0 + k); });
      stage<M, true>(Bs, [&](int mm, int k) {
        const int j = jt * M + mm, s = c * Q + j, kk = k0 + k;
        return (j < Q && s < S && kk < Dk) ? kr.at(b, h, s, kk) : 0.0f;
      });
      __syncthreads();
      mac<TM, 4>(sc, As, M + 1, Bs, M + 1);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i, t = tt * M + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int jl = tx + 16 * jj, j = jt * M + jl;
        float P = 0.0f;
        if (j <= t && t < Q) {
          const float w = expf(sub(add(sub(sG[t], sG[j]), si[j]), sm[r]));
          P = mul(mul(sc[i][jj], scale), w);
        }
        Ps[jl * (M + 1) + r] = P;
        dsum[i] += P;
      }
    }
    __syncthreads();
    for (int j0 = 0; j0 < M; j0 += KC) {
      stage<N, false>(Bs, [&](int n, int k) {
        const int j = jt * M + j0 + k, s = c * Q + j, vv = vt * N + n;
        return (j < Q && s < S && vv < Dv) ? vr.at(b, h, s, vv) : 0.0f;
      });
      __syncthreads();
      mac<TM, TN>(acc, Ps + j0 * (M + 1), M + 1, Bs, N + 1);
      __syncthreads();
    }
  }

  // h = N / max(|D'|, exp(-m))
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i, t = tt * M + r, s = c * Q + t;
    const float Dpr = add(sum16(dsum[i]), dx[i]);
    const float den = fmaxf(fabsf(Dpr), expf(-sm[r]));
    if (t >= Q) continue;
    if (Dp && vt == 0 && tx == 0) Dp[bh * Sp + c * Q + t] = Dpr;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int vv = vt * N + tx + 16 * j;
      if (vv >= Dv) continue;
      const float val = acc[i][j] / den;
      if (s < S) hout[b * hb + h * hh + s * hs + vv] = from_f32<T>(val);
      if (h32) h32[(bh * Sp + c * Q + t) * Dv + vv] = val;
    }
  }
}

// ---------------------------------------------------------------- backward

template <typename T>
__global__ void __launch_bounds__(NT) mlstm_bwd_prep_kernel(
    Rows<T> dhr, const float* __restrict__ h32, const float* __restrict__ G,
    const float* __restrict__ mloc, const float* __restrict__ min_,
    const float* __restrict__ Dp, float* __restrict__ wden,
    float* __restrict__ wdD, int H, int S, int Q, int nc, int Dv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * (NT / 32) + warp, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const ll Sp = static_cast<ll>(nc) * Q;
  if (s >= Sp) return;
  const ll at = bh * Sp + s;
  const float mt = fmaxf(add(min_[bh * nc + s / Q], G[at]), mloc[at]);
  const float dp = Dp[at], emt = expf(-mt), aD = fabsf(dp);
  const float den = fmaxf(aD, emt);
  float dot = 0.0f;
  if (s < S)
    for (int v = lane; v < Dv; v += 32)
      dot = fmaf(dhr.at(b, h, s, v), h32[at * Dv + v], dot);
  dot = warp_sum(dot);
  if (lane == 0) {
    const float dden = -dot / den;
    const float dabs = aD > emt ? dden : (aD < emt ? 0.0f : mul(dden, 0.5f));
    const float sgn = dp > 0.0f ? 1.0f : (dp < 0.0f ? -1.0f : 0.0f);
    wden[at] = den;
    wdD[at] = mul(dabs, sgn);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) mlstm_dcarry_kernel(
    Rows<T> qr, Rows<T> dhr, const float* __restrict__ G,
    const float* __restrict__ mloc, const float* __restrict__ min_,
    const float* __restrict__ Cin, const float* __restrict__ nin,
    const float* __restrict__ wden, const float* __restrict__ wdD,
    const float* __restrict__ dCf, const float* __restrict__ dnf,
    const float* __restrict__ Cf, const float* __restrict__ nf,
    const float* __restrict__ C0, const float* __restrict__ n0,
    float* __restrict__ dCout, float* __restrict__ dnout,
    float* __restrict__ parts, float* __restrict__ dC0,
    float* __restrict__ dn0, int H, int S, int Q, int nc, int Dk, int Dv,
    float scale) {
  constexpr int TM = 4, TN = 8, M = TR, N = CT;
  __shared__ float As[KC * (M + 1)], Bs[KC * (N + 1)];
  __shared__ float sX[MAXQ], sden[MAXQ], sdD[MAXQ], red[NT / 32];
  const int nvt = (Dv + N - 1) / N;
  const int kt = blockIdx.x / nvt, vt = blockIdx.x % nvt;
  const int tile = blockIdx.x, ntiles = gridDim.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const bool n_owner = vt == 0 && tx == 0;
  const ll Sp = static_cast<ll>(nc) * Q, DD = static_cast<ll>(Dk) * Dv;
  const float* Gr = G + bh * Sp;
  const float* Mr = mloc + bh * Sp;
  float* pr = parts + static_cast<ll>(bh) * (nc + 2) * ntiles;

  float acc[TM][TN], nacc[TM];
  // sum over the tile of acc . Cs (and nacc . ns on the n column)
  auto dot = [&](const float* Cs, const float* ns) {
    float v = 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int kk = kt * M + ty * TM + i;
      if (kk >= Dk) continue;
      if (n_owner) v = fmaf(nacc[i], ns[kk], v);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int vv = vt * N + tx + 16 * j;
        if (vv < Dv) v = fmaf(acc[i][j], Cs[kk * Dv + vv], v);
      }
    }
    return block_sum(v, red);
  };
  auto store = [&](float* Cd, float* nd) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int kk = kt * M + ty * TM + i;
      if (kk >= Dk) continue;
      if (n_owner) nd[kk] = nacc[i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int vv = vt * N + tx + 16 * j;
        if (vv < Dv) Cd[kk * Dv + vv] = acc[i][j];
      }
    }
  };
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int kk = kt * M + ty * TM + i;
    nacc[i] = (dnf && kk < Dk) ? dnf[bh * Dk + kk] : 0.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int vv = vt * N + tx + 16 * j;
      acc[i][j] = (dCf && kk < Dk && vv < Dv) ? dCf[bh * DD + kk * Dv + vv]
                                              : 0.0f;
    }
  }
  {
    const float v = dot(Cf + bh * DD, nf + static_cast<ll>(bh) * Dk);
    if (threadIdx.x == 0) pr[nc * ntiles + tile] = v;
  }
  for (int c = nc - 1; c >= 0; --c) {
    const ll cc = static_cast<ll>(bh) * nc + c;
    store(dCout + cc * DD, dnout + cc * Dk);
    {
      const float v = dot(Cin + cc * DD, nin + cc * Dk);
      if (threadIdx.x == 0) pr[c * ntiles + tile] = v;
    }
    const float m0 = min_[cc];
    const float GL = Gr[c * Q + Q - 1];
    const float mL = fmaxf(add(m0, GL), Mr[c * Q + Q - 1]);
    const float dec = expf(sub(add(m0, GL), mL));
    for (int t = threadIdx.x; t < Q; t += NT) {
      const float a = add(m0, Gr[c * Q + t]);
      const float mt = fmaxf(a, Mr[c * Q + t]);
      sX[t] = mul(expf(sub(a, mt)), scale);
      sden[t] = wden[bh * Sp + c * Q + t];
      sdD[t] = wdD[bh * Sp + c * Q + t];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      nacc[i] = mul(nacc[i], dec);
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = mul(acc[i][j], dec);
    }
    __syncthreads();
    for (int t0 = 0; t0 < Q; t0 += KC) {
      stage<M, false>(As, [&](int mm, int k) {
        const int t = t0 + k, s = c * Q + t, kk = kt * M + mm;
        return (t < Q && s < S && kk < Dk) ? mul(qr.at(b, h, s, kk), sX[t])
                                           : 0.0f;
      });
      stage<N, false>(Bs, [&](int n, int k) {
        const int t = t0 + k, s = c * Q + t, vv = vt * N + n;
        return (t < Q && s < S && vv < Dv) ? dhr.at(b, h, s, vv) / sden[t]
                                           : 0.0f;
      });
      __syncthreads();
      mac<TM, TN>(acc, As, M + 1, Bs, N + 1);
      if (n_owner)
        for (int k = 0; k < KC; ++k) {
          const float d = t0 + k < Q ? sdD[t0 + k] : 0.0f;
#pragma unroll
          for (int i = 0; i < TM; ++i)
            nacc[i] = fmaf(As[k * (M + 1) + ty * TM + i], d, nacc[i]);
        }
      __syncthreads();
    }
  }
  if (dC0) {
    store(dC0 + bh * DD, dn0 + static_cast<ll>(bh) * Dk);
    const float v = dot(C0 + bh * DD, n0 + static_cast<ll>(bh) * Dk);
    if (threadIdx.x == 0) pr[(nc + 1) * ntiles + tile] = v;
  }
}

// the chunk's per-position backward values into shared memory: G, i, m_t,
// den, dD'
template <typename T>
__device__ __forceinline__ void load_rows_bwd(
    float* sG, float* si, float* sm, float* sden, float* sdD, const float* G,
    const float* mloc, const float* wden, const float* wdD, float m0,
    Gate<T> ig, int b, int h, ll at0, int c, int Q, int S) {
  for (int t = threadIdx.x; t < Q; t += NT) {
    const int s = c * Q + t;
    const ll at = at0 + t;
    sG[t] = G[at];
    si[t] = s < S ? ig.at(b, h, s) : NEG_INF;
    sm[t] = fmaxf(add(m0, G[at]), mloc[at]);
    sden[t] = wden[at];
    sdD[t] = wdD[at];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) mlstm_bwd_rows_kernel(
    Rows<T> qr, Rows<T> kr, Rows<T> vr, Rows<T> dhr, Gate<T> ig,
    const float* __restrict__ G, const float* __restrict__ mloc,
    const float* __restrict__ min_, const float* __restrict__ Cin,
    const float* __restrict__ nin, const float* __restrict__ wden,
    const float* __restrict__ wdD, T* __restrict__ dq,
    float* __restrict__ rowdd, float* __restrict__ dlogiw, int H, int S,
    int Q, int nc, int Dk, int Dv, float scale) {
  constexpr int TM = 4, TN = MAXDK / 16, M = TR, N = MAXDK;
  __shared__ float As[KC * (M + 1)], Bs[KC * (N + 1)], DS[M * (M + 1)];
  __shared__ float sG[MAXQ], si[MAXQ], sm[MAXQ], sden[MAXQ], sdD[MAXQ];
  __shared__ float sn0[MAXDK];
  const int tt = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const ll Sp = static_cast<ll>(nc) * Q, DD = static_cast<ll>(Dk) * Dv;
  const ll cc = static_cast<ll>(bh) * nc + c, at0 = bh * Sp + c * Q;
  const float m0 = min_[cc];
  const float* C0 = Cin + cc * DD;
  load_rows_bwd(sG, si, sm, sden, sdD, G, mloc, wden, wdD, m0, ig, b, h, at0,
                c, Q, S);
  for (int k = threadIdx.x; k < Dk; k += NT) sn0[k] = nin[cc * Dk + k];
  __syncthreads();
  auto rows = [&](Rows<T> x, int tile, int mm, int d, int D, bool by_den) {
    const int t = tile * M + mm, s = c * Q + t;
    if (t >= Q || s >= S || d >= D) return 0.0f;
    const float val = x.at(b, h, s, d);
    return by_den ? val / sden[t] : val;
  };

  // the inter term first: R = (dh / den) C0^T, dq_inter = X (R + dD' n0),
  // whose q . dq_inter is the cotangent of log X
  float acc[TM][TN];
  zero(acc);
  for (int v0 = 0; v0 < Dv; v0 += KC) {
    stage<M, true>(As, [&](int mm, int k) {
      return rows(dhr, tt, mm, v0 + k, Dv, true);
    });
    stage<N, true>(Bs, [&](int n, int k) {
      const int v = v0 + k;
      return (n < Dk && v < Dv) ? C0[n * Dv + v] : 0.0f;
    });
    __syncthreads();
    mac<TM, TN>(acc, As, M + 1, Bs, N + 1);
    __syncthreads();
  }
  float dlw[TM], rdd[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int t = tt * M + ty * TM + i;
    const float X = t < Q ? mul(expf(sub(add(m0, sG[t]), sm[t])), scale)
                          : 0.0f;
    const float dD = t < Q ? sdD[t] : 0.0f;
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int kk = tx + 16 * j;
      const float n0v = kk < Dk ? sn0[kk] : 0.0f;
      const float dqi = mul(X, add(acc[i][j], mul(dD, n0v)));
      acc[i][j] = dqi;
      part = fmaf(rows(qr, tt, ty * TM + i, kk, Dk, false), dqi, part);
    }
    dlw[i] = sum16(part);
    rdd[i] = 0.0f;
  }

  // the causal tiles: ds = (dP w) scale, dd = dP P, dq += ds k
  for (int jt = 0; jt <= tt; ++jt) {
    float sc[TM][4], gc[TM][4];
    zero(sc);
    zero(gc);
    for (int k0 = 0; k0 < Dk; k0 += KC) {
      stage<M, true>(As, [&](int mm, int k) {
        return rows(qr, tt, mm, k0 + k, Dk, false);
      });
      stage<M, true>(Bs, [&](int mm, int k) {
        return rows(kr, jt, mm, k0 + k, Dk, false);
      });
      __syncthreads();
      mac<TM, 4>(sc, As, M + 1, Bs, M + 1);
      __syncthreads();
    }
    for (int v0 = 0; v0 < Dv; v0 += KC) {
      stage<M, true>(As, [&](int mm, int k) {
        return rows(dhr, tt, mm, v0 + k, Dv, true);
      });
      stage<M, true>(Bs, [&](int mm, int k) {
        return rows(vr, jt, mm, v0 + k, Dv, false);
      });
      __syncthreads();
      mac<TM, 4>(gc, As, M + 1, Bs, M + 1);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i, t = tt * M + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int jl = tx + 16 * jj, j = jt * M + jl;
        float ds = 0.0f;
        if (j <= t && t < Q) {
          const float w = expf(sub(add(sub(sG[t], sG[j]), si[j]), sm[t]));
          const float P = mul(mul(sc[i][jj], scale), w);
          const float dP = add(gc[i][jj], sdD[t]);
          ds = mul(mul(dP, w), scale);
          rdd[i] += mul(dP, P);
        }
        DS[jl * (M + 1) + r] = ds;
      }
    }
    __syncthreads();
    for (int j0 = 0; j0 < M; j0 += KC) {
      stage<N, false>(Bs, [&](int n, int k) {
        return rows(kr, jt, j0 + k, n, Dk, false);
      });
      __syncthreads();
      mac<TM, TN>(acc, DS + j0 * (M + 1), M + 1, Bs, N + 1);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int t = tt * M + ty * TM + i, s = c * Q + t;
    const float r = sum16(rdd[i]);
    if (t >= Q) continue;
    if (tx == 0) {
      rowdd[at0 + t] = r;
      dlogiw[at0 + t] = dlw[i];
    }
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int kk = tx + 16 * j;
      if (kk < Dk)
        dq[(static_cast<ll>(bh) * S + s) * Dk + kk] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) mlstm_bwd_dv_kernel(
    Rows<T> qr, Rows<T> kr, Rows<T> dhr, Gate<T> ig,
    const float* __restrict__ G, const float* __restrict__ mloc,
    const float* __restrict__ min_, const float* __restrict__ wden,
    const float* __restrict__ dCout, T* __restrict__ dv, int H, int S,
    int Q, int nc, int Dk, int Dv, float scale) {
  constexpr int TM = 2, TN = MAXDV / 16, M = 32, N = MAXDV, TT = TR;
  __shared__ float As[KC * (M + 1)], Bs[KC * (N + 1)], PT[TT * (M + 1)];
  __shared__ float sG[MAXQ], si[MAXQ], sm[MAXQ], sden[MAXQ], scw[M];
  const int jt = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const ll Sp = static_cast<ll>(nc) * Q, DD = static_cast<ll>(Dk) * Dv;
  const ll cc = static_cast<ll>(bh) * nc + c, at0 = bh * Sp + c * Q;
  const float m0 = min_[cc];
  const float* dC1 = dCout + cc * DD;
  for (int t = threadIdx.x; t < Q; t += NT) {
    const int s = c * Q + t;
    sG[t] = G[at0 + t];
    si[t] = s < S ? ig.at(b, h, s) : NEG_INF;
    sm[t] = fmaxf(add(m0, G[at0 + t]), mloc[at0 + t]);
    sden[t] = wden[at0 + t];
  }
  __syncthreads();
  if (threadIdx.x < M) {
    const int j = jt * M + threadIdx.x;
    const float GL = sG[Q - 1], mL = sm[Q - 1];
    scw[threadIdx.x] =
        j < Q ? expf(sub(add(sub(GL, sG[j]), si[j]), mL)) : 0.0f;
  }
  auto rows = [&](Rows<T> x, int t, int d, int D, bool by_den) {
    const int s = c * Q + t;
    if (t >= Q || s >= S || d >= D) return 0.0f;
    const float val = x.at(b, h, s, d);
    return by_den ? val / sden[t] : val;
  };

  // the carry's term first: cw (k dC_out)
  float acc[TM][TN];
  zero(acc);
  for (int k0 = 0; k0 < Dk; k0 += KC) {
    stage<M, true>(As, [&](int mm, int k) {
      return rows(kr, jt * M + mm, k0 + k, Dk, false);
    });
    stage<N, false>(Bs, [&](int n, int k) {
      const int kk = k0 + k;
      return (kk < Dk && n < Dv) ? dC1[kk * Dv + n] : 0.0f;
    });
    __syncthreads();
    mac<TM, TN>(acc, As, M + 1, Bs, N + 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      acc[i][j] = mul(scw[ty * TM + i], acc[i][j]);

  // P^T (dh / den) over the tiles of t >= j
  for (int tt = (jt * M) / TT; tt * TT < Q; ++tt) {
    float sc[TM][4];
    zero(sc);
    for (int k0 = 0; k0 < Dk; k0 += KC) {
      stage<M, true>(As, [&](int mm, int k) {
        return rows(kr, jt * M + mm, k0 + k, Dk, false);
      });
      stage<TT, true>(Bs, [&](int mm, int k) {
        return rows(qr, tt * TT + mm, k0 + k, Dk, false);
      });
      __syncthreads();
      mac<TM, 4>(sc, As, M + 1, Bs, TT + 1);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i, j = jt * M + r;
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const int tl = tx + 16 * q4, t = tt * TT + tl;
        float P = 0.0f;
        if (j <= t && t < Q) {
          const float w = expf(sub(add(sub(sG[t], sG[j]), si[j]), sm[t]));
          P = mul(mul(sc[i][q4], scale), w);
        }
        PT[tl * (M + 1) + r] = P;
      }
    }
    __syncthreads();
    for (int t0 = 0; t0 < TT; t0 += KC) {
      stage<N, false>(Bs, [&](int n, int k) {
        return rows(dhr, tt * TT + t0 + k, n, Dv, true);
      });
      __syncthreads();
      mac<TM, TN>(acc, PT + t0 * (M + 1), M + 1, Bs, N + 1);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int j = jt * M + ty * TM + i, s = c * Q + j;
    if (j >= Q || s >= S) continue;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int vv = tx + 16 * q;
      if (vv < Dv)
        dv[(static_cast<ll>(bh) * S + s) * Dv + vv] = from_f32<T>(acc[i][q]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) mlstm_bwd_dk_kernel(
    Rows<T> qr, Rows<T> kr, Rows<T> vr, Rows<T> dhr, Gate<T> ig,
    const float* __restrict__ G, const float* __restrict__ mloc,
    const float* __restrict__ min_, const float* __restrict__ wden,
    const float* __restrict__ wdD, const float* __restrict__ dCout,
    const float* __restrict__ dnout, T* __restrict__ dk,
    float* __restrict__ coldd, float* __restrict__ dlogcw, int H, int S,
    int Q, int nc, int Dk, int Dv, float scale) {
  constexpr int TM = 4, TN = MAXDK / 16, M = TR, N = MAXDK;
  __shared__ float As[KC * (M + 1)], Bs[KC * (N + 1)], DST[M * (M + 1)];
  __shared__ float sG[MAXQ], si[MAXQ], sm[MAXQ], sden[MAXQ], sdD[MAXQ];
  __shared__ float sdn[MAXDK];
  const int jt = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const ll Sp = static_cast<ll>(nc) * Q, DD = static_cast<ll>(Dk) * Dv;
  const ll cc = static_cast<ll>(bh) * nc + c, at0 = bh * Sp + c * Q;
  const float m0 = min_[cc];
  const float* dC1 = dCout + cc * DD;
  load_rows_bwd(sG, si, sm, sden, sdD, G, mloc, wden, wdD, m0, ig, b, h, at0,
                c, Q, S);
  for (int k = threadIdx.x; k < Dk; k += NT) sdn[k] = dnout[cc * Dk + k];
  __syncthreads();
  auto rows = [&](Rows<T> x, int t, int d, int D, bool by_den) {
    const int s = c * Q + t;
    if (t >= Q || s >= S || d >= D) return 0.0f;
    const float val = x.at(b, h, s, d);
    return by_den ? val / sden[t] : val;
  };

  // the carry's term first: E = v dC_out^T + dn_out, cw's cotangent k . E,
  // dk = cw E
  float acc[TM][TN];
  zero(acc);
  for (int v0 = 0; v0 < Dv; v0 += KC) {
    stage<M, true>(As, [&](int mm, int k) {
      return rows(vr, jt * M + mm, v0 + k, Dv, false);
    });
    stage<N, true>(Bs, [&](int n, int k) {
      const int v = v0 + k;
      return (n < Dk && v < Dv) ? dC1[n * Dv + v] : 0.0f;
    });
    __syncthreads();
    mac<TM, TN>(acc, As, M + 1, Bs, N + 1);
    __syncthreads();
  }
  const float GL = sG[Q - 1], mL = sm[Q - 1];
  float lcw[TM], cdd[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int j = jt * M + ty * TM + i;
    const float cw = j < Q ? expf(sub(add(sub(GL, sG[j]), si[j]), mL)) : 0.0f;
    float part = 0.0f;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int kk = tx + 16 * q;
      const float E = add(acc[i][q], kk < Dk ? sdn[kk] : 0.0f);
      part = fmaf(rows(kr, j, kk, Dk, false), E, part);
      acc[i][q] = mul(cw, E);
    }
    lcw[i] = mul(sum16(part), cw);
    cdd[i] = 0.0f;
  }

  // the causal tiles t >= j: ds^T q, and the column sums of dd
  for (int tt = jt; tt * M < Q; ++tt) {
    float sc[TM][4], gc[TM][4];
    zero(sc);
    zero(gc);
    for (int k0 = 0; k0 < Dk; k0 += KC) {
      stage<M, true>(As, [&](int mm, int k) {
        return rows(kr, jt * M + mm, k0 + k, Dk, false);
      });
      stage<M, true>(Bs, [&](int mm, int k) {
        return rows(qr, tt * M + mm, k0 + k, Dk, false);
      });
      __syncthreads();
      mac<TM, 4>(sc, As, M + 1, Bs, M + 1);
      __syncthreads();
    }
    for (int v0 = 0; v0 < Dv; v0 += KC) {
      stage<M, true>(As, [&](int mm, int k) {
        return rows(vr, jt * M + mm, v0 + k, Dv, false);
      });
      stage<M, true>(Bs, [&](int mm, int k) {
        return rows(dhr, tt * M + mm, v0 + k, Dv, true);
      });
      __syncthreads();
      mac<TM, 4>(gc, As, M + 1, Bs, M + 1);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i, j = jt * M + r;
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const int tl = tx + 16 * q4, t = tt * M + tl;
        float ds = 0.0f;
        if (j <= t && t < Q) {
          const float w = expf(sub(add(sub(sG[t], sG[j]), si[j]), sm[t]));
          const float P = mul(mul(sc[i][q4], scale), w);
          const float dP = add(gc[i][q4], sdD[t]);
          ds = mul(mul(dP, w), scale);
          cdd[i] += mul(dP, P);
        }
        DST[tl * (M + 1) + r] = ds;
      }
    }
    __syncthreads();
    for (int t0 = 0; t0 < M; t0 += KC) {
      stage<N, false>(Bs, [&](int n, int k) {
        return rows(qr, tt * M + t0 + k, n, Dk, false);
      });
      __syncthreads();
      mac<TM, TN>(acc, DST + t0 * (M + 1), M + 1, Bs, N + 1);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int j = jt * M + ty * TM + i, s = c * Q + j;
    const float cs = sum16(cdd[i]);
    if (j >= Q) continue;
    if (tx == 0) {
      coldd[at0 + j] = cs;
      dlogcw[at0 + j] = lcw[i];
    }
    if (s >= S) continue;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int kk = tx + 16 * q;
      if (kk < Dk)
        dk[(static_cast<ll>(bh) * S + s) * Dk + kk] = from_f32<T>(acc[i][q]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) mlstm_bwd_gates_kernel(
    Gate<T> ig, Gate<T> fg, const float* __restrict__ G,
    const float* __restrict__ mloc, const float* __restrict__ min_,
    const float* __restrict__ rowdd, const float* __restrict__ dlogiw,
    const float* __restrict__ coldd, const float* __restrict__ dlogcw,
    const float* __restrict__ parts, const float* __restrict__ dmf,
    int has_fin, T* __restrict__ di, T* __restrict__ df,
    float* __restrict__ dm0, int H, int S, int Q, int nc, int ntiles) {
  __shared__ float sdG[MAXQ], sdi[MAXQ], sG[MAXQ], si[MAXQ], slc[MAXQ];
  __shared__ float s_g, s_add, s_win;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const ll Sp = static_cast<ll>(nc) * Q;
  const float* pr = parts + static_cast<ll>(bh) * (nc + 2) * ntiles;
  float p = 0.0f;  // the final carry's m path, on thread 0
  if (threadIdx.x == 0 && has_fin) {
    float cd = 0.0f;
    for (int tl = 0; tl < ntiles; ++tl) cd += pr[nc * ntiles + tl];
    p = sub(dmf ? dmf[bh] : 0.0f, cd);
  }
  for (int c = nc - 1; c >= 0; --c) {
    const ll at0 = bh * Sp + c * Q;
    for (int t = threadIdx.x; t < Q; t += NT) {
      const int s = c * Q + t;
      const ll at = at0 + t;
      sG[t] = G[at];
      si[t] = s < S ? ig.at(b, h, s) : NEG_INF;
      slc[t] = dlogcw[at];
      sdG[t] = sub(add(sub(rowdd[at], coldd[at]), dlogiw[at]), dlogcw[at]);
      sdi[t] = add(coldd[at], dlogcw[at]);
    }
    __syncthreads();
    const float GL = sG[Q - 1], mlL = mloc[at0 + Q - 1];
    if (threadIdx.x == 0) {
      const float a = add(min_[static_cast<ll>(bh) * nc + c], GL);
      const float mL = fmaxf(a, mlL);
      const float dec = expf(sub(a, mL));
      float sc = 0.0f, pd = 0.0f;
      for (int t = 0; t < Q; ++t) sc += slc[t];
      for (int tl = 0; tl < ntiles; ++tl) pd += pr[c * ntiles + tl];
      const float pa = a > mlL ? p : (a < mlL ? 0.0f : mul(p, 0.5f));
      const float pb = a < mlL ? p : (a > mlL ? 0.0f : mul(p, 0.5f));
      int cnt = 0;
      for (int j = 0; j < Q; ++j) cnt += add(sub(GL, sG[j]), si[j]) == mlL;
      s_g = pb / static_cast<float>(cnt > 0 ? cnt : 1);
      s_add = add(add(add(sc, mul(pd, dec)), pa), pb);
      s_win = pb;
      p = pa;
    }
    __syncthreads();
    if (s_win != 0.0f)
      for (int t = threadIdx.x; t < Q; t += NT)
        if (add(sub(GL, sG[t]), si[t]) == mlL) {
          sdG[t] = sub(sdG[t], s_g);
          sdi[t] = add(sdi[t], s_g);
        }
    __syncthreads();
    if (threadIdx.x == 0) {
      sdG[Q - 1] = add(sdG[Q - 1], s_add);
      float acc = 0.0f;  // G's cumulative sum, backwards
      for (int t = Q - 1; t >= 0; --t) sdG[t] = acc = add(acc, sdG[t]);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < Q; t += NT) {
      const int s = c * Q + t;
      if (s >= S) continue;
      const ll o = static_cast<ll>(bh) * S + s;
      di[o] = from_f32<T>(sdi[t]);
      df[o] = from_f32<T>(logsigmoid_bwd(fg.at(b, h, s), sdG[t]));
    }
    __syncthreads();
  }
  if (threadIdx.x == 0 && dm0) {
    float s0 = 0.0f;
    for (int tl = 0; tl < ntiles; ++tl) s0 += pr[(nc + 1) * ntiles + tl];
    dm0[bh] = add(s0, p);
  }
}

// --------------------------------------------------------------- launches

struct Dims {
  int B, H, S, Dk, Dv, Q, nc;
  ll Sp() const { return static_cast<ll>(nc) * Q; }
  int BH() const { return B * H; }
  int ntiles() const { return ((Dk + TR - 1) / TR) * ((Dv + CT - 1) / CT); }
};

bool valid(const Dims& d) {
  return d.B >= 1 && d.H >= 1 && d.S >= 1 && d.Q >= 1 && d.Q <= MAXQ &&
         d.Dk >= 1 && d.Dk <= MAXDK && d.Dv >= 1 && d.Dv <= MAXDV &&
         d.nc == (d.S + d.Q - 1) / d.Q &&
         static_cast<ll>(d.B) * d.H <= 65535 && d.nc <= 65535;
}

template <typename T>
cudaError_t run_fwd(const void* const* in, const ll* st, const float* C0,
                    const float* n0, const float* m0, void* h, const ll* hst,
                    float* Cin, float* nin, float* min_, float* G,
                    float* mloc, float* Cf, float* nf, float* mf, float* Dp,
                    float* h32, const Dims& d, cudaStream_t stream) {
  const T* const* p = reinterpret_cast<const T* const*>(in);
  const Rows<T> q{p[0], st[0], st[1], st[2]}, k{p[1], st[3], st[4], st[5]},
      v{p[2], st[6], st[7], st[8]};
  const Gate<T> ig{p[3], st[9], st[10], st[11]},
      fg{p[4], st[12], st[13], st[14]};
  const int BH = d.BH();
  const float scale = 1.0f / sqrtf(static_cast<float>(d.Dk));
  mlstm_gates_kernel<T><<<dim3(d.nc, BH), NT, 0, stream>>>(ig, fg, G, mloc,
                                                          d.H, d.S, d.Q);
  mlstm_carry_kernel<T><<<dim3(d.ntiles(), BH), NT, 0, stream>>>(
      k, v, ig, C0, n0, m0, G, mloc, Cin, nin, min_, Cf, nf, mf, d.H, d.S,
      d.Q, d.nc, d.Dk, d.Dv);
  const int nvt = (d.Dv + CT - 1) / CT, ntt = (d.Q + TR - 1) / TR;
  mlstm_out_kernel<T><<<dim3(ntt * nvt, d.nc, BH), NT, 0, stream>>>(
      q, k, v, ig, G, mloc, Cin, nin, min_, static_cast<T*>(h), hst[0],
      hst[1], hst[2], Dp, h32, d.H, d.S, d.Q, d.nc, d.Dk, d.Dv, scale);
  return cudaGetLastError();
}

// the backward's scratch, in floats: den and dD' a position, each chunk's
// outgoing carry cotangent, the per-tile sums, the row and column sums of
// dd and the two log-weight cotangents a position
struct Workspace {
  float *den, *dD, *dC, *dn, *parts, *rowdd, *dlogiw, *coldd, *dlogcw;
  ll total;
  Workspace(float* w, const Dims& d) {
    const ll BH = d.BH(), Sp = d.Sp();
    ll off = 0;
    auto take = [&](ll n) {
      float* r = w ? w + off : nullptr;
      off += n;
      return r;
    };
    den = take(BH * Sp);
    dD = take(BH * Sp);
    dC = take(BH * d.nc * d.Dk * d.Dv);
    dn = take(BH * d.nc * d.Dk);
    parts = take(BH * (d.nc + 2) * d.ntiles());
    rowdd = take(BH * Sp);
    dlogiw = take(BH * Sp);
    coldd = take(BH * Sp);
    dlogcw = take(BH * Sp);
    total = off;
  }
};

template <typename T>
cudaError_t run_bwd(const void* const* in, const ll* st, const void* dh,
                    const ll* dst, const float* dCf, const float* dnf,
                    const float* dmf, const float* C0, const float* n0,
                    const float* const* sv, void* const* out, float* dC0,
                    float* dn0, float* dm0, float* ws, const Dims& d,
                    cudaStream_t stream) {
  const T* const* p = reinterpret_cast<const T* const*>(in);
  const Rows<T> q{p[0], st[0], st[1], st[2]}, k{p[1], st[3], st[4], st[5]},
      v{p[2], st[6], st[7], st[8]};
  const Gate<T> ig{p[3], st[9], st[10], st[11]},
      fg{p[4], st[12], st[13], st[14]};
  const Rows<T> dhr{static_cast<const T*>(dh), dst[0], dst[1], dst[2]};
  // the forward's saved tensors: C, n, m entering each chunk, G, mloc, D',
  // h in fp32, the final C and n
  const float *Cin = sv[0], *nin = sv[1], *min_ = sv[2], *G = sv[3],
              *mloc = sv[4], *Dp = sv[5], *h32 = sv[6], *Cf = sv[7],
              *nf = sv[8];
  T* const* o = reinterpret_cast<T* const*>(out);
  const Workspace w(ws, d);
  const int BH = d.BH(), ntt = (d.Q + TR - 1) / TR;
  const float scale = 1.0f / sqrtf(static_cast<float>(d.Dk));
  mlstm_bwd_prep_kernel<T>
      <<<dim3((d.Sp() + NT / 32 - 1) / (NT / 32), BH), NT, 0, stream>>>(
          dhr, h32, G, mloc, min_, Dp, w.den, w.dD, d.H, d.S, d.Q, d.nc,
          d.Dv);
  mlstm_dcarry_kernel<T><<<dim3(d.ntiles(), BH), NT, 0, stream>>>(
      q, dhr, G, mloc, min_, Cin, nin, w.den, w.dD, dCf, dnf, Cf, nf, C0, n0,
      w.dC, w.dn, w.parts, dC0, dn0, d.H, d.S, d.Q, d.nc, d.Dk, d.Dv, scale);
  mlstm_bwd_rows_kernel<T><<<dim3(ntt, d.nc, BH), NT, 0, stream>>>(
      q, k, v, dhr, ig, G, mloc, min_, Cin, nin, w.den, w.dD, o[0], w.rowdd,
      w.dlogiw, d.H, d.S, d.Q, d.nc, d.Dk, d.Dv, scale);
  mlstm_bwd_dv_kernel<T>
      <<<dim3((d.Q + 31) / 32, d.nc, BH), NT, 0, stream>>>(
          q, k, dhr, ig, G, mloc, min_, w.den, w.dC, o[2], d.H, d.S, d.Q,
          d.nc, d.Dk, d.Dv, scale);
  mlstm_bwd_dk_kernel<T><<<dim3(ntt, d.nc, BH), NT, 0, stream>>>(
      q, k, v, dhr, ig, G, mloc, min_, w.den, w.dD, w.dC, w.dn, o[1],
      w.coldd, w.dlogcw, d.H, d.S, d.Q, d.nc, d.Dk, d.Dv, scale);
  mlstm_bwd_gates_kernel<T><<<BH, NT, 0, stream>>>(
      ig, fg, G, mloc, min_, w.rowdd, w.dlogiw, w.coldd, w.dlogcw, w.parts,
      dmf, dCf || dnf || dmf, o[3], o[4], dm0, d.H, d.S, d.Q, d.nc,
      d.ntiles());
  return cudaGetLastError();
}

}  // namespace

// q, k: (B, H, S, Dk), v: (B, H, S, Dv), i, f: (B, H, S), all five in
// dtype (bf16 or fp32) at the (batch, head, position) strides given (15,
// in that order; each row's last dim contiguous); C0 (B, H, Dk, Dv), n0
// (B, H, Dk), m0 (B, H) fp32, all three null for the zero carry; h (B, H,
// S, Dv) in dtype at the strides hst; Cin (B, H, nc, Dk, Dv), nin (B, H,
// nc, Dk), min (B, H, nc) the carry entering each chunk, G and mloc (B, H,
// nc Q), Cf, nf, mf the final carry, all fp32; Dp (B, H, nc Q) and h32
// (B, H, nc Q, Dv) fp32, both null or both given (what the backward reads).
// Chunk Q <= 256, Dk <= 256, Dv <= 512.
extern "C" int mlstm_fwd_launch(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fg, long long sq0, long long sq1, long long sq2,
    long long sk0, long long sk1, long long sk2, long long sv0,
    long long sv1, long long sv2, long long si0, long long si1,
    long long si2, long long sf0, long long sf1, long long sf2,
    const void* C0, const void* n0, const void* m0, void* h, long long sh0,
    long long sh1, long long sh2, void* Cin, void* nin, void* min_, void* G,
    void* mloc, void* Cf, void* nf, void* mf, void* Dp, void* h32, int B,
    int H, int S, int Dk, int Dv, int Q, int dtype, void* stream) {
  const Dims d{B, H, S, Dk, Dv, Q, Q > 0 ? (S + Q - 1) / Q : 0};
  if (!valid(d) || (Dp == nullptr) != (h32 == nullptr) ||
      (C0 == nullptr) != (n0 == nullptr) || (C0 == nullptr) != (m0 == nullptr))
    return cudaErrorInvalidValue;
  const void* in[5] = {q, k, v, ig, fg};
  const ll st[15] = {sq0, sq1, sq2, sk0, sk1, sk2, sv0, sv1,
                     sv2, si0, si1, si2, sf0, sf1, sf2};
  const ll hst[3] = {sh0, sh1, sh2};
  auto f = [](const void* x) { return static_cast<const float*>(x); };
  auto g = [](void* x) { return static_cast<float*>(x); };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return run_fwd<bf16>(in, st, f(C0), f(n0), f(m0), h, hst, g(Cin), g(nin),
                         g(min_), g(G), g(mloc), g(Cf), g(nf), g(mf), g(Dp),
                         g(h32), d, s);
  if (dtype == DTYPE_F32)
    return run_fwd<float>(in, st, f(C0), f(n0), f(m0), h, hst, g(Cin),
                          g(nin), g(min_), g(G), g(mloc), g(Cf), g(nf),
                          g(mf), g(Dp), g(h32), d, s);
  return cudaErrorInvalidValue;
}

// fp32 elements of the backward's workspace
extern "C" long long mlstm_bwd_workspace(int B, int H, int Dk, int Dv, int Q,
                                         int nc) {
  const Dims d{B, H, nc * Q, Dk, Dv, Q, nc};
  return Workspace(nullptr, d).total;
}

// q .. f and their strides as the forward's; dh (B, H, S, Dv) in dtype at
// the strides given; dCf, dnf, dmf the final carry's cotangents (each null
// for zero); C0, n0 the carry given (null for the zero carry); the
// forward's saved tensors (Cin, nin, min, G, mloc, Dp, h32, Cf, nf);
// dq, dk, dv (B, H, S, D) and di, df (B, H, S), contiguous in dtype; dC0,
// dn0, dm0 the carry's cotangents, fp32 (null without a carry); ws the
// workspace (mlstm_bwd_workspace floats).
extern "C" int mlstm_bwd_launch(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fg, long long sq0, long long sq1, long long sq2,
    long long sk0, long long sk1, long long sk2, long long sv0,
    long long sv1, long long sv2, long long si0, long long si1,
    long long si2, long long sf0, long long sf1, long long sf2,
    const void* dh, long long sd0, long long sd1, long long sd2,
    const void* dCf, const void* dnf, const void* dmf, const void* C0,
    const void* n0, const void* Cin, const void* nin, const void* min_,
    const void* G, const void* mloc, const void* Dp, const void* h32,
    const void* Cf, const void* nf, void* dq, void* dk, void* dv, void* di,
    void* df, void* dC0, void* dn0, void* dm0, void* ws, int B, int H, int S,
    int Dk, int Dv, int Q, int dtype, void* stream) {
  const Dims d{B, H, S, Dk, Dv, Q, Q > 0 ? (S + Q - 1) / Q : 0};
  if (!valid(d) || (C0 == nullptr) != (dC0 == nullptr) ||
      (C0 == nullptr) != (n0 == nullptr) ||
      (dC0 == nullptr) != (dn0 == nullptr) ||
      (dC0 == nullptr) != (dm0 == nullptr))
    return cudaErrorInvalidValue;
  const void* in[5] = {q, k, v, ig, fg};
  const ll st[15] = {sq0, sq1, sq2, sk0, sk1, sk2, sv0, sv1,
                     sv2, si0, si1, si2, sf0, sf1, sf2};
  const ll dst[3] = {sd0, sd1, sd2};
  const float* sv[9];
  const void* svp[9] = {Cin, nin, min_, G, mloc, Dp, h32, Cf, nf};
  for (int i = 0; i < 9; ++i) sv[i] = static_cast<const float*>(svp[i]);
  void* out[5] = {dq, dk, dv, di, df};
  auto f = [](const void* x) { return static_cast<const float*>(x); };
  auto g = [](void* x) { return static_cast<float*>(x); };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return run_bwd<bf16>(in, st, dh, dst, f(dCf), f(dnf), f(dmf), f(C0),
                         f(n0), sv, out, g(dC0), g(dn0), g(dm0), g(ws), d, s);
  if (dtype == DTYPE_F32)
    return run_bwd<float>(in, st, dh, dst, f(dCf), f(dnf), f(dmf), f(C0),
                          f(n0), sv, out, g(dC0), g(dn0), g(dm0), g(ws), d,
                          s);
  return cudaErrorInvalidValue;
}
