// The sLSTM recurrence (xLSTM's scalar memory), forward and backward, each
// one launch for all S positions of a layer.
//
// Replaces no TPU kernel: the reference runs the recurrence as a
// jax.lax.scan (src/repro/models/ssm.py:203 `step`, scanned at :223),
// which XLA compiles into one loop on the device; the port ran it as a
// Python loop of one bmm and ~20 elementwise launches a position.  The
// backward stands for autodiff of that scan.
//
// Per (batch row b, head) and position t, with R the head's (Dh, 4 Dh)
// recurrent weights, gate columns [z | i | f | o]:
//     g   = gx_t + h_{t-1} R
//     z   = tanh(g_z), o = sigmoid(g_o), a = logsigmoid(g_f) + m_{t-1}
//     m_t = max(a, g_i), i' = exp(g_i - m_t), f' = exp(a - m_t)
//     c_t = f' c_{t-1} + i' z,  n_t = f' n_{t-1} + i'
//     h_t = o c_t / max(|n_t|, 1)
// Each elementwise op is rounded on its own (the _rn intrinsics keep nvcc
// from contracting a product into a sum), in the order the plain loop's
// ATen kernels compute them, so the kernel and the plain version differ
// only in the order the recurrent product sums its terms (fp32 FMAs on
// the CUDA cores, no TF32, as cuBLAS's fp32 bmm).
//
// Bound on the H100: neither bytes nor operations but the chain of S
// dependent steps.  At B = 4, H = 4, Dh = 256, S = 2048 a layer moves ~84
// MB (bf16 gates in, h out: 0.025 ms) and does 17.2 GFLOP of fp32 FMAs
// (0.26 ms at 67 TFLOP/s), but step t needs every h_{t-1}.  So the design
// spreads one step over as many SMs as can share h cheaply, and makes a
// step's latency short:
//   - one thread-block cluster of CL = 8 CTAs per (batch row, head); CTA
//     k owns dims [k Dh/8, (k+1) Dh/8) of all four gates, so its cell
//     update needs no other CTA's gates;
//   - each CTA holds its (Dh, 4 Dh / 8) slice of R in registers for all S
//     steps (128 fp32 a thread at Dh = 256, 256 threads), read from
//     memory once;
//   - each step a thread sums its gate column over half of h (h broadcast
//     from shared memory, 16 bytes a load), the two halves meet in shared
//     memory, and one warp updates the CTA's Dh/8 cells, writes the new h
//     slice into every CTA of the cluster (distributed shared memory, into
//     the other of two h buffers) and each output;
//   - one barrier.cluster (arrive.release / wait.acquire) a step: with h
//     double-buffered, a CTA can only write the buffer every CTA finished
//     reading before the last barrier;
//   - the next step's gates are loaded into registers one step ahead (and
//     asked into L2 eight steps ahead).
// At B = 4, H = 4 that is 16 clusters on 128 SMs.
//
// The backward runs in reverse time with the same clusters and the
// transposed split: CTA k owns rows [k Dh/8, (k+1) Dh/8) of R (all 4 Dh
// columns, 128 a thread, again in registers).  Each step the cell warp
// recomputes step t from the saved gates and the saved state before it,
// forms the gates' cotangent dg_t for its dims, writes it (as the
// cotangent of gx, in gx's dtype, and in fp32 for dR), and sends it to
// every CTA; after the barrier each CTA forms its rows of dh_{t-1} = dg_t
// R^T, a thread summing 128 columns and eight threads meeting by shuffles
// in a fixed order.  dR = sum_t h_{t-1}^T dg_t is one batched product
// after the kernel (kernels/slstm.py), as the JAX package leaves it to
// XLA.  The maxima split a tie's gradient in half (torch.maximum,
// jnp.maximum), |n| has slope 0 at 0, d logsigmoid(f) = sigmoid(-f) in
// ATen's form.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int CL = 8;  // CTAs a cluster
constexpr int KP = 2;  // forward: the halves of h a gate column is summed over
constexpr int CP = 8;  // backward: the column parts a row of R is summed over

__device__ __forceinline__ uint32_t cta_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// the shared-memory address of `p` in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_peer(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// every thread of every CTA of the cluster: the writes before it (to any
// CTA's shared memory) are seen by every thread after it
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.L2 [%0];\n" ::"l"(p));
}

// ATen's CUDA forms (opmath float): sigmoid 1 / (1 + exp(-x)); logsigmoid
// min(0, x) - log1p(exp(-|x|)) and its gradient
__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

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

// gates_x's strides in elements: (batch, position, gate, head); a head's Dh
// values are contiguous
struct GateStrides {
  long long b, t, g, h;
};

// the recurrent weights (H, Dh, 4 Dh), contiguous, in bf16 or fp32 as the
// model keeps them; read once, into registers, in fp32 (bf16 values are
// exact there)
struct RWeights {
  const void* p;
  int bf16;

  __device__ __forceinline__ float at(size_t i) const {
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                : static_cast<const float*>(p)[i];
  }
  // four consecutive values from i, a multiple of 4
  __device__ __forceinline__ float4 at4(size_t i) const {
    if (!bf16) return reinterpret_cast<const float4*>(p)[i / 4];
    const uint2 u = reinterpret_cast<const uint2*>(p)[i / 4];
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    return make_float4(__low2float(a), __high2float(a), __low2float(b),
                       __high2float(b));
  }
};

// ---------------------------------------------------------------- forward

template <int DH, typename T, typename TS>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(DH, 1)
    slstm_fwd_kernel(const T* __restrict__ gx, GateStrides st, RWeights r,
                     const float* __restrict__ h0,
                     const float* __restrict__ c0,
                     const float* __restrict__ n0,
                     const float* __restrict__ m0, TS* __restrict__ hs,
                     float* __restrict__ hN, float* __restrict__ cN,
                     float* __restrict__ nN, float* __restrict__ mN,
                     float* __restrict__ save_g,
                     float* __restrict__ save_s, int B, int S, int H) {
  constexpr int DPC = DH / CL;  // dims a CTA owns
  constexpr int NC = 4 * DPC;   // gate columns a CTA owns
  constexpr int NQ = DH / 4 / KP;  // float4 groups of h a thread sums over
  static_assert(NC * KP == DH, "one thread a (column, half)");

  __shared__ __align__(16) float h_s[2][DH];
  __shared__ float pre_s[KP][NC];

  const int tid = threadIdx.x;
  const uint32_t rank = cta_rank();
  const int cl = static_cast<int>(cluster_index());
  const int row = cl / H, head = cl % H;
  const int c = tid % NC, p = tid / NC;
  const int col = (c / DPC) * DH + static_cast<int>(rank) * DPC + c % DPC;

  // this thread's column of R at the k of its float4 groups p + KP i
  float rr[4 * NQ];
  const size_t rh = static_cast<size_t>(head) * DH * 4 * DH;
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      rr[4 * i + e] =
          r.at(rh + static_cast<size_t>(4 * (p + KP * i) + e) * 4 * DH + col);

  const size_t base = (static_cast<size_t>(row) * H + head) * DH;
  h_s[0][tid] = h0 ? h0[base + tid] : 0.0f;

  const bool cell = tid < DPC;
  const int j = static_cast<int>(rank) * DPC + tid;
  float hh = 0.0f, cc = 0.0f, nn = 1.0f, mm = 0.0f;
  const size_t plane = static_cast<size_t>(H) * (S + 1) * B * DH;
  auto save_at = [&](int slot) -> size_t {
    return ((static_cast<size_t>(head) * (S + 1) + slot) * B + row) * DH + j;
  };
  if (cell) {
    if (h0) {
      hh = h0[base + j];
      cc = c0[base + j];
      nn = n0[base + j];
      mm = m0[base + j];
    }
    if (save_s) {
      const size_t o = save_at(0);
      save_s[o] = hh;
      save_s[plane + o] = cc;
      save_s[2 * plane + o] = nn;
      save_s[3 * plane + o] = mm;
    }
  }
  // h_s[0][0] in every CTA of the cluster (a CTA's window is contiguous)
  uint32_t peer[CL];
#pragma unroll
  for (int q = 0; q < CL; ++q) peer[q] = peer_addr(&h_s[0][0], q);
  const T* gxp = gx + row * st.b + head * st.h + (cell ? j : 0);
  auto load = [&](float (&dst)[4], int t) {
#pragma unroll
    for (int g = 0; g < 4; ++g) dst[g] = to_f32(gxp[t * st.t + g * st.g]);
  };

  // every CTA has started and holds h_{-1}
  cluster_barrier();

  float ga[4], gb[4];
  if (cell) load(ga, 0);
  int buf = 0;
  auto step = [&](int t, float (&use)[4], float (&fill)[4]) {
    if (cell) {
      if (t + 1 < S) load(fill, t + 1);
      if (t + 8 < S)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          prefetch_l2(gxp + (t + 8) * st.t + g * st.g);
    }
    // this thread's gate column over its half of h
    const float4* hv = reinterpret_cast<const float4*>(h_s[buf]);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const float4 v = hv[p + KP * i];
      a0 = fmaf(v.x, rr[4 * i + 0], a0);
      a1 = fmaf(v.y, rr[4 * i + 1], a1);
      a2 = fmaf(v.z, rr[4 * i + 2], a2);
      a3 = fmaf(v.w, rr[4 * i + 3], a3);
    }
    pre_s[p][c] = (a0 + a1) + (a2 + a3);
    __syncthreads();
    if (cell) {
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float rec = pre_s[0][q * DPC + tid];
#pragma unroll
        for (int k = 1; k < KP; ++k) rec += pre_s[k][q * DPC + tid];
        g[q] = __fadd_rn(use[q], rec);
      }
      const float z = tanhf(g[0]);
      const float o = sigmoid_f(g[3]);
      const float a = __fadd_rn(logsigmoid_f(g[2]), mm);
      const float mn = fmaxf(a, g[1]);
      const float ip = expf(__fsub_rn(g[1], mn));
      const float fp = expf(__fsub_rn(a, mn));
      cc = __fadd_rn(__fmul_rn(fp, cc), __fmul_rn(ip, z));
      nn = __fadd_rn(__fmul_rn(fp, nn), ip);
      hh = __fdiv_rn(__fmul_rn(o, cc), fmaxf(fabsf(nn), 1.0f));
      mm = mn;
#pragma unroll
      for (int q = 0; q < CL; ++q)
        st_peer(peer[q] + 4u * ((buf ^ 1) * DH + j), hh);
      hs[((static_cast<size_t>(row) * S + t) * H + head) * DH + j] =
          from_f32<TS>(hh);
      if (save_g) {
        float* sg =
            save_g + ((static_cast<size_t>(head) * S + t) * B + row) * 4 * DH +
            j;
#pragma unroll
        for (int q = 0; q < 4; ++q) sg[q * DH] = g[q];
        const size_t o2 = save_at(t + 1);
        save_s[o2] = hh;
        save_s[plane + o2] = cc;
        save_s[2 * plane + o2] = nn;
        save_s[3 * plane + o2] = mm;
      }
    }
    cluster_barrier();
    buf ^= 1;
  };
  int t = 0;
  for (; t + 1 < S; t += 2) {
    step(t, ga, gb);
    step(t + 1, gb, ga);
  }
  if (t < S) step(t, ga, gb);

  if (cell) {
    hN[base + j] = hh;
    cN[base + j] = cc;
    nN[base + j] = nn;
    mN[base + j] = mm;
  }
}

// --------------------------------------------------------------- backward

// what the cell warp reads for one step
struct StepIn {
  float dhs, g[4], c, n, m;
};

template <int DH, typename T, typename TS>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(DH, 1)
    slstm_bwd_kernel(RWeights r, const float* __restrict__ save_g,
                     const float* __restrict__ save_s,
                     const TS* __restrict__ dhs,
                     const float* __restrict__ dh_T,
                     const float* __restrict__ dc_T,
                     const float* __restrict__ dn_T,
                     const float* __restrict__ dm_T, T* __restrict__ dgx,
                     float* __restrict__ dG, float* __restrict__ dh0,
                     float* __restrict__ dc0, float* __restrict__ dn0,
                     float* __restrict__ dm0, int B, int S, int H) {
  constexpr int DPC = DH / CL;     // rows of R (dims) a CTA owns
  constexpr int NQ = DH / CP;      // float4 groups of columns a thread sums
  static_assert(DPC * CP == DH, "one thread a (row, column part)");
  static_assert(CP == 8, "the shuffles below meet eight lanes");

  __shared__ __align__(16) float dg_s[2][4 * DH];
  __shared__ float dh_s[DPC];

  const int tid = threadIdx.x;
  const uint32_t rank = cta_rank();
  const int cl = static_cast<int>(cluster_index());
  const int row = cl / H, head = cl % H;
  const int kl = tid / CP, p = tid % CP;

  // this thread's part of row k of R: the float4 column groups p + CP i
  float rr[4 * NQ];
  const size_t rk = (static_cast<size_t>(head) * DH + rank * DPC + kl) * 4 * DH;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const float4 v = r.at4(rk + 4 * (p + CP * i));
    rr[4 * i + 0] = v.x;
    rr[4 * i + 1] = v.y;
    rr[4 * i + 2] = v.z;
    rr[4 * i + 3] = v.w;
  }

  const bool cell = tid < DPC;
  const int j = static_cast<int>(rank) * DPC + (cell ? tid : 0);
  const size_t base = (static_cast<size_t>(row) * H + head) * DH;
  // the cotangents carried back: of h (from the step after), c, n, m
  float dh = 0.0f, dc = 0.0f, dn = 0.0f, dm = 0.0f;
  if (cell) {
    if (dh_T) dh = dh_T[base + j];
    if (dc_T) dc = dc_T[base + j];
    if (dn_T) dn = dn_T[base + j];
    if (dm_T) dm = dm_T[base + j];
  }
  const size_t plane = static_cast<size_t>(H) * (S + 1) * B * DH;
  auto load = [&](StepIn& in, int t) {
    in.dhs = to_f32(
        dhs[((static_cast<size_t>(row) * S + t) * H + head) * DH + j]);
    const float* sg =
        save_g + ((static_cast<size_t>(head) * S + t) * B + row) * 4 * DH + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) in.g[q] = sg[q * DH];
    const size_t o =
        ((static_cast<size_t>(head) * (S + 1) + t) * B + row) * DH + j;
    in.c = save_s[plane + o];
    in.n = save_s[2 * plane + o];
    in.m = save_s[3 * plane + o];
  };
  // dg_s[0][0] in every CTA of the cluster
  uint32_t peer[CL];
#pragma unroll
  for (int k = 0; k < CL; ++k) peer[k] = peer_addr(&dg_s[0][0], k);

  // dh_s[kl] = row k of dg_s[b] R^T (every thread; one barrier)
  auto row_dot = [&](int b) {
    const float4* gv = reinterpret_cast<const float4*>(dg_s[b]);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const float4 v = gv[p + CP * i];
      a0 = fmaf(v.x, rr[4 * i + 0], a0);
      a1 = fmaf(v.y, rr[4 * i + 1], a1);
      a2 = fmaf(v.z, rr[4 * i + 2], a2);
      a3 = fmaf(v.w, rr[4 * i + 3], a3);
    }
    float acc = (a0 + a1) + (a2 + a3);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (p == 0) dh_s[kl] = acc;
    __syncthreads();
  };

  cluster_barrier();  // every CTA has started

  StepIn ia, ib;
  if (cell) load(ia, S - 1);
  int buf = 0;
  auto step = [&](int t, StepIn& in, StepIn& next) {
    if (cell && t > 0) load(next, t - 1);
    if (t < S - 1) {
      row_dot(buf);
      if (cell) dh = dh_s[tid];
    }
    if (cell) {
      // step t again, from its saved gates and the state before it
      const float* g = in.g;
      const float z = tanhf(g[0]);
      const float o = sigmoid_f(g[3]);
      const float a = __fadd_rn(logsigmoid_f(g[2]), in.m);
      const float mn = fmaxf(a, g[1]);
      const float ip = expf(__fsub_rn(g[1], mn));
      const float fp = expf(__fsub_rn(a, mn));
      const float c = __fadd_rn(__fmul_rn(fp, in.c), __fmul_rn(ip, z));
      const float n = __fadd_rn(__fmul_rn(fp, in.n), ip);
      const float an = fabsf(n);
      const float den = fmaxf(an, 1.0f);
      const float h = __fdiv_rn(__fmul_rn(o, c), den);
      // h = (o c) / den
      const float gh = __fadd_rn(dh, in.dhs);
      const float qd = __fdiv_rn(gh, den);
      const float dden = __fmul_rn(-gh, __fdiv_rn(h, den));
      const float d_o = __fmul_rn(qd, c);
      const float gc = __fadd_rn(dc, __fmul_rn(qd, o));
      // den = max(|n|, 1), a tie halved; |n| with slope 0 at 0
      const float dabs =
          an > 1.0f ? dden : (an == 1.0f ? __fmul_rn(dden, 0.5f) : 0.0f);
      const float sgn = n > 0.0f ? 1.0f : (n < 0.0f ? -1.0f : 0.0f);
      const float gn = __fadd_rn(dn, __fmul_rn(dabs, sgn));
      // c = f' c_prev + i' z, n = f' n_prev + i'
      const float dfp = __fadd_rn(__fmul_rn(gc, in.c), __fmul_rn(gn, in.n));
      const float dip = __fadd_rn(__fmul_rn(gc, z), gn);
      const float dz = __fmul_rn(gc, ip);
      dc = __fmul_rn(gc, fp);
      dn = __fmul_rn(gn, fp);
      // f' = exp(a - m), i' = exp(g_i - m)
      const float ef = __fmul_rn(dfp, fp);
      const float ei = __fmul_rn(dip, ip);
      const float dmn = __fsub_rn(__fsub_rn(dm, ei), ef);
      // m = max(a, g_i), a tie halved
      float da_m, di_m;
      if (a > g[1]) {
        da_m = dmn;
        di_m = 0.0f;
      } else if (a < g[1]) {
        da_m = 0.0f;
        di_m = dmn;
      } else {
        da_m = di_m = __fmul_rn(dmn, 0.5f);
      }
      const float da = __fadd_rn(da_m, ef);
      float dg[4];
      dg[1] = __fadd_rn(di_m, ei);
      dg[2] = logsigmoid_bwd(g[2], da);  // a = logsigmoid(g_f) + m_prev
      dm = da;
      dg[3] = __fmul_rn(__fmul_rn(d_o, __fsub_rn(1.0f, o)), o);
      dg[0] = __fmul_rn(dz, __fsub_rn(1.0f, __fmul_rn(z, z)));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int k = 0; k < CL; ++k)
          st_peer(peer[k] + 4u * ((buf ^ 1) * 4 * DH + q * DH + j), dg[q]);
        dgx[(((static_cast<size_t>(row) * S + t) * 4 + q) * H + head) * DH +
            j] = from_f32<T>(dg[q]);
      }
      float* dgp =
          dG + ((static_cast<size_t>(head) * S + t) * B + row) * 4 * DH + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) dgp[q * DH] = dg[q];
    }
    cluster_barrier();
    buf ^= 1;
  };
  int t = S - 1;
  for (; t >= 1; t -= 2) {
    step(t, ia, ib);
    step(t - 1, ib, ia);
  }
  if (t == 0) step(0, ia, ib);

  // the initial state's cotangents: dh_{-1} = dg_0 R^T
  row_dot(buf);
  if (cell) {
    dh0[base + j] = dh_s[tid];
    dc0[base + j] = dc;
    dn0[base + j] = dn;
    dm0[base + j] = dm;
  }
}

template <int DH, typename T, typename TS>
cudaError_t launch_fwd(const void* gx, GateStrides st, RWeights r,
                       const void* h0, const void* c0, const void* n0,
                       const void* m0, void* hs, void* hN, void* cN,
                       void* nN, void* mN, void* save_g, void* save_s, int B,
                       int S, int H, cudaStream_t s) {
  slstm_fwd_kernel<DH, T, TS><<<B * H * CL, DH, 0, s>>>(
      static_cast<const T*>(gx), st, r,
      static_cast<const float*>(h0), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<const float*>(m0),
      static_cast<TS*>(hs), static_cast<float*>(hN),
      static_cast<float*>(cN), static_cast<float*>(nN),
      static_cast<float*>(mN), static_cast<float*>(save_g),
      static_cast<float*>(save_s), B, S, H);
  return cudaGetLastError();
}

template <int DH, typename T, typename TS>
cudaError_t launch_bwd(RWeights r, const void* save_g, const void* save_s,
                       const void* dhs, const void* dh_T, const void* dc_T,
                       const void* dn_T, const void* dm_T, void* dgx,
                       void* dG, void* dh0, void* dc0, void* dn0, void* dm0,
                       int B, int S, int H, cudaStream_t s) {
  slstm_bwd_kernel<DH, T, TS><<<B * H * CL, DH, 0, s>>>(
      r, static_cast<const float*>(save_g),
      static_cast<const float*>(save_s), static_cast<const TS*>(dhs),
      static_cast<const float*>(dh_T), static_cast<const float*>(dc_T),
      static_cast<const float*>(dn_T), static_cast<const float*>(dm_T),
      static_cast<T*>(dgx), static_cast<float*>(dG),
      static_cast<float*>(dh0), static_cast<float*>(dc0),
      static_cast<float*>(dn0), static_cast<float*>(dm0), B, S, H);
  return cudaGetLastError();
}

// the instance for (gates' dtype, stack dtype) at Dh 256, xlstm_350m's
// heads; F is a functor taking (Dh, the two dtypes) as template arguments
template <template <int, typename, typename> class F, typename... A>
cudaError_t dispatch(int dh, int dtype, int stack_dtype, A... args) {
  using bf16 = __nv_bfloat16;
  constexpr int DH = 256;
  if (dh != DH) return cudaErrorInvalidValue;
  if (dtype == DTYPE_BF16 && stack_dtype == DTYPE_BF16)
    return F<DH, bf16, bf16>::run(args...);
  if (dtype == DTYPE_BF16 && stack_dtype == DTYPE_F32)
    return F<DH, bf16, float>::run(args...);
  if (dtype == DTYPE_F32 && stack_dtype == DTYPE_BF16)
    return F<DH, float, bf16>::run(args...);
  if (dtype == DTYPE_F32 && stack_dtype == DTYPE_F32)
    return F<DH, float, float>::run(args...);
  return cudaErrorInvalidValue;
}

bool valid_dims(int B, int S, int H, int r_dtype) {
  return B >= 1 && S >= 1 && H >= 1 &&
         static_cast<long long>(B) * H * CL <= 2147483647LL &&
         (r_dtype == DTYPE_F32 || r_dtype == DTYPE_BF16);
}

template <int DH, typename T, typename TS>
struct Fwd {
  template <typename... A>
  static cudaError_t run(A... a) {
    return launch_fwd<DH, T, TS>(a...);
  }
};

template <int DH, typename T, typename TS>
struct Bwd {
  template <typename... A>
  static cudaError_t run(A... a) {
    return launch_bwd<DH, T, TS>(a...);
  }
};

}  // namespace

// gx: (B, S, 4, H, Dh) at the strides given (elements; Dh contiguous) in
// bf16 or fp32 (dtype); r: (H, Dh, 4 Dh) contiguous in bf16 or fp32
// (r_dtype); h0..m0: (B, H, Dh) fp32,
// all four null for the zero state (n = 1); hs: (B, S, H, Dh) in
// stack_dtype; hN..mN: (B, H, Dh) fp32, the final h, c, n, m; save_g (H,
// S, B, 4 Dh) and save_s (4, H, S + 1, B, Dh) fp32, both null or both
// given: every step's gates and the states before and after it, for the
// backward.  Dh 256 (xlstm_350m's heads); one cluster of 8 CTAs a (row,
// head).
extern "C" int slstm_fwd_launch(const void* gx, long long sb, long long s_t,
                                long long sg, long long sh, const void* r,
                                int r_dtype, const void* h0, const void* c0,
                                const void* n0, const void* m0, void* hs,
                                void* hN, void* cN, void* nN, void* mN,
                                void* save_g, void* save_s, int B,
                                int S, int H, int Dh, int dtype,
                                int stack_dtype, void* stream) {
  if (!valid_dims(B, S, H, r_dtype) ||
      (save_g == nullptr) != (save_s == nullptr))
    return cudaErrorInvalidValue;
  const GateStrides st{sb, s_t, sg, sh};
  const RWeights rw{r, r_dtype == DTYPE_BF16};
  return dispatch<Fwd>(Dh, dtype, stack_dtype, gx, st, rw, h0, c0, n0, m0, hs,
                       hN, cN, nN, mN, save_g, save_s, B, S, H,
                       static_cast<cudaStream_t>(stream));
}

// r (r_dtype), save_g, save_s as the forward's; dhs: (B, S, H, Dh) in
// stack_dtype, contiguous; dh_T..dm_T: (B, H, Dh) fp32 cotangents of the
// final state, each null for zero; dgx: (B, S, 4, H, Dh) contiguous in
// dtype, the gates' cotangent; dG: (H, S, B, 4 Dh) fp32, the same for dR;
// dh0..dm0: (B, H, Dh) fp32, the initial state's cotangents.
extern "C" int slstm_bwd_launch(const void* r, int r_dtype, const void* save_g,
                                const void* save_s, const void* dhs,
                                const void* dh_T, const void* dc_T,
                                const void* dn_T, const void* dm_T,
                                void* dgx, void* dG, void* dh0, void* dc0,
                                void* dn0, void* dm0, int B, int S, int H,
                                int Dh, int dtype, int stack_dtype,
                                void* stream) {
  if (!valid_dims(B, S, H, r_dtype)) return cudaErrorInvalidValue;
  const RWeights rw{r, r_dtype == DTYPE_BF16};
  return dispatch<Bwd>(Dh, dtype, stack_dtype, rw, save_g, save_s, dhs, dh_T,
                       dc_T, dn_T, dm_T, dgx, dG, dh0, dc0, dn0, dm0, B, S,
                       H,
                       static_cast<cudaStream_t>(stream));
}
