// Single-token GQA decode attention over a dense KV cache.
//
// Not a TPU kernel: replaces the plain function
// src/repro/kernels/ops.py:179 decode_attention, which the reference runs
// as jnp einsums that XLA fuses with the bf16-to-fp32 convert, so it reads
// the cache once.  The port ran it as ATen passes over chunks of 32768
// positions: each chunk's K and V upcast to fp32 copies, two fp32 GEMVs and
// ~10 elementwise launches, over the whole Smax-position cache every step
// (a captured step reads cache_len on the device, so the chunks past it
// were scored and masked, not skipped).
//
// Bound on the H100: memory.  Each cached K/V row is used once per query
// head of its group (G <= 12 on the main paths): ~G flops per byte, far
// below the ~295 the tensor cores need, so the least time is the bytes:
// the K/V rows below cache_len (from the window's start), q and the
// output, over 3.35 TB/s.
//
// Design: flash-decoding, as the split route of paged_attention.cu.
//   - The valid positions.  cache_len and the slice's offset are read from
//     device memory (a 0-d int32 or int64 tensor each, or a value the host
//     passed), never synchronised to the host.  The local positions
//     [lo, hi) with offset + i < cache_len (and >= cache_len - window) are
//     the only ones any block reads: a masked position's weight,
//     exp(NEG_INF - m), is an exact 0 in fp32, so skipping it changes no
//     bit, and a captured step's work follows cache_len, not Smax.
//   - The plan, a function of the device-side lo and hi alone (so an
//     eager call and a graph replay give the same bits), on a grid fixed
//     by the shapes (a captured graph fixes it): n_split blocks a (slot,
//     kv head) divide [lo, hi) among themselves in spans of
//     ceil((hi - lo) / n_split) positions rounded up to 16, at least 128
//     (a block's fixed costs, q staged and gc heads merged through shared
//     memory, want one pass of its loop at least); blocks past the last
//     span exit at once.  The wrapper picks n_split from the shapes, ~8
//     blocks an SM.  (A block a 128-position partition of the whole cache,
//     those outside [lo, hi) exiting at once, measured equal at the dense
//     decode shapes and 3.4x slower at cache_len 32784 of 524288: PERF.md.)
//   - GQA.  A block holds the gc query heads of its kv head, gc = G for
//     G <= 12 (every main path: G = 1, 4, 5, 7, 12), so each K/V row is
//     read from device memory once for the group; a larger G runs as G /
//     gc blocks a kv head (gc the largest divisor <= 12).  q goes to
//     shared memory in fp32; each lane keeps gc fp32 accumulators of its
//     8 columns in registers (instances at 1, 2, 4, 8 and 12 heads).
//   - Loads.  Vector route (D and Dv whole 16-byte words, K/V bases and
//     strides 16-byte aligned: every main path's 80 and 128): a row of
//     16 lanes (D, Dv <= 128) or 32 (<= 256), 8 elements a lane as one
//     (bf16) or two (fp32) 16-byte loads; a warp's row groups take
//     neighbouring positions, and a lane issues the loads of all its
//     batch of positions (2-8) before any arithmetic.  Scalar route
//     (anything else): 32 lanes a row, lane i reading elements i, i + 32,
//     ... .  The cache is read through its strides (the (B, Smax, Hkv, D)
//     buffer seen as (B, Hkv, Smax, D)), offsets in 64 bits.
//   - Softmax.  Scores and the online softmax are fp32, each row group
//     keeping its own (m, l, acc) per head; a warp's two groups merge by
//     shuffles, the 8 warps through shared memory in a fixed order, and
//     the block writes fp32 partials (acc[Dv], m, l) a head to a
//     workspace (B, Hq, n_split, Dv + 2).  A second kernel merges the live
//     spans in span order (no atomics: the same bits every call) and
//     writes o in q's dtype, or (partials) the fp32 o and lse that
//     ops.merge_attention takes; a slice with no valid position gives
//     o = 0 and lse = NEG_INF, weight 0 in that merge.
//   The vector row, the online softmax, the warps' merge and the spans'
//   merge are flash_decode.cuh's, shared with paged_attention.cu's split
//   route; the strided addressing, the scalar route, the plan and the
//   half-warps' merge are this file's.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "flash_decode.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LE = fd::LE;        // elements of a row a lane owns
constexpr int MAX_D = 256;
constexpr int MAX_GC = 12;        // query heads a block holds
constexpr int MERGE_THREADS = 128;
constexpr int GRAIN = 16;         // a split span rounds up to this
constexpr int MIN_SPAN = 128;     // and is at least this

// where cache_len and the slice's offset live: a device scalar (int32 or
// int64) or, with a null pointer, the value passed
struct Scalars {
  const void* len;
  const void* off;
  long long len_v, off_v;
  int len64, off64;
};

__device__ __forceinline__ long long read_scalar(const void* p, int is64,
                                                 long long v) {
  if (p == nullptr) return v;
  return is64 ? *static_cast<const long long*>(p)
              : static_cast<long long>(*static_cast<const int*>(p));
}

// the local positions [lo, hi) a call attends over
struct Span {
  long long lo, hi;
};

__device__ __forceinline__ Span valid_span(const Scalars& s, int window,
                                           int smax) {
  const long long len = read_scalar(s.len, s.len64, s.len_v);
  const long long off = read_scalar(s.off, s.off64, s.off_v);
  long long hi = len - off;
  hi = hi < 0 ? 0 : (hi > smax ? smax : hi);
  long long lo = 0;
  if (window > 0) {
    lo = len - window - off;
    lo = lo < 0 ? 0 : (lo > hi ? hi : lo);
  }
  return {lo, hi};
}

// block j < n covers [lo + j per, min(lo + (j + 1) per, hi))
// (kernels/decode_attention.py ``plan_spans`` is the same arithmetic)
struct Plan {
  long long per;
  int n;
};

__device__ __forceinline__ Plan plan_of(Span s, int n_split) {
  const long long n = s.hi - s.lo;
  long long per = (n + n_split - 1) / n_split;
  per = (per + GRAIN - 1) / GRAIN * GRAIN;
  per = per < MIN_SPAN ? MIN_SPAN : per;
  return {per, static_cast<int>((n + per - 1) / per)};
}

struct Args {
  const void *q, *k, *v;
  Scalars sc;
  void* o;          // (B, Hq, Dv) in q's dtype, or fp32 with partials
  float* lse;       // (B, Hq) fp32 with partials, else null
  float* ws;        // (B, Hq, n_split, Dv + 2) fp32
  long long q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int B, Hq, Hkv, Smax, D, Dv, window, n_split, gc;
  float scale;
};

// The scalar route's row: lane li owns columns li, li + 32, ..., read one
// element at a time (any width, any alignment).
template <typename T>
struct ScalarRow {
  static constexpr int REGS = LE;
  float f_[LE];

  static __device__ __forceinline__ int col(int li, int e) {
    return li + 32 * e;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < LE; ++e) f_[e] = 0.f;
  }
  __device__ __forceinline__ void load(const T* row, int c0, int width) {
#pragma unroll
    for (int e = 0; e < LE; ++e) {
      const int c = c0 + 32 * e;
      f_[e] = c < width ? ::to_f32(row[c]) : 0.f;
    }
  }
  __device__ __forceinline__ void to_f32(float (&f)[LE]) const {
#pragma unroll
    for (int e = 0; e < LE; ++e) f[e] = f_[e];
  }
};

// the lane's 8 columns of a head's fp32 q row in shared memory
template <bool VEC>
__device__ __forceinline__ void q_cols(const float* sq, int li,
                                       float (&f)[LE]) {
  if constexpr (VEC) {
    const float4 a = *reinterpret_cast<const float4*>(sq + LE * li);
    const float4 b = *reinterpret_cast<const float4*>(sq + LE * li + 4);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < LE; ++e) f[e] = sq[li + 32 * e];
  }
}

// GCM: the heads' registers an instance holds (gc <= GCM at run time);
// R: lanes a row; VEC: the vector route
template <typename T, int GCM, int R, bool VEC>
struct Cfg {
  using Row = std::conditional_t<VEC, fd::Row8<T>, ScalarRow<T>>;
  static constexpr int NG = 32 / R;          // row groups a warp
  static constexpr int DM = R * LE;          // widest row an instance takes
  // positions a row group loads at once: ~32 registers of K and V rows a
  // lane, fewer as the heads' accumulators grow
  static constexpr int U0 = (GCM <= 2 ? 32 : GCM <= 4 ? 16 : 8) / Row::REGS;
  static constexpr int U = U0 < 1 ? 1 : U0;
};

template <typename T, int GCM, int R, bool VEC>
__global__ void __launch_bounds__(THREADS)
dense_decode_kernel(const Args a) {
  using C = Cfg<T, GCM, R, VEC>;
  using Row = typename C::Row;
  constexpr int U = C::U, NG = C::NG, DM = C::DM;
  __shared__ __align__(16) float s_q[GCM][DM];
  __shared__ float s_m[WARPS][GCM];
  __shared__ float s_l[WARPS][GCM];
  __shared__ float s_acc[WARPS][DM];

  const Span sp = valid_span(a.sc, a.window, a.Smax);
  const Plan pl = plan_of(sp, a.n_split);
  const int j = blockIdx.x;
  if (j >= pl.n) return;                  // the whole block, before a sync
  const long long lo = sp.lo + j * pl.per;
  const int t0 = static_cast<int>(lo);
  const int t1 = static_cast<int>(lo + pl.per < sp.hi ? lo + pl.per : sp.hi);

  const int b = blockIdx.y / a.Hkv, h = blockIdx.y - b * a.Hkv;
  const int gc = a.gc;
  const int hq0 = h * (a.Hq / a.Hkv) + blockIdx.z * gc;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + hq0 * a.q_sh;
  for (int i = threadIdx.x; i < GCM * DM; i += THREADS) {
    const int g = i / DM, c = i - g * DM;
    s_q[g][c] = g < gc && c < a.D ? to_f32(qb[g * a.q_sh + c]) : 0.f;
  }
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / R, li = lane - grp * R;
  const int c0 = Row::col(li, 0);
  float m[GCM], l[GCM], acc[GCM][LE];
#pragma unroll
  for (int g = 0; g < GCM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < LE; ++e) acc[g][e] = 0.f;
  }
  __syncthreads();                        // q is in

  // warp w takes positions bw + NG u + grp, u < U: the loop's bound is the
  // warp's, so its shuffles see every lane
  for (int bw = t0 + warp * NG * U; bw < t1; bw += WARPS * NG * U) {
    Row kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = bw + NG * u + grp;
      if (t < t1) {
        kr[u].load(kb + t * a.k_ss, c0, a.D);
        vr[u].load(vb + t * a.v_ss, c0, a.Dv);
      } else {
        kr[u].zero();
        vr[u].zero();
      }
    }
#pragma unroll
    for (int g = 0; g < GCM; ++g) {
      if (g >= gc) break;
      float qf[LE];
      q_cols<VEC>(s_q[g], li, qf);
      fd::online_step<R, U>(qf, kr, vr, bw + grp, NG, t1, a.scale, m[g],
                            l[g], acc[g]);
    }
  }

  // a head at a time: the warp's row groups by shuffles, then the 8 warps
  // through shared memory in order, into the block's partial
#pragma unroll
  for (int g = 0; g < GCM; ++g) {
    if (g >= gc) break;
    float M = m[g], L = l[g];
    if (NG == 2) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], 16);
      const float lo2 = __shfl_xor_sync(0xffffffffu, l[g], 16);
      M = fmaxf(m[g], mo);
      const float fa = expf(m[g] - M), fb = expf(mo - M);
#pragma unroll
      for (int e = 0; e < LE; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
        acc[g][e] = fmaf(acc[g][e], fa, ao * fb);
      }
      L = fmaf(l[g], fa, lo2 * fb);
    }
    if (grp == 0) {
      if (li == 0) {
        s_m[warp][g] = M;
        s_l[warp][g] = L;
      }
#pragma unroll
      for (int e = 0; e < LE; ++e) {
        const int c = Row::col(li, e);
        if (c < a.Dv) s_acc[warp][c] = acc[g][e];
      }
    }
    __syncthreads();
    float* out = a.ws + ((static_cast<size_t>(b) * a.Hq + hq0 + g) *
                             a.n_split + j) * (a.Dv + 2);
    for (int c = threadIdx.x; c < a.Dv; c += THREADS) {
      float Mx, Lx;
      out[c] = fd::merge_warps<WARPS>(&s_m[0][g], &s_l[0][g], &s_acc[0][c],
                                      GCM, DM, Mx, Lx);
      if (c == 0) {
        out[a.Dv] = Mx;
        out[a.Dv + 1] = Lx;
      }
    }
    __syncthreads();                      // s_acc is the next head's
  }
}

// o[b, hq] from the live spans' partials, in span order
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
dense_decode_merge_kernel(const Args a) {
  const Plan pl = plan_of(valid_span(a.sc, a.window, a.Smax), a.n_split);
  const int bh = blockIdx.x;
  const float* w = a.ws + static_cast<size_t>(bh) * a.n_split * (a.Dv + 2);
  for (int c = threadIdx.x; c < a.Dv; c += MERGE_THREADS) {
    float M, L;
    const float r = fd::merge_spans(w, 0, pl.n, a.Dv, c, M, L);
    if (a.lse != nullptr) {
      static_cast<float*>(a.o)[static_cast<size_t>(bh) * a.Dv + c] = r;
      if (c == 0) a.lse[bh] = L == 0.f ? NEG_INF : M + logf(L);
    } else {
      static_cast<T*>(a.o)[static_cast<size_t>(bh) * a.Dv + c] =
          from_f32<T>(r);
    }
  }
}

template <typename T, int GCM, int R, bool VEC>
cudaError_t launch_route(const Args& a, int chunks, cudaStream_t s) {
  const dim3 grid(a.n_split, a.B * a.Hkv, chunks);
  dense_decode_kernel<T, GCM, R, VEC><<<grid, THREADS, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dense_decode_merge_kernel<T><<<a.B * a.Hq, MERGE_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int GCM>
cudaError_t launch_gcm(const Args& a, int chunks, bool vec, cudaStream_t s) {
  if (!vec) return launch_route<T, GCM, 32, false>(a, chunks, s);
  if (a.D <= 16 * LE && a.Dv <= 16 * LE)
    return launch_route<T, GCM, 16, true>(a, chunks, s);
  return launch_route<T, GCM, 32, true>(a, chunks, s);
}

template <typename T>
cudaError_t launch(const Args& a, int chunks, bool vec, cudaStream_t s) {
  if (a.gc <= 1) return launch_gcm<T, 1>(a, chunks, vec, s);
  if (a.gc <= 2) return launch_gcm<T, 2>(a, chunks, vec, s);
  if (a.gc <= 4) return launch_gcm<T, 4>(a, chunks, vec, s);
  if (a.gc <= 8) return launch_gcm<T, 8>(a, chunks, vec, s);
  return launch_gcm<T, MAX_GC>(a, chunks, vec, s);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// q (B, Hq, D) at strides (q_sb, q_sh, 1); caches (B, Hkv, Smax, D | Dv)
// at strides (k_sb, k_sh, k_ss, 1) and (v_sb, v_sh, v_ss, 1); cache_len
// and offset each a device scalar (int32, or int64 where *_is64) or, with
// a null pointer, the value given.  o (B, Hq, Dv) in q's dtype, or with a
// non-null lse fp32 o and lse (B, Hq); workspace B * Hq * n_split *
// (Dv + 2) floats.  vec = 1 takes the vector route, which needs D and Dv
// multiples of 16 bytes' worth of elements and 16-byte aligned K/V bases
// and strides.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* len_ptr,
    const void* off_ptr, void* o, void* lse, void* workspace,
    long long q_sb, long long q_sh, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long len_value, long long off_value, int len_is64, int off_is64,
    int B, int Hq, int Hkv, int Smax, int D, int Dv, int window,
    int n_split, float scale, int dtype, int vec, int partials,
    void* stream) {
  if (D < 1 || D > MAX_D || Dv < 1 || Dv > MAX_D || Hkv < 1 || Hq < Hkv ||
      Hq % Hkv || Smax < 1 || window < 0 || n_split < 1 ||
      workspace == nullptr || (partials && lse == nullptr) ||
      (dtype != DTYPE_BF16 && dtype != DTYPE_F32))
    return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  int gc = G;
  if (G > MAX_GC)
    for (gc = MAX_GC; G % gc; --gc) {
    }
  const int chunks = G / gc;
  if (static_cast<long long>(B) * Hkv > 65535 || chunks > 65535)
    return cudaErrorInvalidValue;
  if (vec) {
    const int w = dtype == DTYPE_BF16 ? 8 : 4;
    if (D % w || Dv % w || !aligned16(k) || !aligned16(v) || k_sb % w ||
        k_sh % w || k_ss % w || v_sb % w || v_sh % w || v_ss % w)
      return cudaErrorInvalidValue;
  }
  if (B == 0) return cudaSuccess;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.sc = {len_ptr, off_ptr, len_value, off_value, len_is64, off_is64};
  a.o = o;
  a.lse = partials ? static_cast<float*>(lse) : nullptr;
  a.ws = static_cast<float*>(workspace);
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_sh = k_sh;
  a.k_ss = k_ss;
  a.v_sb = v_sb;
  a.v_sh = v_sh;
  a.v_ss = v_ss;
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Smax = Smax;
  a.D = D;
  a.Dv = Dv;
  a.window = window;
  a.n_split = n_split;
  a.gc = gc;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(a, chunks, vec != 0, s);
  return launch<float>(a, chunks, vec != 0, s);
}
