// Device code shared by the flash-decoding kernels: the split route of
// paged_attention.cu (rows found through a page table) and
// decode_attention.cu (rows of a dense cache found through its strides).
// Each kernel keeps its own row addressing and its own rule for which
// positions are live; this is what they do with the rows once found:
//   - Row8: a lane's 8 elements of a K or V row as 16-byte loads;
//   - online_step: one batch of positions into a query head's fp32 online
//     softmax (m, l, acc);
//   - merge_warps: a block's warps' partials merged through shared memory
//     in a fixed order;
//   - merge_spans: a (slot, query head)'s partials, workspace rows of
//     (acc[Dv], m, l), merged in span order (no atomics: the same bits
//     every call).
// A warp's two halves still merge in each kernel's own code: there the
// compiler picks which product of acc * fa + ao * fb it fuses into an FMA,
// and a shared copy moved the paged kernel's pick and so its bits, which
// its own code keeps as they were (benchmarks/paged_bits_ab.py holds them
// against another tree's).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace fd {

constexpr int LE = 8;  // elements of a row a lane owns

// A lane's 8 elements of a row, c0 .. c0 + 7: one (bf16) or two (f32)
// 16-byte words; words at or past the row's width are 0 and not read.
template <typename T>
struct Row8 {
  static constexpr int VEC = 16 / sizeof(T);   // elements a word
  static constexpr int W = LE / VEC;           // words
  static constexpr int REGS = 4 * W;
  uint4 w[W];

  // the column of a lane's element e, the lane li of its row group
  static __device__ __forceinline__ int col(int li, int e) {
    return LE * li + e;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ void load(const T* row, int c0, int width) {
#pragma unroll
    for (int i = 0; i < W; ++i)
      w[i] = c0 + i * VEC < width
                 ? *reinterpret_cast<const uint4*>(row + c0 + i * VEC)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ void to_f32(float (&f)[LE]) const;
};

template <>
__device__ __forceinline__ void Row8<float>::to_f32(float (&f)[LE]) const {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    f[4 * i] = __uint_as_float(w[i].x);
    f[4 * i + 1] = __uint_as_float(w[i].y);
    f[4 * i + 2] = __uint_as_float(w[i].z);
    f[4 * i + 3] = __uint_as_float(w[i].w);
  }
}

template <>
__device__ __forceinline__ void Row8<__nv_bfloat16>::to_f32(
    float (&f)[LE]) const {
  const uint32_t u[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// the sum over a row group of R lanes (R a power of two, <= 32)
template <int R>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = R / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// U positions, the u-th at t + stride u and live below t1, into one query
// head's online softmax: qf the lane's columns of q, kr / vr the rows
// (zero past t1), R lanes a row
template <int R, int U, typename Row>
__device__ __forceinline__ void online_step(const float (&qf)[LE],
                                            const Row (&kr)[U],
                                            const Row (&vr)[U], int t,
                                            int stride, int t1, float scale,
                                            float& m, float& l,
                                            float (&acc)[LE]) {
  float s[U];
  float mx = NEG_INF;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float kf[LE];
    kr[u].to_f32(kf);
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < LE; ++e) dot = fmaf(qf[e], kf[e], dot);
    s[u] = group_sum<R>(dot) * scale;
    if (t + stride * u < t1) mx = fmaxf(mx, s[u]);
  }
  const float m_new = fmaxf(m, mx);
  const float corr = expf(m - m_new);
  float p[U], ps = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    p[u] = t + stride * u < t1 ? expf(s[u] - m_new) : 0.f;
    ps += p[u];
  }
  l = l * corr + ps;
  m = m_new;
#pragma unroll
  for (int e = 0; e < LE; ++e) acc[e] *= corr;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float vf[LE];
    vr[u].to_f32(vf);
#pragma unroll
    for (int e = 0; e < LE; ++e) acc[e] = fmaf(p[u], vf[e], acc[e]);
  }
}

// one head's column of the WARPS warps' partials in shared memory, merged
// in warp order: warp w's m, l at m[w * ms], l[w * ms] and its column at
// acc[w * as]; returns the column, (M, L) the merged pair
template <int WARPS>
__device__ __forceinline__ float merge_warps(const float* m, const float* l,
                                             const float* acc, int ms,
                                             int as, float& M, float& L) {
  M = NEG_INF;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) M = fmaxf(M, m[w * ms]);
  L = 0.f;
  float O = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const float f = expf(m[w * ms] - M);
    L = fmaf(l[w * ms], f, L);
    O = fmaf(acc[w * as], f, O);
  }
  return O;
}

// column c of a (slot, query head)'s spans i0 .. i1 - 1, each Dv + 2 floats
// of w (acc[Dv], m, l), merged in span order: returns the normalised column
// (0 where no span holds a live position), (M, L) the merged pair
__device__ __forceinline__ float merge_spans(const float* w, int i0, int i1,
                                             int Dv, int c, float& M,
                                             float& L) {
  M = NEG_INF;
  for (int i = i0; i < i1; ++i)
    M = fmaxf(M, w[static_cast<size_t>(i) * (Dv + 2) + Dv]);
  L = 0.f;
  float O = 0.f;
  for (int i = i0; i < i1; ++i) {
    const float* wi = w + static_cast<size_t>(i) * (Dv + 2);
    const float f = expf(wi[Dv] - M);
    L = fmaf(wi[Dv + 1], f, L);
    O = fmaf(wi[c], f, O);
  }
  return O / (L == 0.f ? 1.f : L);
}

}  // namespace fd
