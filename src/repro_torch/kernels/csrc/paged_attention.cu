// Single-token GQA decode attention over a paged KV pool.
//
// Replaces the TPU kernel
// src/repro/kernels/paged_attention.py::_paged_attention_kernel (driver
// paged_attention_pallas).  That kernel rides the page table on scalar
// prefetch, stages every one of a slot's maxp pages into VMEM and masks
// positions >= seq_lens[b] afterwards, so it reads the trash page and the
// unallocated tail too.
//
// Bound on the H100: memory.  Each cached K/V row is used once per query
// head of its group (G = 1 at deepseek_7b's full width): ~1 flop per byte,
// so the least time is the live K/V bytes, sum_b seq_lens[b] * Hkv *
// (D + Dv) * bytes, over 3.35 TB/s.
//
// Design: one thread block (8 warps) per (kv head h, head chunk c, slot b),
// holding GC query heads of that kv head in registers: GC is the largest
// divisor of the group size G that is at most 8, and the G / GC chunks of
// one kv head are separate blocks, so any G works (G = 12 runs as 2 chunks
// of 6) while a block's registers stay bounded.  The block reads seq_lens[b]
// and page_table[b, j] itself (Hopper has no scalar prefetch) and walks
// only positions t < seq_lens[b], page by page: it never reads a row at or
// past the slot's length, so the trash page and the unallocated tail cost
// nothing and cannot leak.  A warp takes 4 positions at a time; lane i
// reads elements i, i+32, ... of each row, so one row of one head (D
// contiguous elements in the (n_pages, page, Hkv, D) pool) is a coalesced
// read, and the 4 positions' K and V rows are in flight together.  Scores
// are fp32 warp-shuffle dot products; each warp keeps its own fp32 online
// softmax (m, l, acc) per query head, and the 8 warps' partial results are
// merged through shared memory at the end.  seq_lens[b] == 0 writes zeros
// (l = 0 is divided by 1).  D and Dv up to 128, any G.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int TOK = 4;        // positions per warp per step
constexpr int MAX_D = 128;
constexpr int E = MAX_D / 32;  // elements per lane per row

template <typename T, int GC>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ seq_lens, T* __restrict__ o,
                    int Hq, int Hkv, int D, int Dv, int page, int maxp,
                    float scale) {
  __shared__ float s_m[WARPS][GC];
  __shared__ float s_l[WARPS][GC];
  __shared__ float s_acc[WARPS][GC][MAX_D];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.x, b = blockIdx.z;
  // first query head of this block: kv head h's group, chunk blockIdx.y
  const int hq0 = h * (Hq / Hkv) + blockIdx.y * GC;
  int len = seq_lens[b];
  len = max(0, min(len, maxp * page));
  const int* pt = page_table + static_cast<size_t>(b) * maxp;

  float qf[GC][E];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const T* qg = q + (static_cast<size_t>(b) * Hq + hq0 + g) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = lane + 32 * e;
      qf[g][e] = c < D ? to_f32(qg[c]) : 0.f;
    }
  }

  float m[GC], l[GC], acc[GC][E];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int base = warp * TOK; base < len; base += WARPS * TOK) {
    float kv[TOK][E], vv[TOK][E];
#pragma unroll
    for (int u = 0; u < TOK; ++u) {
      const int t = base + u;
      if (t < len) {
        const size_t row =
            (static_cast<size_t>(pt[t / page]) * page + t % page) * Hkv + h;
        const T* kr = k_pages + row * D;
        const T* vr = v_pages + row * Dv;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int c = lane + 32 * e;
          kv[u][e] = c < D ? to_f32(kr[c]) : 0.f;
          vv[u][e] = c < Dv ? to_f32(vr[c]) : 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kv[u][e] = vv[u][e] = 0.f;
      }
    }

#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float s[TOK];
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < TOK; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qf[g][e], kv[u][e], dot);
        s[u] = warp_sum(dot) * scale;
        if (base + u < len) mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      float p[TOK], ps = 0.f;
#pragma unroll
      for (int u = 0; u < TOK; ++u) {
        p[u] = base + u < len ? expf(s[u] - m_new) : 0.f;
        ps += p[u];
      }
      l[g] = l[g] * corr + ps;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[g][e] * corr;
#pragma unroll
        for (int u = 0; u < TOK; ++u) a = fmaf(p[u], vv[u][e], a);
        acc[g][e] = a;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = lane + 32 * e;
      if (c < Dv) s_acc[warp][g][c] = acc[g][e];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < GC * Dv; idx += WARPS * 32) {
    const int g = idx / Dv, c = idx - g * Dv;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, s_m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(s_m[w][g] - M);
      L = fmaf(s_l[w][g], f, L);
      O = fmaf(s_acc[w][g][c], f, O);
    }
    o[(static_cast<size_t>(b) * Hq + hq0 + g) * Dv + c] =
        from_f32<T>(O / (L == 0.f ? 1.f : L));
  }
}

template <typename T, int GC>
cudaError_t launch_g(const void* q, const void* kp, const void* vp,
                     const int* pt, const int* sl, void* o, int B, int Hq,
                     int Hkv, int D, int Dv, int page, int maxp, float scale,
                     cudaStream_t stream) {
  dim3 grid(Hkv, Hq / Hkv / GC, B);
  paged_decode_kernel<T, GC><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pt, sl, static_cast<T*>(o), Hq, Hkv, D, Dv,
      page, maxp, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* pt, const int* sl, void* o, int B, int Hq,
                   int Hkv, int D, int Dv, int page, int maxp, float scale,
                   cudaStream_t stream) {
#define REPRO_PAGED_G(G_)                                                   \
  case G_:                                                                  \
    return launch_g<T, G_>(q, kp, vp, pt, sl, o, B, Hq, Hkv, D, Dv, page,   \
                           maxp, scale, stream);
  const int G = Hq / Hkv;
  int gc = 8;
  while (G % gc) --gc;
  switch (gc) {
    REPRO_PAGED_G(1)
    REPRO_PAGED_G(2)
    REPRO_PAGED_G(3)
    REPRO_PAGED_G(4)
    REPRO_PAGED_G(5)
    REPRO_PAGED_G(6)
    REPRO_PAGED_G(7)
    REPRO_PAGED_G(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_PAGED_G
}

}  // namespace

extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* seq_lens, void* o, int B,
                                      int Hq, int Hkv, int D, int Dv,
                                      int page, int maxp, float scale,
                                      int dtype, void* stream) {
  if (D < 1 || D > MAX_D || Dv < 1 || Dv > MAX_D || Hkv < 1 || Hq % Hkv ||
      page < 1 || maxp < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* sl = static_cast<const int*>(seq_lens);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, pt, sl, o, B, Hq, Hkv,
                                 D, Dv, page, maxp, scale, s);
  if (dtype == DTYPE_F32)
    return launch<float>(q, k_pages, v_pages, pt, sl, o, B, Hq, Hkv, D, Dv,
                         page, maxp, scale, s);
  return cudaErrorInvalidValue;
}
