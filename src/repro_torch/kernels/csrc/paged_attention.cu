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
// Design: two routes, chosen by the wrapper from the shapes and the
// alignment.
//
// Split route (D and Dv multiples of 16 bytes' worth of elements, 16-byte
// aligned q and pools: every dense config's decode): flash-decoding.  Each
// slot's positions are cut into partitions of P positions (a whole number
// of pages, ~128), and one thread block (8 warps) takes one (kv head h,
// head chunk c, slot b, partition j).  The grid covers maxp * page
// positions from the table's shape, so the host needs no sync to read
// seq_lens; a block whose partition starts at or past seq_lens[b] returns
// at once, and no block walks more than P positions, so a long slot no
// longer sets the time while most SMs idle.  A block reads its partition's
// page ids into shared memory (beside seq_lens[b], not after it), then
// each half-warp takes one position at a time: lane i reads elements 8i .. 8i + 7 of the K and V rows with 16-byte
// loads (a 128-wide bf16 row is one half-warp load), and a lane issues the
// loads of all its batch's rows (up to 8 positions) before any arithmetic.
// Rows at or past seq_lens[b] are never read.  Scores and the online
// softmax are fp32, each half-warp keeping its own (m, l, acc) per query
// head; a warp's two halves merge by shuffles and the 8 warps through
// shared memory in a fixed order, and the block writes fp32 partials
// (acc[Dv], m, l) for its GC heads to a workspace (B, Hq, n_part,
// Dv + 2).  A second kernel merges a
// slot's live partitions in partition order, with no atomics, so the
// result is the same bits on every call; it writes o in q's dtype and
// zeros for seq_lens[b] == 0.  The row loads, the online softmax, the
// warps' merge and the partitions' merge are flash_decode.cuh's, shared
// with decode_attention.cu; the page table's addressing, the live
// partitions and the half-warps' merge are this file's.
//
// Scalar route (anything else: odd head dims, unaligned bases; the design
// before the split route): one thread block (8 warps) per (kv head h, head
// chunk c, slot b), holding GC query heads of that kv head in registers:
// GC is the largest divisor of the group size G that is at most 8, and the
// G / GC chunks of one kv head are separate blocks, so any G works (G = 12
// runs as 2 chunks of 6) while a block's registers stay bounded (the split
// route chunks heads the same way).  The block reads seq_lens[b] and
// page_table[b, j] itself (Hopper has no scalar prefetch) and walks only
// positions t < seq_lens[b], page by page: it never reads a row at or past
// the slot's length, so the trash page and the unallocated tail cost
// nothing and cannot leak.  A warp takes 4 positions at a time; lane i
// reads elements i, i+32, ... of each row, so one row of one head (D
// contiguous elements in the (n_pages, page, Hkv, D) pool) is a coalesced
// read, and the 4 positions' K and V rows are in flight together.  Scores
// are fp32 warp-shuffle dot products; each warp keeps its own fp32 online
// softmax (m, l, acc) per query head, and the 8 warps' partial results are
// merged through shared memory at the end.  seq_lens[b] == 0 writes zeros
// (l = 0 is divided by 1).  D and Dv up to 128, any G.
#include <cstdint>

#include "common.cuh"
#include "flash_decode.cuh"

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

// ------------------------------------------------------------ split route

namespace split {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LE = fd::LE;             // elements of a row a lane owns
constexpr int MAX_PART_PAGES = 128;    // page ids of one partition
constexpr int MERGE_THREADS = MAX_D;

template <typename T>
using Row8 = fd::Row8<T>;

// positions a half-warp loads at once: 8 K and 8 V words in flight a lane,
// fewer as the GC heads' registers grow
template <typename T, int GC>
__host__ __device__ constexpr int batch() {
  constexpr int u = 8 / Row8<T>::W;
  constexpr int v = GC <= 2 ? u : GC <= 4 ? u / 2 : u / 4;
  return v < 1 ? 1 : v;
}

template <typename T, int GC>
__global__ void __launch_bounds__(THREADS)
paged_decode_split_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages,
                          const int* __restrict__ page_table,
                          const int* __restrict__ seq_lens,
                          float* __restrict__ ws, int Hq, int Hkv, int D,
                          int Dv, int page, int maxp, int part_pages,
                          int n_part, float scale) {
  constexpr int U = batch<T, GC>();
  __shared__ int s_pid[MAX_PART_PAGES];
  __shared__ float s_m[WARPS][GC];
  __shared__ float s_l[WARPS][GC];
  __shared__ float s_acc[WARPS][GC][MAX_D];

  const int b = blockIdx.x / n_part, j = blockIdx.x - b * n_part;
  const int h = blockIdx.y;
  const int hq0 = h * (Hq / Hkv) + blockIdx.z * GC;
  const int P = part_pages * page;
  // the partition's page ids and seq_lens[b] in flight together: the table
  // is read whole, so no id waits for the length (ids past it go unused)
  const int* pt = page_table + static_cast<size_t>(b) * maxp + j * part_pages;
  for (int i = threadIdx.x; i < min(part_pages, maxp - j * part_pages);
       i += THREADS)
    s_pid[i] = pt[i];
  const int len = max(0, min(seq_lens[b], maxp * page));
  const int t0 = j * P;
  if (t0 >= len) return;                  // the whole block, before a sync
  const int t1 = min(t0 + P, len);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = lane >> 4, c0 = LE * (lane & 15);
  float qf[GC][LE];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    Row8<T> r;
    r.load(q + (static_cast<size_t>(b) * Hq + hq0 + g) * D, c0, D);
    r.to_f32(qf[g]);
  }
  float m[GC], l[GC], acc[GC][LE];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < LE; ++e) acc[g][e] = 0.f;
  }
  __syncthreads();                        // the page ids are in

  // warp w takes positions base + 2u + half, u < U, base = t0 + 2U w + ...
  for (int base = t0 + warp * 2 * U; base < t1; base += WARPS * 2 * U) {
    Row8<T> kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + 2 * u + half;
      if (t < t1) {
        const size_t row =
            (static_cast<size_t>(s_pid[(t - t0) / page]) * page + t % page) *
                Hkv + h;
        kr[u].load(k_pages + row * D, c0, D);
        vr[u].load(v_pages + row * Dv, c0, Dv);
      } else {
        kr[u].zero();
        vr[u].zero();
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g)
      fd::online_step<16, U>(qf[g], kr, vr, base + half, 2, t1, scale, m[g],
                             l[g], acc[g]);
  }

  // the warp's two half-warps, then the 8 warps in order
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const float mo = __shfl_xor_sync(0xffffffffu, m[g], 16);
    const float lo = __shfl_xor_sync(0xffffffffu, l[g], 16);
    const float M = fmaxf(m[g], mo);
    const float fa = expf(m[g] - M), fb = expf(mo - M);
#pragma unroll
    for (int e = 0; e < LE; ++e) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
      acc[g][e] = acc[g][e] * fa + ao * fb;
    }
    if (half == 0) {
      if (c0 == 0) {
        s_m[warp][g] = M;
        s_l[warp][g] = l[g] * fa + lo * fb;
      }
#pragma unroll
      for (int e = 0; e < LE; ++e)
        if (c0 + e < Dv) s_acc[warp][g][c0 + e] = acc[g][e];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < GC * Dv; idx += THREADS) {
    const int g = idx / Dv, c = idx - g * Dv;
    float M, L;
    const float O = fd::merge_warps<WARPS>(&s_m[0][g], &s_l[0][g],
                                           &s_acc[0][g][c], GC, GC * MAX_D,
                                           M, L);
    float* out =
        ws + ((static_cast<size_t>(b) * Hq + hq0 + g) * n_part + j) * (Dv + 2);
    out[c] = O;
    if (c == 0) {
      out[Dv] = M;
      out[Dv + 1] = L;
    }
  }
}

// o[b, hq] from the live partitions' partials, in partition order
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
paged_decode_merge_kernel(const float* __restrict__ ws,
                          const int* __restrict__ seq_lens, T* __restrict__ o,
                          int Hq, int Dv, int n_part, int P, int max_len) {
  const int bh = blockIdx.x, b = bh / Hq;
  const int len = max(0, min(seq_lens[b], max_len));
  const int live = (len + P - 1) / P;
  const float* w = ws + static_cast<size_t>(bh) * n_part * (Dv + 2);
  for (int c = threadIdx.x; c < Dv; c += MERGE_THREADS) {
    float M, L;
    o[static_cast<size_t>(bh) * Dv + c] =
        from_f32<T>(fd::merge_spans(w, 0, live, Dv, c, M, L));
  }
}

}  // namespace split

struct Args {
  const void *q, *kp, *vp;
  const int *pt, *sl;
  void* o;
  float* ws;
  int B, Hq, Hkv, D, Dv, page, maxp, part_pages;
  float scale;
};

template <typename T, int GC>
cudaError_t launch_split(const Args& a, cudaStream_t stream) {
  const int n_part = (a.maxp + a.part_pages - 1) / a.part_pages;
  dim3 grid(n_part * a.B, a.Hkv, a.Hq / a.Hkv / GC);
  split::paged_decode_split_kernel<T, GC>
      <<<grid, split::THREADS, 0, stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
          static_cast<const T*>(a.vp), a.pt, a.sl, a.ws, a.Hq, a.Hkv, a.D,
          a.Dv, a.page, a.maxp, a.part_pages, n_part, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split::paged_decode_merge_kernel<T>
      <<<a.B * a.Hq, split::MERGE_THREADS, 0, stream>>>(
          a.ws, a.sl, static_cast<T*>(a.o), a.Hq, a.Dv, n_part,
          a.part_pages * a.page, a.maxp * a.page);
  return cudaGetLastError();
}

template <typename T, int GC>
cudaError_t launch_gc(const Args& a, bool split_route, cudaStream_t stream) {
  if (split_route) return launch_split<T, GC>(a, stream);
  return launch_g<T, GC>(a.q, a.kp, a.vp, a.pt, a.sl, a.o, a.B, a.Hq, a.Hkv,
                         a.D, a.Dv, a.page, a.maxp, a.scale, stream);
}

template <typename T>
cudaError_t launch(const Args& a, bool split_route, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  int gc = 8;
  while (G % gc) --gc;
  switch (gc) {
    case 1: return launch_gc<T, 1>(a, split_route, stream);
    case 2: return launch_gc<T, 2>(a, split_route, stream);
    case 3: return launch_gc<T, 3>(a, split_route, stream);
    case 4: return launch_gc<T, 4>(a, split_route, stream);
    case 5: return launch_gc<T, 5>(a, split_route, stream);
    case 6: return launch_gc<T, 6>(a, split_route, stream);
    case 7: return launch_gc<T, 7>(a, split_route, stream);
    case 8: return launch_gc<T, 8>(a, split_route, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// q (B, Hq, D); pools (n_pages, page, Hkv, D | Dv); page_table (B, maxp)
// int32; seq_lens (B,) int32; o (B, Hq, Dv).  split = 1 takes the split
// route, which needs D and Dv multiples of 16 bytes' worth of elements,
// 16-byte aligned q and pools, and a workspace of B * Hq * n_part *
// (Dv + 2) floats, n_part = ceil(maxp / part_pages).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* seq_lens, void* o,
                                      void* workspace, int B, int Hq,
                                      int Hkv, int D, int Dv, int page,
                                      int maxp, int part_pages, float scale,
                                      int dtype, int split_route,
                                      void* stream) {
  if (D < 1 || D > MAX_D || Dv < 1 || Dv > MAX_D || Hkv < 1 || Hq % Hkv ||
      page < 1 || maxp < 1 || (dtype != DTYPE_BF16 && dtype != DTYPE_F32))
    return cudaErrorInvalidValue;
  const int vec = dtype == DTYPE_BF16 ? 8 : 4;
  if (split_route &&
      (part_pages < 1 || part_pages > split::MAX_PART_PAGES || D % vec ||
       Dv % vec || !aligned16(q) || !aligned16(k_pages) ||
       !aligned16(v_pages) || workspace == nullptr))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const Args a{q, k_pages, v_pages, static_cast<const int*>(page_table),
               static_cast<const int*>(seq_lens), o,
               static_cast<float*>(workspace), B, Hq, Hkv, D, Dv, page, maxp,
               part_pages, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(a, split_route != 0, s);
  return launch<float>(a, split_route != 0, s);
}
