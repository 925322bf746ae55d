"""Decode attention over a dense KV cache: the CUDA kernel
(``csrc/decode_attention.cu``) and its plain versions.

q is ``(B, Hq, 1, D)``; the caches are ``(B, Hkv, Smax, D | Dv)``, as
``models/layers.py`` hands them over: a transposed view of the
``(B, Smax, Hkv, D)`` buffer, read through its strides, never copied.  A
call attends over the positions ``offset + i < cache_len`` (and
``>= cache_len - sliding_window`` with a window); ``cache_len`` and
``offset`` are ints or 0-d integer tensors.  It returns the fp32
softmax-weighted V cast to q's dtype, or with ``partials`` the fp32
``(o (B, Hkv, G, Dv), lse (B, Hkv, G))`` that ``merge_attention`` takes.

Three versions of one function (the reference's
``repro.kernels.ops.decode_attention``, plain jnp, not a TPU kernel):

* ``decode_attention_torch`` — the plain version: the cache scored
  ``chunk`` positions at a time, each chunk's softmax taken whole in fp32
  as the reference's, the chunks merged; every position scored and
  masked.  With one chunk it is the reference's formula bit for bit.
* ``decode_attention_split_torch`` — the kernel's partition-and-merge
  arithmetic in plain PyTorch (``plan_spans``), for the tests and
  ``chip_smoke.py``: only the valid positions read, each span's (m, l,
  acc) kept, the spans merged in order.
* ``decode_attention_cuda`` — the kernel (flash-decoding): it reads
  ``cache_len`` and ``offset`` on the device and reads no K/V row outside
  the valid positions, so a captured step's work follows ``cache_len``.
  Its route (vector or scalar, ``vector_route``) depends on dtype, shape
  and alignment only, its grid (``split_plan``) on the shapes only.

A slice with no valid position (a data rank's slice past ``cache_len``)
gives, with ``partials``, lse = NEG_INF and weight 0 in
``merge_attention``; its o is finite (the plain version's the mean of
V, the kernel's 0).
"""
from __future__ import annotations

import math
import torch

from repro_torch.kernels import _build

#: kernel launches so far (a run resets it to 0 and reads it afterwards),
#: and of those the ones that took the scalar route
LAUNCHES = 0
LAUNCHES_SCALAR = 0

NEG_INF = -1.0e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: query heads a thread block holds: the whole group up to this
MAX_GROUP = 12
#: positions of a dense decode cache the plain version scores at a time
DECODE_CHUNK = 32768

#: the plan: a fixed number of blocks a (slot, kv head) divide the valid
#: positions among themselves in spans rounded up to GRAIN positions, at
#: least MIN_SPAN; about TARGET_BLOCKS blocks a call (~8 an SM of the H100)
GRAIN = 16
MIN_SPAN = 128
TARGET_BLOCKS = 1056


def merge_attention(o, lse):
    """Partial attention results over disjoint sets of positions merged
    into the result over all of them: o (n, ..., Dv) each normalised over
    its own positions, lse (n, ...) each one's log-sum-exp of the
    scores.  A set whose every position is masked has lse ~ ``NEG_INF``
    and weight 0.  One set is returned as it is.  The decode's chunks
    and the data ranks' slices of a sequence-split cache merge here."""
    if o.shape[0] == 1:
        return o[0], lse[0]
    m = lse.amax(0)
    w = torch.exp(lse - m)
    tot = w.sum(0)
    return ((o * w[..., None]).sum(0) / tot[..., None],
            m + torch.log(tot))


def decode_attention_torch(q, k_cache, v_cache, cache_len, *, scale=None,
                           sliding_window: int = 0, offset=0,
                           chunk: int = DECODE_CHUNK, partials: bool = False):
    """The plain version.  Each chunk's K and V are upcast alone, so a
    long cache's fp32 temporaries stay a chunk's; every position is
    scored and masked (a comparison with ``cache_len``, so no host
    sync)."""
    B, Hq, _, D = q.shape
    _, Hkv, Smax, Dv = v_cache.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, G, D)
    os_, lses = [], []
    for lo in range(0, Smax, chunk):
        hi = min(lo + chunk, Smax)
        s = torch.einsum("bhgd,bhkd->bhgk", qf,
                         k_cache[:, :, lo:hi].float()) * scale
        pos = torch.arange(lo, hi, device=q.device) + offset
        mask = pos < cache_len
        if sliding_window > 0:
            mask &= pos >= (cache_len - sliding_window)
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        os_.append(torch.einsum("bhgk,bhkd->bhgd", p,
                                v_cache[:, :, lo:hi].float()))
        lses.append(torch.logsumexp(s, dim=-1))
        del s, p
    o, lse = merge_attention(torch.stack(os_), torch.stack(lses))
    if partials:
        return o, lse
    return o.reshape(B, Hq, 1, Dv).to(q.dtype)


# ---------------------------------------------------------------- the plan

def head_chunk(G: int) -> int:
    """Query heads a thread block holds: the group up to ``MAX_GROUP``,
    else its largest divisor at most that."""
    gc = min(G, MAX_GROUP)
    while G % gc:
        gc -= 1
    return gc


def split_plan(B: int, Hkv: int, G: int, Smax: int) -> int:
    """n_split: the blocks a (slot, kv head, head chunk).  A function of
    the shapes alone: a captured graph fixes the grid."""
    pairs = B * Hkv * (G // head_chunk(G))
    n = -(-TARGET_BLOCKS // max(pairs, 1))
    return max(1, min(n, -(-Smax // MIN_SPAN)))


def valid_span(cache_len: int, offset: int, window: int, smax: int):
    """The local positions [lo, hi) a call attends over."""
    hi = min(max(cache_len - offset, 0), smax)
    lo = min(max(cache_len - window - offset, 0), hi) if window > 0 else 0
    return lo, hi


def plan_spans(lo: int, hi: int, n_split: int):
    """[(block j, first position, end)] of the blocks that read anything,
    in the order the merge takes them (``plan_of`` in the kernel): spans
    of ceil((hi - lo) / n_split) positions rounded up to ``GRAIN``, at
    least ``MIN_SPAN``, from lo."""
    n = hi - lo
    per = -(-n // n_split)                         # ceil
    per = max(-(-per // GRAIN) * GRAIN, MIN_SPAN)
    return [(j, lo + j * per, min(lo + (j + 1) * per, hi))
            for j in range(-(-n // per))]


def decode_attention_split_torch(q, k_cache, v_cache, cache_len, *,
                                 scale=None, sliding_window: int = 0,
                                 offset=0, n_split: int,
                                 partials: bool = False):
    """``decode_attention_torch`` computed as the kernel plans it: only
    the valid positions, cut into the plan's spans (``plan_spans``), each
    span's masked softmax kept as (m, l, acc), the spans merged in order;
    no valid position gives o = 0 and lse = NEG_INF.  ``cache_len`` and
    ``offset`` are read on the host."""
    B, Hq, _, D = q.shape
    _, Hkv, Smax, Dv = v_cache.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lo, hi = valid_span(int(cache_len), int(offset), sliding_window, Smax)
    qf = q.float().reshape(B, Hkv, G, D)
    ms, ls, accs = [], [], []
    for _, t0, t1 in plan_spans(lo, hi, n_split):
        s = torch.einsum("bhgd,bhkd->bhgk", qf,
                         k_cache[:, :, t0:t1].float()) * scale
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgk,bhkd->bhgd", p,
                                 v_cache[:, :, t0:t1].float()))
    if ms:
        m = torch.stack(ms)
        M = m.amax(0)
        f = torch.exp(m - M)
        L = (torch.stack(ls) * f).sum(0)
        o = (torch.stack(accs) * f[..., None]).sum(0) / torch.where(
            L == 0.0, 1.0, L)[..., None]
        lse = torch.where(L == 0.0, NEG_INF, M + torch.log(L))
    else:
        o = qf.new_zeros((B, Hkv, G, Dv))
        lse = qf.new_full((B, Hkv, G), NEG_INF)
    if partials:
        return o, lse
    return o.reshape(B, Hq, 1, Dv).to(q.dtype)


# ---------------------------------------------------------------- the kernel

def vector_route(k_cache, v_cache) -> bool:
    """Whether the kernel takes its vector route: head dims that are
    whole 16-byte words of the dtype (8 bf16, 4 f32), K/V bases 16-byte
    aligned and their strides whole words."""
    vec = 16 // k_cache.element_size()
    return (k_cache.shape[-1] % vec == 0 and v_cache.shape[-1] % vec == 0
            and all(t.data_ptr() % 16 == 0
                    and all(s % vec == 0 for s in t.stride()[:3])
                    for t in (k_cache, v_cache)))


def _scalar(x, device, what):
    """(device pointer or None, int64 flag, value) for ``cache_len`` or
    ``offset``: a one-element int32/int64 tensor on q's device is read
    there by the kernel; an int is passed by value."""
    if not isinstance(x, torch.Tensor):
        return None, 0, int(x)
    if (x.numel() != 1 or x.device != device
            or x.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f"decode_attention_cuda: {what} must be an int or "
                         f"a one-element int32 or int64 tensor on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    return x.data_ptr(), int(x.dtype == torch.int64), 0


def decode_attention_cuda(q, k_cache, v_cache, cache_len, *, scale=None,
                          sliding_window: int = 0, offset=0,
                          partials: bool = False):
    """The kernel: same arguments and result as ``decode_attention_torch``
    (no ``chunk``).  q and
    the caches bf16/f32 of one dtype on one CUDA device, each with unit
    stride on its last dimension (any other strides), head dims <= 256,
    any Hq / Hkv."""
    global LAUNCHES, LAUNCHES_SCALAR
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Smax, Dk = k_cache.shape
    Dv = v_cache.shape[-1]
    if not (q.is_cuda and k_cache.device == q.device
            and v_cache.device == q.device):
        raise ValueError("decode_attention_cuda needs q and the caches on "
                         "one CUDA device")
    if (q.dtype not in DTYPE_CODES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise ValueError(f"decode_attention_cuda takes bf16/f32 q and "
                         f"caches of one dtype, got {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if (Sq != 1 or Bk != B or Dk != D or v_cache.shape[:3] != (B, Hkv, Smax)
            or Hkv < 1 or Hq % Hkv):
        raise ValueError(
            f"decode_attention_cuda: shapes q {tuple(q.shape)} k "
            f"{tuple(k_cache.shape)} v {tuple(v_cache.shape)} disagree")
    if not (1 <= D <= MAX_HEAD_DIM and 1 <= Dv <= MAX_HEAD_DIM):
        raise ValueError(f"decode_attention_cuda: head dims {D}, {Dv} must "
                         f"be in [1, {MAX_HEAD_DIM}]")
    if any(t.stride(-1) != 1 for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention_cuda needs unit stride on the "
                         "head dim of q and the caches")
    if sliding_window < 0:
        raise ValueError(f"sliding_window {sliding_window} < 0")
    len_p, len64, len_v = _scalar(cache_len, q.device, "cache_len")
    off_p, off64, off_v = _scalar(offset, q.device, "offset")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    G = Hq // Hkv
    n_split = split_plan(B, Hkv, G, Smax)
    vec = vector_route(k_cache, v_cache)
    f32 = dict(dtype=torch.float32, device=q.device)
    ws = torch.empty(B * Hq * n_split * (Dv + 2), **f32)
    if partials:
        o = torch.empty((B, Hkv, G, Dv), **f32)
        lse = torch.empty((B, Hkv, G), **f32)
    else:
        o = torch.empty((B, Hq, 1, Dv), dtype=q.dtype, device=q.device)
        lse = None
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), len_p,
            off_p, o.data_ptr(), lse.data_ptr() if partials else None,
            ws.data_ptr(), q.stride(0), q.stride(1), *k_cache.stride()[:3],
            *v_cache.stride()[:3], len_v, off_v, len64, off64, B, Hq, Hkv,
            Smax, D, Dv, int(sliding_window), n_split, float(scale),
            DTYPE_CODES[q.dtype], int(vec), int(partials),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention_launch")
    LAUNCHES += 1
    if not vec:
        LAUNCHES_SCALAR += 1
    return (o, lse) if partials else o
