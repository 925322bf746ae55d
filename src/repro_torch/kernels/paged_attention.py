"""Paged decode attention: the CUDA kernel (``csrc/paged_attention.cu``)
and its plain version.

Pools are ``(n_pages, page, Hkv, D | Dv)``; sequence position ``p`` of
slot ``b`` lives at row ``p % page`` of page ``page_table[b, p // page]``.
``paged_attention_cuda`` replaces the Pallas kernel
``repro.kernels.paged_attention`` and reads only the rows below
``seq_lens[b]``.  ``paged_attention_torch`` gathers every table entry into
the dense layout and masks, as ``repro.kernels.ops.paged_attention`` does;
a slot of length 0 gives zeros in both (l = 0 is divided by 1).

On the card the kernel has two routes, chosen here from the head dims and
the alignment (``split_route``), never by the caller: the split route
(flash-decoding: each slot cut into partitions of ``partition_pages(page)``
pages, one thread block a partition, 16-byte loads, partials merged in
partition order by a second kernel) and, for anything else, the scalar
route (one thread block walks a whole slot).
``paged_attention_split_torch`` is the split route's partition-and-merge
arithmetic in plain PyTorch, for the tests and ``chip_smoke.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

#: kernel launches so far (a run resets it to 0 and reads it afterwards),
#: and of those the ones that took the scalar route
LAUNCHES = 0
LAUNCHES_SCALAR = 0

NEG_INF = -1.0e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
#: positions a partition of the split route holds, rounded to whole pages
PARTITION = 128


def partition_pages(page: int) -> int:
    """Pages a partition of the split route holds at this page size."""
    return max(1, PARTITION // page)


def split_route(q, k_pages, v_pages) -> bool:
    """Whether the kernel takes its split route: head dims that are whole
    16-byte words of the dtype (8 bf16, 4 f32) and 16-byte aligned q and
    pools."""
    vec = 16 // q.element_size()
    return (q.shape[-1] % vec == 0 and v_pages.shape[-1] % vec == 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)))


def paged_attention_torch(q, k_pages, v_pages, page_table, seq_lens, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, D); page_table: (B, maxp) int; seq_lens: (B,) int.
    Returns (B, Hq, Dv)."""
    B, Hq, D = q.shape
    _, page, Hkv, Dv = v_pages.shape
    G = Hq // Hkv
    S = page_table.shape[1] * page
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    pt = page_table.long()
    k = k_pages[pt].reshape(B, S, Hkv, D).transpose(1, 2)
    v = v_pages[pt].reshape(B, S, Hkv, Dv).transpose(1, 2)
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k.float()) * scale
    mask = (torch.arange(S, device=q.device)[None, :]
            < seq_lens.to(q.device)[:, None])[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v.float()) / l
    return o.reshape(B, Hq, Dv).to(q.dtype)


def paged_attention_split_torch(q, k_pages, v_pages, page_table, seq_lens,
                                *, part: int, scale: Optional[float] = None
                                ) -> torch.Tensor:
    """``paged_attention_torch`` computed as the split route does: each
    slot's positions cut into partitions of ``part`` positions, each
    partition's masked softmax kept as (m, l, acc) partials, and the
    partials merged in partition order (a partition with no live position
    has m = NEG_INF, l = 0 and weighs 0).  Returns (B, Hq, Dv)."""
    B, Hq, D = q.shape
    _, page, Hkv, Dv = v_pages.shape
    G = Hq // Hkv
    S = page_table.shape[1] * page
    n_part = -(-S // part)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    pt = page_table.long()
    k = k_pages[pt].reshape(B, S, Hkv, D).transpose(1, 2).float()
    v = v_pages[pt].reshape(B, S, Hkv, Dv).transpose(1, 2).float()
    pad = n_part * part - S
    k = torch.nn.functional.pad(k, (0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k) * scale
    mask = (torch.arange(n_part * part, device=q.device)[None, :]
            < seq_lens.to(q.device)[:, None])[:, None, None]
    s = torch.where(mask, s, NEG_INF).reshape(B, Hkv, G, n_part, part)
    mask = mask.reshape(B, 1, 1, n_part, part)
    m = s.amax(-1)                                    # (B, Hkv, G, n_part)
    p = torch.exp(s - m[..., None]) * mask
    l = p.sum(-1)
    acc = torch.einsum("bhgjk,bhjkd->bhgjd", p,
                       v.reshape(B, Hkv, n_part, part, Dv))
    M = m.amax(-1, keepdim=True)
    f = torch.exp(m - M)
    L = (l * f).sum(-1)
    o = (acc * f[..., None]).sum(-2) / torch.where(L == 0.0, 1.0, L)[..., None]
    return o.reshape(B, Hq, Dv).to(q.dtype)


def paged_attention_cuda(q, k_pages, v_pages, page_table, seq_lens, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """The kernel: same arguments and result as ``paged_attention_torch``.
    q and the pools contiguous bf16/f32, page_table and seq_lens contiguous
    int32, all on one CUDA device; head dims <= 128, any Hq / Hkv.  Table
    entries must be valid page ids: the kernel follows them unchecked."""
    global LAUNCHES, LAUNCHES_SCALAR
    B, Hq, D = q.shape
    n_pages, page, Hkv, Dk = k_pages.shape
    Dv = v_pages.shape[-1]
    maxp = page_table.shape[-1]
    tensors = (q, k_pages, v_pages, page_table, seq_lens)
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError("paged_attention_cuda needs every input on one "
                         "CUDA device")
    if (q.dtype not in DTYPE_CODES or k_pages.dtype != q.dtype
            or v_pages.dtype != q.dtype):
        raise ValueError(f"paged_attention_cuda takes bf16/f32 q and pools "
                         f"of one dtype, got {q.dtype}, {k_pages.dtype}, "
                         f"{v_pages.dtype}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("paged_attention_cuda needs int32 page_table and "
                         "seq_lens")
    if (Dk != D or v_pages.shape[:3] != (n_pages, page, Hkv)
            or page_table.shape != (B, maxp) or seq_lens.shape != (B,)
            or Hkv < 1 or Hq % Hkv):
        raise ValueError(
            f"paged_attention_cuda: shapes q {tuple(q.shape)} k_pages "
            f"{tuple(k_pages.shape)} v_pages {tuple(v_pages.shape)} "
            f"page_table {tuple(page_table.shape)} seq_lens "
            f"{tuple(seq_lens.shape)} disagree")
    if not (1 <= D <= MAX_HEAD_DIM and 1 <= Dv <= MAX_HEAD_DIM
            and maxp >= 1):
        raise ValueError(f"paged_attention_cuda: head dims {D}, {Dv} must be "
                         f"in [1, {MAX_HEAD_DIM}]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_cuda needs contiguous inputs")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lib = _build.load()
    o = torch.empty((B, Hq, Dv), dtype=q.dtype, device=q.device)
    split = split_route(q, k_pages, v_pages)
    part_pages = partition_pages(page)
    # the split route's fp32 partials (acc[Dv], m, l) per slot, query head
    # and partition
    ws = (torch.empty(B * Hq * -(-maxp // part_pages) * (Dv + 2),
                      dtype=torch.float32, device=q.device) if split
          else None)
    with torch.cuda.device(q.device):
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), o.data_ptr(),
            ws.data_ptr() if split else None, B, Hq, Hkv, D, Dv, page, maxp,
            part_pages, float(scale), DTYPE_CODES[q.dtype], int(split),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "paged_attention_launch")
    LAUNCHES += 1
    if not split:
        LAUNCHES_SCALAR += 1
    return o
