"""Paged decode attention: the CUDA kernel (``csrc/paged_attention.cu``)
and its plain version.

Pools are ``(n_pages, page, Hkv, D | Dv)``; sequence position ``p`` of
slot ``b`` lives at row ``p % page`` of page ``page_table[b, p // page]``.
``paged_attention_cuda`` replaces the Pallas kernel
``repro.kernels.paged_attention`` and reads only the rows below
``seq_lens[b]``.  ``paged_attention_torch`` gathers every table entry into
the dense layout and masks, as ``repro.kernels.ops.paged_attention`` does;
a slot of length 0 gives zeros in both (l = 0 is divided by 1).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

#: kernel launches so far (a run resets it to 0 and reads it afterwards)
LAUNCHES = 0

NEG_INF = -1.0e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


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


def paged_attention_cuda(q, k_pages, v_pages, page_table, seq_lens, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """The kernel: same arguments and result as ``paged_attention_torch``.
    q and the pools contiguous bf16/f32, page_table and seq_lens contiguous
    int32, all on one CUDA device; head dims <= 128, any Hq / Hkv.  Table
    entries must be valid page ids: the kernel follows them unchecked."""
    global LAUNCHES
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
    with torch.cuda.device(q.device):
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), o.data_ptr(), B, Hq,
            Hkv, D, Dv, page, maxp, float(scale), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "paged_attention_launch")
    LAUNCHES += 1
    return o
