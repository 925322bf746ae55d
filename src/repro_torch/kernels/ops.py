"""Kernel entry points used by the model stack (the port of
``repro.kernels.ops`` for the serving path).

Each op with a kernel has two implementations:
  * ``kernel`` — the hand-written CUDA kernel (``flash_attention.py``,
                 ``paged_attention.py``, ``rmsnorm.py`` and ``csrc/``);
  * ``torch``  — its plain PyTorch version, beside the kernel.

``impl="auto"`` mirrors ``repro.kernels.ops._use_pallas``: the kernel for a
CUDA tensor, the plain version for a CPU tensor.  ``impl="kernel"`` on a
CPU tensor raises.  ``impl="torch"`` is the plain version on any device;
the tests and ``chip_smoke.py`` compare against it.  ``decode_attention``
never had a TPU kernel and is plain PyTorch only.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rmsnorm as _rn

NEG_INF = -1.0e30
IMPLS = ("auto", "kernel", "torch")


def _use_kernel(impl: str, x: torch.Tensor) -> bool:
    if impl == "torch":
        return False
    if impl == "auto":
        return x.is_cuda
    if impl == "kernel":
        if not x.is_cuda:
            raise ValueError("impl='kernel' needs CUDA tensors; the kernels "
                             "do not run on the CPU")
        return True
    raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


# ===========================================================================
# Flash attention (prefill)
# ===========================================================================

def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                    scale: Optional[float] = None, q_offset: int = 0,
                    impl: str = "auto"):
    """q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv)."""
    if _use_kernel(impl, q):
        return _fa.flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            sliding_window=sliding_window, scale=scale, q_offset=q_offset)
    return _fa.flash_attention_torch(q, k, v, causal=causal,
                                     sliding_window=sliding_window,
                                     scale=scale, q_offset=q_offset)


# ===========================================================================
# Decode attention (single new token vs. a dense cache)
# ===========================================================================

def decode_attention(q, k_cache, v_cache, cache_len: int, *, scale=None,
                     sliding_window: int = 0):
    """q: (B, Hq, 1, D); caches: (B, Hkv, Smax, D|Dv).  Attends over the
    first ``cache_len`` entries (the new token's K/V already written at
    ``cache_len - 1``)."""
    B, Hq, _, D = q.shape
    _, Hkv, Smax, Dv = v_cache.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k_cache.float()) * scale
    pos = torch.arange(Smax, device=q.device)
    mask = pos < cache_len
    if sliding_window > 0:
        mask &= pos >= (cache_len - sliding_window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, 1, Dv).to(q.dtype)


# ===========================================================================
# Paged decode attention (continuous batching)
# ===========================================================================

def paged_attention(q, k_pages, v_pages, page_table, seq_lens, *,
                    scale=None, impl: str = "auto"):
    """q: (B, Hq, 1, D); pools: (n_pages, page, Hkv, D|Dv); page_table:
    (B, maxp) int32; seq_lens: (B,) int32 valid entries per slot (the new
    token's K/V already written at ``seq_lens - 1``).  Returns
    (B, Hq, 1, Dv)."""
    if _use_kernel(impl, q):
        o = _pa.paged_attention_cuda(
            q[:, :, 0].contiguous(), k_pages, v_pages,
            page_table.to(torch.int32).contiguous(),
            seq_lens.to(torch.int32).contiguous(), scale=scale)
    else:
        o = _pa.paged_attention_torch(q[:, :, 0], k_pages, v_pages,
                                      page_table, seq_lens, scale=scale)
    return o[:, :, None]


# ===========================================================================
# RMSNorm
# ===========================================================================

def rmsnorm(x, scale, *, eps: float = 1e-6, impl: str = "auto"):
    if _use_kernel(impl, x):
        return _rn.rmsnorm_cuda(x.contiguous(), scale.contiguous(), eps)
    return _rn.rmsnorm_torch(x, scale, eps)
