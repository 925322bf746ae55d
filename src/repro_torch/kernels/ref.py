"""Naive oracles for the tests (the port's counterpart of
``repro.kernels.ref``'s ``attention`` and ``rmsnorm``): O(S^2) memory,
numerically straightforward, fully masked rows give NaN as in the
reference."""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
              scale: Optional[float] = None, q_offset: int = 0):
    """q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if sliding_window > 0:
        mask &= (q_pos - k_pos) < sliding_window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, -1).to(q.dtype)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)
