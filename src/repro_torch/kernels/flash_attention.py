"""Flash attention forward: the CUDA kernel (``csrc/flash_attention.cu``)
and its plain version.

``flash_attention_cuda`` replaces the Pallas kernel
``repro.kernels.flash_attention``.  ``flash_attention_torch`` computes the
same function in plain PyTorch: the masked online softmax of
``repro.kernels.ops._flash_fwd_impl`` taken in one kv chunk, with fully
masked rows giving 0 (l = 0 is divided by 1).  Forward only: serving needs
no gradient.
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


def _mask(Sq: int, Sk: int, causal: bool, window: int, q_offset: int,
          device) -> torch.Tensor:
    q_pos = q_offset + torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    return mask


def flash_attention_torch(q, k, v, *, causal: bool = True,
                          sliding_window: int = 0,
                          scale: Optional[float] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv)."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, Dv = v.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    mask = _mask(Sq, Sk, causal, sliding_window, q_offset, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / l
    return o.reshape(B, Hq, Sq, Dv).to(q.dtype)


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         sliding_window: int = 0,
                         scale: Optional[float] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """The kernel: same arguments and result as ``flash_attention_torch``;
    q, k, v contiguous, bf16 or f32, on one CUDA device, head dims <= 128."""
    global LAUNCHES
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    _, _, _, Dv = v.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA "
                         "device")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda takes bf16/f32 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (Bk != B or Dk != D or v.shape[:3] != (B, Hkv, Sk) or Hkv < 1
            or Hq % Hkv):
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if not (1 <= D <= MAX_HEAD_DIM and 1 <= Dv <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention_cuda: head dims {D}, {Dv} must "
                         f"be in [1, {MAX_HEAD_DIM}]")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda needs contiguous q, k, v")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lib = _build.load()
    o = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq,
            Hkv, Sq, Sk, D, Dv, float(scale), int(bool(causal)),
            int(sliding_window), int(q_offset), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention_launch")
    LAUNCHES += 1
    return o
