"""Flash attention: the CUDA kernels (``csrc/flash_attention.cu`` forward,
``csrc/flash_attention_bwd.cu`` backward) and their plain versions.

``flash_attention_cuda`` replaces the Pallas kernel
``repro.kernels.flash_attention``.  ``flash_attention_torch`` computes the
same function in plain PyTorch: the masked online softmax of
``repro.kernels.ops._flash_fwd_impl`` taken in one kv chunk, with fully
masked rows giving 0 (l = 0 is divided by 1).  With ``with_lse=True`` both
also return the row log-sum-exp ``m + log(l_safe)`` (fp32, (B, Hq, Sq))
that the backward recomputes the probabilities from.

``flash_attention_bwd_cuda`` and ``flash_attention_bwd_torch`` are the
counterparts of the custom VJP ``repro.kernels.ops._flash_bwd_rule``:
``(q, k, v, o, lse, do) -> (dq, dk, dv)``.  One difference: the rule
multiplies ``exp(s - lse)`` by the mask, which is NaN on a fully masked row
(lse = -1e30 overflows the exponential); here such a row gets zero
gradient.

On the card, bf16 runs on the tensor cores (``wgmma``, K/V or Q/dO tiles
streamed by TMA through a two-stage ring, the backward's dq in its own
pass without atomics, so that dq, dk and dv are reproducible bit for bit)
and f32 on the CUDA cores; the sources' header notes say how.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

#: forward and backward kernel launches so far (a run resets them to 0 and
#: reads them afterwards)
LAUNCHES = 0
BWD_LAUNCHES = 0

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
                          q_offset: int = 0, with_lse: bool = False):
    """q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv).
    Returns o, or (o, lse) with ``with_lse``."""
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
    o = o.reshape(B, Hq, Sq, Dv).to(q.dtype)
    if not with_lse:
        return o
    lse = (m + torch.log(l))[..., 0].reshape(B, Hq, Sq)
    return o, lse


def flash_attention_bwd_torch(q, k, v, o, lse, do, *, causal: bool = True,
                              sliding_window: int = 0,
                              scale: Optional[float] = None,
                              q_offset: int = 0):
    """The plain backward, ``_flash_bwd_rule`` in one kv chunk: delta =
    rowsum(o * do); p = exp(s - lse) where the mask allows, else 0;
    dv = p^T do; ds = p (do v^T - delta) scale; dq = ds k; dk = ds^T q;
    GQA sums each group into its kv head.  Returns (dq, dk, dv) in the
    inputs' dtypes."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, Dv = v.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, Hkv, G, Sq, D)
    og = o.float().reshape(B, Hkv, G, Sq, Dv)
    dog = do.float().reshape(B, Hkv, G, Sq, Dv)
    kf, vf = k.float(), v.float()
    delta = (og * dog).sum(-1)                               # (B,Hkv,G,Sq)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * scale
    mask = _mask(Sq, Sk, causal, sliding_window, q_offset, q.device)
    lse_g = lse.float().reshape(B, Hkv, G, Sq, 1)
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg)
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check(name, q, k, v):
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    Dv = v.shape[3]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name} needs q, k, v on one CUDA device")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes bf16/f32 q, k, v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if (Bk != B or Dk != D or v.shape[:3] != (B, Hkv, Sk) or Hkv < 1
            or Hq % Hkv):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    if not (1 <= D <= MAX_HEAD_DIM and 1 <= Dv <= MAX_HEAD_DIM):
        raise ValueError(f"{name}: head dims {D}, {Dv} must be in "
                         f"[1, {MAX_HEAD_DIM}]")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} needs contiguous q, k, v")
    return B, Hq, Hkv, Sq, Sk, D, Dv


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         sliding_window: int = 0,
                         scale: Optional[float] = None,
                         q_offset: int = 0, with_lse: bool = False):
    """The kernel: same arguments and result as ``flash_attention_torch``;
    q, k, v contiguous, bf16 or f32, on one CUDA device, head dims <= 128."""
    global LAUNCHES
    B, Hq, Hkv, Sq, Sk, D, Dv = _check("flash_attention_cuda", q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lib = _build.load()
    o = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
            Dv, float(scale), int(bool(causal)), int(sliding_window),
            int(q_offset), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention_launch")
    LAUNCHES += 1
    return (o, lse) if with_lse else o


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             sliding_window: int = 0,
                             scale: Optional[float] = None,
                             q_offset: int = 0):
    """The backward kernel: same arguments and result as
    ``flash_attention_bwd_torch``.  o and do contiguous (B, Hq, Sq, Dv) of
    q's dtype, lse contiguous fp32 (B, Hq, Sq), all on q's device."""
    global BWD_LAUNCHES
    B, Hq, Hkv, Sq, Sk, D, Dv = _check("flash_attention_bwd_cuda", q, k, v)
    for name, t, shape, dtype in (("o", o, (B, Hq, Sq, Dv), q.dtype),
                                  ("do", do, (B, Hq, Sq, Dv), q.dtype),
                                  ("lse", lse, (B, Hq, Sq), torch.float32)):
        if (t.device != q.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd_cuda: {name} must be a "
                             f"contiguous {dtype} {shape} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lib = _build.load()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            B, Hq, Hkv, Sq, Sk, D, Dv, float(scale), int(bool(causal)),
            int(sliding_window), int(q_offset), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention_bwd_launch")
    BWD_LAUNCHES += 1
    return dq, dk, dv
