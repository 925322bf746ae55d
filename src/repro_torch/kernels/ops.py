"""Kernel entry points used by the model stack and the optimizer (the
port of ``repro.kernels.ops`` for the serve and train paths).

Each op with a kernel has two implementations:
  * ``kernel`` — the hand-written CUDA kernel (``flash_attention.py``,
                 ``paged_attention.py``, ``rmsnorm.py``, ``fused_adamw.py``,
                 ``ssd_scan.py`` and ``csrc/``);
  * ``torch``  — its plain PyTorch version, beside the kernel.

``impl="auto"`` mirrors ``repro.kernels.ops._use_pallas``: the kernel for a
CUDA tensor, the plain version for a CPU tensor.  ``impl="kernel"`` on a
CPU tensor raises.  ``impl="torch"`` is the plain version on any device;
the tests and ``chip_smoke.py`` compare against it.  ``decode_attention``
and ``ssd_decode_step`` never had a TPU kernel and are plain PyTorch only.

Gradients: ``flash_attention`` is a ``torch.autograd.Function`` whose
backward is the flash backward (the counterpart of the custom VJP
``_flash_bwd_rule``): its kernel for CUDA tensors, its plain version for
CPU tensors or ``impl="torch"``.  ``rmsnorm`` is one for CUDA tensors, with
the backward kernel; its plain version is differentiated by autograd.  A
call that needs no gradient runs the forward alone.  ``ssd_scan`` has no
backward kernel yet: its kernel refuses a call that needs a gradient (the
plain version is differentiated by autograd).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_adamw as _fo
from repro_torch.kernels import paged_attention as _pa
from repro_torch.train import quantized_state as qs
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd

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

class _FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v); saves (q, k, v, o, lse) for the flash
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, kw, use_kernel):
        fwd = (_fa.flash_attention_cuda if use_kernel
               else _fa.flash_attention_torch)
        o, lse = fwd(q, k, v, with_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw, ctx.use_kernel = kw, use_kernel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = (_fa.flash_attention_bwd_cuda if ctx.use_kernel
               else _fa.flash_attention_bwd_torch)
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                    scale: Optional[float] = None, q_offset: int = 0,
                    impl: str = "auto"):
    """q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv)."""
    use = _use_kernel(impl, q)
    kw = dict(causal=causal, sliding_window=sliding_window, scale=scale,
              q_offset=q_offset)
    if use:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, kw, use)
    if use:
        return _fa.flash_attention_cuda(q, k, v, **kw)
    return _fa.flash_attention_torch(q, k, v, **kw)


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

class _RMSNorm(torch.autograd.Function):
    """The forward and backward kernels (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rn.rmsnorm_cuda(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, ds = _rn.rmsnorm_bwd_cuda(x, scale, g.contiguous(), ctx.eps)
        return dx, ds, None


def rmsnorm(x, scale, *, eps: float = 1e-6, impl: str = "auto"):
    if _use_kernel(impl, x):
        x, scale = x.contiguous(), scale.contiguous()
        if _needs_grad(x, scale):
            return _RMSNorm.apply(x, scale, eps)
        return _rn.rmsnorm_cuda(x, scale, eps)
    return _rn.rmsnorm_torch(x, scale, eps)


# ===========================================================================
# Fused AdamW optimizer update (one pass per leaf)
# ===========================================================================

def fused_adamw(p, g, m, v, *, lr, scale, bc1, bc2, b1, b2, eps,
                weight_decay, apply_wd: Optional[bool] = None,
                impl: str = "auto"):
    """One leaf's AdamW update, IN PLACE on p and the moments (fp32
    tensors or ``quantized_state`` {"q", "s"} dicts); returns (p, m, v),
    the same objects.  ``lr``, ``scale``, ``bc1``, ``bc2`` are 0-d fp32
    tensors on p's device (or Python floats); ``apply_wd`` defaults to
    ``p.ndim >= 2`` (decay matrices only), as in the reference.  The
    kernel reads the four scalars from device memory; the plain version
    computes new tensors and copies them in."""
    if apply_wd is None:
        apply_wd = p.ndim >= 2
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              apply_wd=apply_wd)
    if _use_kernel(impl, p):
        scalars = torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                               device=p.device).reshape(())
                               for x in (lr, scale, bc1, bc2)])
        return _fo.fused_adamw_cuda(p, g, m, v, scalars, **kw)
    new_p, new_m, new_v = _fo.fused_adamw_torch(p, g, m, v, lr=lr,
                                                scale=scale, bc1=bc1,
                                                bc2=bc2, **kw)
    with torch.no_grad():
        for dst, src in ((p, new_p), (m, new_m), (v, new_v)):
            qs.copy_(dst, src)
    return p, m, v


# ===========================================================================
# Mamba2 SSD chunked scan
# ===========================================================================

def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 256, h0=None,
             impl: str = "auto"):
    """Chunked state-space-dual scan.  Shapes as in ``ref.ssd_scan``: x
    (Bt, S, H, P); dt (Bt, S, H); A, D (H,); B, C (Bt, S, N); h0 (Bt, H, P,
    N) or None.  Returns (y in x's dtype, the fp32 final state)."""
    if not _use_kernel(impl, x):
        return _ssd.ssd_scan_torch(x, dt, A, B, C, D, chunk=chunk, h0=h0)
    if _needs_grad(x, dt, A, B, C, D, *([] if h0 is None else [h0])):
        raise NotImplementedError(
            "ssd_scan has no backward kernel yet (the counterpart of "
            "autodiff of repro.kernels.ops._ssd_jnp): the CUDA scan serves "
            "forward passes only")
    dt, A, D = (t.float().contiguous() for t in (dt, A, D))
    if h0 is not None:
        h0 = h0.float().contiguous()
    return _ssd.ssd_scan_cuda(x, dt, A, B, C, D, chunk=chunk, h0=h0)


def ssd_decode_step(x, dt, A, B, C, D, h):
    """Single-token Mamba2 update.  x: (Bt, H, P); dt: (Bt, H); B, C:
    (Bt, N); h: (Bt, H, P, N).  Returns (y in x's dtype, the new fp32
    state)."""
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(dtf * A[None])
    h = h * decay[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dtf, B.float(), xf)
    y = (torch.einsum("bn,bhpn->bhp", C.float(), h)
         + xf * D[None, :, None])
    return y.to(x.dtype), h
