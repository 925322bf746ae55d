"""Kernel entry points used by the model stack and the optimizer (the
port of ``repro.kernels.ops`` for the serve and train paths).

Each op with a kernel has two implementations:
  * ``kernel`` — the hand-written CUDA kernel (``flash_attention.py``,
                 ``paged_attention.py``, ``rmsnorm.py``, ``fused_adamw.py``,
                 ``ssd_scan.py``, ``slstm.py`` and ``csrc/``);
  * ``torch``  — its plain PyTorch version, beside the kernel.

``impl="auto"`` mirrors ``repro.kernels.ops._use_pallas``: the kernel for a
CUDA tensor, the plain version for a CPU tensor.  ``impl="kernel"`` on a
CPU tensor raises.  ``impl="torch"`` is the plain version on any device;
the tests and ``chip_smoke.py`` compare against it.  ``decode_attention``,
``ssd_decode_step``, ``mlstm_scan`` and ``mlstm_decode_step`` never had a
TPU kernel and are plain PyTorch only (``decode_attention`` in chunks of
positions, merged as a sequence-split cache's ranks merge theirs).

Gradients: ``flash_attention`` is a ``torch.autograd.Function`` whose
backward is the flash backward (the counterpart of the custom VJP
``_flash_bwd_rule``): its kernel for CUDA tensors, its plain version for
CPU tensors or ``impl="torch"``.  ``rmsnorm`` is one for CUDA tensors, with
the backward kernel; its plain version is differentiated by autograd.
``ssd_scan`` is one for CUDA tensors, whose backward is the SSD backward
kernel (the counterpart of autodiff of ``ops._ssd_jnp``); its plain
version is differentiated by autograd.  ``slstm_scan`` (the sLSTM
recurrence, which the reference runs as a ``lax.scan`` and not a TPU
kernel) is one for CUDA tensors, whose backward is the sLSTM backward
kernel; its plain loop is differentiated by autograd.  A call that needs
no gradient runs the forward alone.

Fake tensors (``torch._subclasses.fake_tensor``, the dry run's,
``launch.dryrun``): a kernel's call on them is counted as the kernel
computes it and never launched nor replaced by its plain version (the
plain flash attention's S x S scores would put into a dry run's peak a
matrix the kernel never holds).  Its FLOPs and bytes, by the formulas of
``PERF.md``'s bound column (every input read once, every output written
once), add to ``FAKE_COST``; only its outputs are allocated.  A real CPU
tensor still takes the plain version, a CUDA tensor the kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_adamw as _fo
from repro_torch.kernels import paged_attention as _pa
from repro_torch.train import quantized_state as qs
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import slstm as _sl
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
    kw = dict(causal=causal, sliding_window=sliding_window, scale=scale,
              q_offset=q_offset)
    if _is_fake(q):
        return _FakeFlash.apply(q, k, v, kw, _needs_grad(q, k, v))
    use = _use_kernel(impl, q)
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

#: positions of a dense decode cache scored at a time (``decode_attention``)
DECODE_CHUNK = 32768


def decode_attention(q, k_cache, v_cache, cache_len, *, scale=None,
                     sliding_window: int = 0, offset=0,
                     chunk: int = DECODE_CHUNK, partials: bool = False):
    """q: (B, Hq, 1, D); caches: (B, Hkv, Smax, D|Dv).  Attends over the
    first ``cache_len`` entries (the new token's K/V already written at
    ``cache_len - 1``); ``cache_len`` an int or a 0-d tensor on q's
    device (the mask is a comparison, so no host sync).

    The cache is scored ``chunk`` positions at a time, each chunk's
    softmax taken whole in fp32 as the reference's, and the chunks'
    partial results merged (``merge_attention``): a chunk's K and V are
    upcast alone, so a long cache's fp32 temporaries stay a chunk's.
    With one chunk the result is the whole softmax's bit for bit.  Every
    position is scored and masked, as the reference's: a captured step
    reads ``cache_len`` on the device, so the chunks past it cannot be
    skipped.  ``offset``: the cache holds the positions from ``offset``
    on (a rank's slice of a sequence-split cache; an int or a 0-d
    tensor).  ``partials``: return the (o, lse) ``merge_attention``
    takes, o (B, Hkv, G, Dv) and lse (B, Hkv, G) in fp32, for the merge
    over the ranks that hold the other slices."""
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


# ===========================================================================
# Paged decode attention (continuous batching)
# ===========================================================================

def paged_attention(q, k_pages, v_pages, page_table, seq_lens, *,
                    scale=None, impl: str = "auto"):
    """q: (B, Hq, 1, D); pools: (n_pages, page, Hkv, D|Dv); page_table:
    (B, maxp) int32; seq_lens: (B,) int32 valid entries per slot (the new
    token's K/V already written at ``seq_lens - 1``).  Returns
    (B, Hq, 1, Dv)."""
    if _is_fake(q):
        return _fake_paged(q, k_pages, v_pages, page_table)
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
    if _is_fake(x):
        return _FakeRMSNorm.apply(x, scale)
    if _use_kernel(impl, x):
        scale = scale.contiguous()
        if _needs_grad(x, scale):
            # the backward kernel reads contiguous rows: the x saved is
            # the contiguous one it reads
            return _RMSNorm.apply(x.contiguous(), scale, eps)
        # the kernel reads rows at a stride: a slice of wider rows goes
        # as it is, and only rows at no one stride are copied
        if _rn.row_stride(x) is None:
            x = x.contiguous()
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
    if _is_fake(p):
        _fake_adamw(p, g, m)
        return p, m, v
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

class _SSDScan(torch.autograd.Function):
    """(y, h_final) = the SSD scan kernel; saves only its inputs, and the
    backward kernel recomputes the rest (under ``torch.utils.checkpoint``
    the forward runs twice and the backward once).  The final state's
    cotangent may be None (training discards the state)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, D, h0)
        ctx.chunk = chunk
        return _ssd.ssd_scan_cuda(x, dt, A, B, C, D, chunk=chunk, h0=h0)

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, A, B, C, D, h0 = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dh_final is not None:
            dh_final = dh_final.contiguous()
        grads = _ssd.ssd_scan_bwd_cuda(x, dt, A, B, C, D, dy, dh_final,
                                       chunk=ctx.chunk, h0=h0)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,)


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 256, h0=None,
             impl: str = "auto"):
    """Chunked state-space-dual scan.  Shapes as in ``ref.ssd_scan``: x
    (Bt, S, H, P); dt (Bt, S, H); A, D (H,); B, C (Bt, S, N); h0 (Bt, H, P,
    N) or None.  Returns (y in x's dtype, the fp32 final state)."""
    if _is_fake(x):
        return _FakeSSDScan.apply(x, dt, A, B, C, D, h0, chunk)
    if not _use_kernel(impl, x):
        return _ssd.ssd_scan_torch(x, dt, A, B, C, D, chunk=chunk, h0=h0)
    dt, A, D = (t.float().contiguous() for t in (dt, A, D))
    if h0 is not None:
        h0 = h0.float().contiguous()
    if _needs_grad(x, dt, A, B, C, D, *([] if h0 is None else [h0])):
        return _SSDScan.apply(x, dt, A, B, C, D, h0, chunk)
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


# ===========================================================================
# sLSTM recurrence (xLSTM scalar memory)
# ===========================================================================

class _SLSTMScan(torch.autograd.Function):
    """(hs, h, c, n, m) = the sLSTM forward kernel; saves the gates of
    every step and the states around it (``slstm.slstm_saved_torch``'s
    layout, fp32), from which the backward kernel recomputes each step
    (under ``torch.utils.checkpoint`` the forward runs twice, saving only
    in the recompute).  The final state's cotangents may be None
    (training discards the state)."""

    @staticmethod
    def forward(ctx, gates_x, r, h0, c0, n0, m0, stack_dtype):
        ctx.set_materialize_grads(False)
        state = None if h0 is None else (h0, c0, n0, m0)
        hs, fin, saved = _sl.slstm_scan_cuda(gates_x, r, state,
                                             stack_dtype=stack_dtype,
                                             save=True)
        ctx.save_for_backward(r, *saved)
        ctx.dtype = gates_x.dtype
        return (hs, *fin)

    @staticmethod
    def backward(ctx, dhs, dh, dc, dn, dm):
        r, G, states = ctx.saved_tensors
        if dhs is None:
            B, H, Dh = G.shape[2], G.shape[0], G.shape[3] // 4
            dhs = torch.zeros((B, G.shape[1], H, Dh), dtype=torch.float32,
                              device=G.device)
        dgx, dr, d0 = _sl.slstm_scan_bwd_cuda(r, (G, states), dhs,
                                              (dh, dc, dn, dm),
                                              dtype=ctx.dtype)
        need = ctx.needs_input_grad
        return (dgx if need[0] else None,
                dr.to(r.dtype) if need[1] else None,
                *(d if n else None for d, n in zip(d0, need[2:6])), None)


def slstm_scan(gates_x, r, state, *, stack_dtype, impl: str = "auto"):
    """The sLSTM recurrence over a sequence.  gates_x (B, S, 4, H, Dh),
    ``x @ w_gates`` viewed by gate [z, i, f, o] and head; r (H, Dh, 4 Dh)
    (``r_gates``, any float dtype); state (h, c, n, m), each (B, H, Dh),
    or None (zeros, n = 1).  Returns (hs (B, S, H, Dh) in
    ``stack_dtype``, the fp32 final (h, c, n, m), each (B, H, Dh))."""
    if _is_fake(gates_x):
        hs, *fin = _FakeSLSTMScan.apply(
            gates_x, r, *(state or (None,) * 4), stack_dtype,
            _needs_grad(gates_x, r, *(state or ())))
        return hs, tuple(fin)
    if not _use_kernel(impl, gates_x):
        return _sl.slstm_scan_torch(gates_x, r, state,
                                    stack_dtype=stack_dtype)
    r = r.contiguous()
    if state is not None:
        state = tuple(t.float().contiguous() for t in state)
    if _needs_grad(gates_x, r, *(state or ())):
        hs, *fin = _SLSTMScan.apply(gates_x, r, *(state or (None,) * 4),
                                    stack_dtype)
        return hs, tuple(fin)
    hs, fin, _ = _sl.slstm_scan_cuda(gates_x, r, state,
                                     stack_dtype=stack_dtype)
    return hs, fin


# ===========================================================================
# mLSTM chunked scan (xLSTM matrix memory)
# ===========================================================================

def mlstm_scan(q, k, v, i_gate, f_gate, *, chunk: int = 256, carry=None,
               impl: str = "auto"):
    """Chunkwise-parallel stabilized mLSTM.  Shapes as in
    ``ref.mlstm_scan``; ``carry`` is (C, n, m) or None (zeros, m = -inf).

    Returns (h in q's dtype, the fp32 (C, n, m)).  Matches the sequential
    reference (the same running-max stabilizer).  The reference has no
    TPU kernel for it (a single ``jnp`` implementation), so neither does
    the port: ``impl`` is taken for the other ops' signature and
    ignored."""
    del impl
    return _mlstm_scan_body(q, k, v, i_gate, f_gate, chunk=chunk,
                            carry=carry)


def _mlstm_scan_body(q, k, v, i_gate, f_gate, *, chunk, carry):
    B, H, S, Dk = q.shape
    Dv = v.shape[-1]
    scale = 1.0 / math.sqrt(Dk)
    Q = min(chunk, S)
    Sp = -(-S // Q) * Q
    pad = Sp - S
    f32, dev = torch.float32, q.device

    def pad_s(t):
        return F.pad(t.float(), (0, 0, 0, pad))

    qf, kf, vf = pad_s(q), pad_s(k), pad_s(v)
    # padded positions write nothing (i = NEG_INF) and decay nothing
    # (f = 80: log f ~ 0), so the running max and the carry pass through
    igf = F.pad(i_gate.float(), (0, pad), value=NEG_INF)
    fgf = F.pad(f_gate.float(), (0, pad), value=80.0)

    if carry is None:
        C = torch.zeros((B, H, Dk, Dv), dtype=f32, device=dev)
        n = torch.zeros((B, H, Dk), dtype=f32, device=dev)
        m = torch.full((B, H), float("-inf"), dtype=f32, device=dev)
    else:
        C, n, m = (c.float() for c in carry)

    tri = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    # the chunks as ``split`` views: their backward concatenates the
    # chunks' gradients once (a slice's writes a zero tensor of the whole
    # sequence for each chunk)
    chunks = zip(*(t.split(Q, dim=2) for t in (qf, kf, vf, igf, fgf)))
    hs = []
    for q_c, k_c, v_c, i_c, f_c in chunks:               # gates (B, H, Q)
        logf = F.logsigmoid(f_c)
        G = torch.cumsum(logf, dim=-1)     # local cumulative log forget
        # D_local[t, j] = G_t - G_j + i_j for j <= t
        d_loc = G[..., :, None] - G[..., None, :] + i_c[..., None, :]
        d_loc = torch.where(tri, d_loc, float("-inf"))
        # running max m_t = max(m_prev + G_t, max_{j<=t} d_loc[t, j]): row
        # t already holds every j <= t with its decay, so the row max is
        # the whole local running max (a cummax over rows would mix in
        # stale, undecayed values).  torch.maximum and amax split the
        # gradient at ties as jnp.maximum and jnp.max do.
        m_t = torch.maximum(m[..., None] + G, d_loc.amax(dim=-1))
        # intra-chunk scores
        s = torch.einsum("bhqd,bhjd->bhqj", q_c, k_c) * scale
        w = torch.where(tri, torch.exp(d_loc - m_t[..., None]), 0.0)
        sw = s * w
        num_i = sw @ v_c
        den_i = sw.sum(-1)
        # inter-chunk: decay from the carry
        inter_w = torch.exp(m[..., None] + G - m_t)            # (B, H, Q)
        num_x = (q_c @ C) * scale * inter_w[..., None]
        den_x = torch.einsum("bhk,bhqk->bhq", n, q_c) * scale * inter_w
        den = torch.maximum(torch.abs(den_i + den_x), torch.exp(-m_t))
        hs.append((num_i + num_x) / den[..., None])
        # carry update at the chunk's end, with m_end
        m_end = m_t[..., -1]
        cw = torch.exp(G[..., -1:] - G + i_c - m_end[..., None])  # (B,H,Q)
        decay = torch.exp(m + G[..., -1] - m_end)
        C = (C * decay[..., None, None]
             + (k_c * cw[..., None]).transpose(-1, -2) @ v_c)
        n = n * decay[..., None] + torch.einsum("bhq,bhqk->bhk", cw, k_c)
        m = m_end
    h = torch.cat(hs, dim=2)[:, :, :S]
    return h.to(q.dtype), (C, n, m)


def mlstm_decode_step(q, k, v, i_gate, f_gate, carry):
    """Single-token mLSTM update.  q, k: (B, H, Dk); v: (B, H, Dv); gates:
    (B, H); carry (C, n, m).  Returns (h in q's dtype, the new fp32
    carry)."""
    C, n, m = carry
    scale = 1.0 / math.sqrt(q.shape[-1])
    ig = i_gate.float()
    logf = F.logsigmoid(f_gate.float())
    m_new = torch.maximum(logf + m, ig)
    fg = torch.exp(logf + m - m_new)
    ig = torch.exp(ig - m_new)
    kf, vf, qf = k.float(), v.float(), q.float()
    C = (C * fg[..., None, None]
         + ig[..., None, None] * (kf[..., :, None] * vf[..., None, :]))
    n = n * fg[..., None] + ig[..., None] * kf
    num = torch.einsum("bhkv,bhk->bhv", C, qf) * scale
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qf)) * scale,
                        torch.exp(-m_new))
    return (num / den[..., None]).to(q.dtype), (C, n, m_new)


# ===========================================================================
# Fake tensors: the kernels' costs, nothing launched
# ===========================================================================

#: the kernels' calls on fake tensors: their FLOPs and bytes (the bound
#: column's formulas) and calls by kernel; the dry run resets and reads it
FAKE_COST = {"flops": 0.0, "bytes": 0.0, "calls": {}}


def reset_fake_cost() -> None:
    FAKE_COST.update(flops=0.0, bytes=0.0, calls={})


def _is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


def _cost(name: str, flops: float, nbytes: float) -> None:
    FAKE_COST["flops"] += flops
    FAKE_COST["bytes"] += nbytes
    FAKE_COST["calls"][name] = FAKE_COST["calls"].get(name, 0) + 1


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def attention_pairs(B: int, H: int, Sq: int, Sk: int, *, causal: bool,
                    sliding_window: int = 0, q_offset: int = 0) -> int:
    """(query, key) pairs an attention computes: for query i at position
    ``q_offset + i`` the keys the mask keeps (``flash_attention._mask``),
    every pair without a mask."""
    import numpy as np
    pos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(pos + 1, Sk) if causal else np.full(Sq, Sk)
    lo = (np.maximum(pos - sliding_window + 1, 0) if sliding_window > 0
          else np.zeros(Sq, np.int64))
    return B * H * int(np.clip(hi - lo, 0, None).sum())


class _FakeFlash(torch.autograd.Function):
    """The flash kernels on fake tensors: forward 2 (D + Dv) FLOPs a
    pair, q, k, v read and o (and the fp32 lse kept for the backward)
    written; backward 2 (3 D + 2 Dv) a pair, q, k, v, o, do and lse read
    and dq, dk, dv written."""

    @staticmethod
    def forward(ctx, q, k, v, kw, grad):
        B, Hq, Sq, D = q.shape
        Dv = v.shape[-1]
        pairs = attention_pairs(B, Hq, Sq, k.shape[2], causal=kw["causal"],
                                sliding_window=kw["sliding_window"],
                                q_offset=kw["q_offset"])
        o = q.new_empty((B, Hq, Sq, Dv))
        lse = q.new_empty((B, Hq, Sq), dtype=torch.float32) if grad else None
        _cost("flash_attention", pairs * 2 * (D + Dv),
              _nbytes(q, k, v, o, lse))
        ctx.pairs = pairs
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        D, Dv = q.shape[-1], v.shape[-1]
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        _cost("flash_attention_bwd", ctx.pairs * 2 * (3 * D + 2 * Dv),
              _nbytes(q, k, v, o, do, lse, dq, dk, dv))
        return dq, dk, dv, None, None


class _FakeRMSNorm(torch.autograd.Function):
    """RMSNorm on fake tensors: forward 4 FLOPs an element, x and the
    scale read and y written; backward 10, x, the scale and g read and dx
    and dscale written."""

    @staticmethod
    def forward(ctx, x, scale):
        y = torch.empty_like(x)
        _cost("rmsnorm", 4 * x.numel(), _nbytes(x, scale, y))
        ctx.save_for_backward(x, scale)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, ds = torch.empty_like(x), torch.empty_like(scale)
        _cost("rmsnorm_bwd", 10 * x.numel(), _nbytes(x, scale, g, dx, ds))
        return dx, ds


def _ssd_chunks(S: int, chunk: int):
    Q = min(chunk, S)
    return [Q] * (S // Q) + ([S % Q] if S % Q else [])


class _FakeSSDScan(torch.autograd.Function):
    """The SSD scan on fake tensors: the chunked form's operations over
    the chunks of this sequence (C.B^T and the weighted sum per head, the
    inter-chunk product and the state update; backward, the causal
    triangle's two products and five (P, N) products of a chunk per
    head, C.B^T and two products with dCB per chunk), every input read
    once and every output written once."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0, chunk):
        Bt, S, H, P = x.shape
        N = B.shape[-1]
        y = torch.empty_like(x)
        h = x.new_empty((Bt, H, P, N), dtype=torch.float32)
        flops = Bt * H * sum(q * (q + 1) * (N + P) + 4 * q * N * P
                             for q in _ssd_chunks(S, chunk))
        _cost("ssd_scan", flops, _nbytes(x, dt, A, B, C, D, h0, y, h))
        ctx.save_for_backward(x, dt, A, B, C, D, h0)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, B, C, D, h0 = ctx.saved_tensors
        Bt, S, H, P = x.shape
        N = B.shape[-1]
        grads = tuple(None if t is None else torch.empty_like(t)
                      for t in (x, dt, A, B, C, D, h0))
        flops = Bt * sum(H * (2 * q * (q + 1) * P + 10 * q * P * N)
                         + 3 * q * (q + 1) * N
                         for q in _ssd_chunks(S, ctx.chunk))
        _cost("ssd_scan_bwd", flops,
              _nbytes(x, dt, A, B, C, D, h0, dy, dh, *grads))
        return grads + (None,)


def slstm_flops(B: int, S: int, H: int, Dh: int) -> int:
    """The sLSTM forward's recurrent products: h_{t-1} (1, Dh) by R (Dh,
    4 Dh) for every (row, head, step), 2 FLOPs a multiply-add (the cell's
    elementwise work, ~30 FLOPs a dim against 8 Dh, left out)."""
    return 2 * S * B * H * Dh * 4 * Dh


class _FakeSLSTMScan(torch.autograd.Function):
    """The sLSTM kernels on fake tensors: forward ``slstm_flops``, the
    gates, r and the state read, hs and the final state written (and,
    with a gradient, the fp32 gates and states saved); backward twice
    that, dg R^T in the kernel and dR = sum_t h^T dg after it (the
    kernel does not redo the forward's product: it reads the saved
    gates), the saved tensors, dhs, r and the final state's cotangents
    read and the cotangents written."""

    @staticmethod
    def forward(ctx, gates_x, r, h0, c0, n0, m0, stack_dtype, grad):
        B, S, _, H, Dh = gates_x.shape
        f32 = dict(dtype=torch.float32)
        hs = gates_x.new_empty((B, S, H, Dh), dtype=stack_dtype)
        fin = [gates_x.new_empty((B, H, Dh), **f32) for _ in range(4)]
        saved = (4 * S * B * H * Dh + 4 * (S + 1) * B * H * Dh) * 4 \
            if grad else 0
        _cost("slstm_scan", slstm_flops(B, S, H, Dh),
              _nbytes(gates_x, r, h0, c0, n0, m0, hs, *fin) + saved)
        ctx.save_for_backward(gates_x, r, h0)
        ctx.saved_bytes = saved
        return (hs, *fin)

    @staticmethod
    def backward(ctx, dhs, dh, dc, dn, dm):
        gates_x, r, h0 = ctx.saved_tensors
        B, S, _, H, Dh = gates_x.shape
        dgx, dr = torch.empty_like(gates_x), torch.empty_like(r)
        d0 = [None if h0 is None else torch.empty_like(h0)
              for _ in range(4)]
        _cost("slstm_scan_bwd", 2 * slstm_flops(B, S, H, Dh),
              ctx.saved_bytes + _nbytes(dhs, r, dh, dc, dn, dm, dgx, dr,
                                        *d0))
        return (dgx, dr, *d0, None, None)


def _fake_adamw(p, g, m) -> None:
    """The fused AdamW on fake tensors: 20 FLOPs an element; p read and
    written, g read, the moments read and written (fp32, or int8 codes
    and one fp32 scale a 256-block each)."""
    n = p.numel()
    if isinstance(m, dict):
        mom = 2 * (2 * n + 2 * _nbytes(m["s"]))
    else:
        mom = 2 * 2 * _nbytes(m)
    _cost("fused_adamw", 20 * n, 2 * _nbytes(p) + _nbytes(g) + mom)


def _fake_paged(q, k_pages, v_pages, page_table):
    """Paged decode on fake tensors: the most the page table can hold
    (a fake tensor carries no lengths), every slot's pages of K and V
    read once, q read and o written."""
    B, Hq, _, D = q.shape
    page, Hkv = k_pages.shape[1], k_pages.shape[2]
    Dv = v_pages.shape[-1]
    keys = B * page_table.shape[1] * page
    o = q.new_empty((B, Hq, 1, Dv))
    _cost("paged_attention", keys * Hq * 2 * (D + Dv),
          _nbytes(q, o, page_table) + keys * Hkv * (D + Dv)
          * k_pages.element_size())
    return o
