"""The sLSTM recurrence: the CUDA kernels (``csrc/slstm.cu``) and their
plain versions.

The reference runs the recurrence as a ``jax.lax.scan``
(``repro.models.ssm.slstm_fwd``'s ``step``), which XLA compiles into one
loop on the device; there is no TPU kernel.  ``slstm_scan_cuda`` is that
loop as one kernel launch a layer, ``slstm_scan_bwd_cuda`` its backward
(the counterpart of autodiff of the scan), one launch in reverse time and
one batched product for the recurrent weights' cotangent.

``slstm_scan_torch`` is the port's loop of one position at a time, as it
stood in ``models/ssm.py``: the heads leading ((H, B, Dh)) so the
recurrent product is one ``bmm`` a step, the steps' gates ``unbind``
views (their backward stacks the steps' gradients once), and each step's
h kept in ``stack_dtype``.  It runs on CPU tensors, where autograd
differentiates it, and is the forward kernel's yardstick on the card.
``slstm_scan_bwd_torch`` is the backward kernel's arithmetic in plain
PyTorch, a reverse-time loop of the same hand-derived formulas.

Shapes: ``gates_x`` (B, S, 4, H, Dh), ``x @ w_gates`` viewed by gate [z, i,
f, o] and head, bf16 or fp32 (the kernel reads it through its strides,
each head's Dh values contiguous); ``r`` (H, Dh, 4 Dh), the heads'
recurrent weights; ``state`` (h, c, n, m), each (B, H, Dh) fp32, or None
for h = c = m = 0, n = 1.  Both directions return hs (B, S, H, Dh) in
``stack_dtype`` and the fp32 final state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: forward and backward kernel launches so far (a run resets them to 0
#: and reads them afterwards)
LAUNCHES = 0
BWD_LAUNCHES = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the head widths the kernels are built for (xlstm_350m's): a cluster of
#: 8 CTAs a (row, head), each owning Dh / 8 dims and Dh / 2 values of R in
#: registers
HEAD_DIMS = (256,)


def slstm_scan_torch(gates_x, r, state=None, *,
                     stack_dtype=torch.bfloat16, _record=None):
    """The recurrence one position at a time.  ``_record``: a list that
    receives, step by step, (g, (h, c, n, m)) of the step (its gates
    before the cell and the state after it), for
    ``slstm_saved_torch``."""
    B, S, _, H, Dh = gates_x.shape
    f32 = torch.float32
    # S steps of (4, H, B, Dh) gates, each contiguous
    gates_x = gates_x.float().permute(1, 2, 3, 0, 4).contiguous().unbind(0)
    if state is None:
        h = torch.zeros((H, B, Dh), dtype=f32, device=r.device)
        c = torch.zeros_like(h)
        n = torch.ones_like(h)
        m = torch.zeros_like(h)
    else:
        h, c, n, m = (t.float().transpose(0, 1) for t in state)
    r = r.float()                                       # (H, Dh, 4 Dh)
    # torch.maximum against a tensor splits the gradient at a tie, as
    # jnp.maximum does (clamp_min would give it all to |n|)
    one = torch.ones((), dtype=f32, device=r.device)
    hs = []
    for gx in gates_x:
        rec = torch.bmm(h, r).view(H, B, 4, Dh).permute(2, 0, 1, 3)
        g = gx + rec                                    # (4, H, B, Dh)
        z_t = torch.tanh(g[0])
        i_t = g[1]
        o_t = torch.sigmoid(g[3])
        logf_m = F.logsigmoid(g[2]) + m
        m_new = torch.maximum(logf_m, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(logf_m - m_new)
        c = f_p * c + i_p * z_t
        n = f_p * n + i_p
        h = o_t * c / torch.maximum(torch.abs(n), one)
        m = m_new
        hs.append(h.to(stack_dtype))
        if _record is not None:
            _record.append((g, (h, c, n, m)))
    # (S, H, B, Dh) -> (B, S, H, Dh)
    return (torch.stack(hs).permute(2, 0, 1, 3),
            tuple(t.transpose(0, 1) for t in (h, c, n, m)))


def slstm_saved_torch(gates_x, r, state=None):
    """What the forward kernel saves for the backward, from the plain
    loop: the gates of every step, (H, S, B, 4 Dh) fp32, and the state
    before and after every step, (4, H, S + 1, B, Dh) fp32 ([h, c, n, m];
    slot t the state before step t)."""
    B, S, _, H, Dh = gates_x.shape
    rec = []
    with torch.no_grad():
        slstm_scan_torch(gates_x, r, state, _record=rec)
    f32 = dict(dtype=torch.float32, device=r.device)
    if state is None:
        zero = torch.zeros((H, B, Dh), **f32)
        first = (zero, zero, torch.ones_like(zero), zero)
    else:
        first = tuple(t.float().transpose(0, 1) for t in state)
    G = torch.stack([g.permute(1, 2, 0, 3).reshape(H, B, 4 * Dh)
                     for g, _ in rec], 1)
    states = torch.stack([torch.stack(s) for s in
                          [first] + [st for _, st in rec]], 2)
    return G, states


def _logsigmoid_bwd(x, grad):
    """ATen's gradient of logsigmoid: grad * sigmoid(-x), in its form."""
    neg = x < 0
    e = torch.exp(-x.abs())
    return grad * (neg.float() - torch.where(neg, 1.0, -1.0) * (e / (1 + e)))


def _maximum_bwd(a, b, grad):
    """torch.maximum's (and jnp.maximum's) gradient: all to the larger,
    half to each at a tie."""
    half = grad * 0.5
    return (torch.where(a > b, grad, torch.where(a < b, 0.0, half)),
            torch.where(a < b, grad, torch.where(a > b, 0.0, half)))


def slstm_scan_bwd_torch(gates_x, r, state, dhs, dfinal=None, *,
                         saved=None):
    """The backward in plain PyTorch: the cotangents of ``gates_x`` (its
    shape and dtype), of ``r`` ((H, Dh, 4 Dh) fp32) and of the initial
    state ((dh, dc, dn, dm), each (B, H, Dh) fp32) for the cotangents
    ``dhs`` of hs ((B, S, H, Dh)) and ``dfinal`` of the final state (a
    tuple of four, each None for zero, or None).  ``saved``: the forward
    kernel's saved gates and states (``slstm_saved_torch``'s layout);
    None recomputes them with the plain loop.

    In reverse time, from each step's gates g and the state before it,
    the step is recomputed and, with h = (o c) / D, D = max(|n|, 1):
    q = dh / D, dD = -dh (h / D), do = q c, dc += q o; D's gradient to
    |n| where |n| > 1 (half at a tie), times sign(n); c = f' c_prev + i'
    z and n = f' n_prev + i' give df', di', dz and dc_prev, dn_prev;
    f' = exp(a - m) and i' = exp(g_i - m) give their exponents' and m's
    (m's with the carried dm); m = max(a, g_i) splits it (half at a
    tie); a = logsigmoid(g_f) + m_prev gives dg_f and dm_prev; dg_o =
    do (1 - o) o, dg_z = dz (1 - z^2).  Then dh_prev = dg R^T, and
    dR = sum_t h_{t-1}^T dg_t as one product at the end."""
    B, S, _, H, Dh = gates_x.shape
    if saved is None:
        saved = slstm_saved_torch(gates_x, r, state)
    G, st = saved
    rf = r.float()
    dhs = dhs.float().permute(2, 1, 0, 3)               # (H, S, B, Dh)
    zero = torch.zeros((H, B, Dh), dtype=torch.float32, device=r.device)
    dfinal = dfinal or (None,) * 4
    dh, dc, dn, dm = (zero if d is None else d.float().transpose(0, 1)
                      for d in dfinal)
    dG = torch.empty_like(G)
    for t in reversed(range(S)):
        g0, g1, g2, g3 = G[:, t].view(H, B, 4, Dh).unbind(2)
        c_p, n_p, m_p = st[1, :, t], st[2, :, t], st[3, :, t]
        z = torch.tanh(g0)
        o = torch.sigmoid(g3)
        a = F.logsigmoid(g2) + m_p
        mn = torch.maximum(a, g1)
        ip = torch.exp(g1 - mn)
        fp = torch.exp(a - mn)
        c = fp * c_p + ip * z
        n = fp * n_p + ip
        an = n.abs()
        den = torch.clamp_min(an, 1.0)
        h = o * c / den
        gh = dh + dhs[:, t]
        qd = gh / den
        dden = -gh * (h / den)
        d_o = qd * c
        gc = dc + qd * o
        dabs, _ = _maximum_bwd(an, torch.ones_like(an), dden)
        gn = dn + dabs * torch.sign(n)
        dfp = gc * c_p + gn * n_p
        dip = gc * z + gn
        dz = gc * ip
        dc, dn = gc * fp, gn * fp
        ef, ei = dfp * fp, dip * ip
        dmn = (dm - ei) - ef
        da_m, di_m = _maximum_bwd(a, g1, dmn)
        da = da_m + ef
        dg = torch.stack([dz * (1 - z * z), di_m + ei,
                          _logsigmoid_bwd(g2, da), (d_o * (1 - o)) * o], 2)
        dm = da
        dg = dg.reshape(H, B, 4 * Dh)
        dG[:, t] = dg
        dh = torch.bmm(dg, rf.transpose(1, 2))
    dr = torch.bmm(st[0, :, :S].reshape(H, S * B, Dh).transpose(1, 2),
                   dG.reshape(H, S * B, 4 * Dh))
    dgx = dG.view(H, S, B, 4, Dh).permute(2, 1, 3, 0, 4).to(gates_x.dtype)
    return dgx, dr, tuple(t.transpose(0, 1) for t in (dh, dc, dn, dm))


def _check(what, cond, msg):
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _dims(what, B, S, H, Dh, r):
    _check(what, Dh in HEAD_DIMS,
           f"head dim {Dh} not in {HEAD_DIMS} (the kernels' instances)")
    _check(what, B >= 1 and S >= 1 and H >= 1,
           f"B, S and H must be positive, got {(B, S, H)}")
    _check(what, tuple(r.shape) == (H, Dh, 4 * Dh)
           and r.dtype in DTYPE_CODES and r.is_contiguous(),
           f"r must be contiguous bf16/f32 {(H, Dh, 4 * Dh)}, got "
           f"{tuple(r.shape)} {r.dtype}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def slstm_scan_cuda(gates_x, r, state=None, *, stack_dtype=torch.bfloat16,
                    save: bool = False):
    """The forward kernel: ``slstm_scan_torch``'s results, all on one
    CUDA device, r contiguous in bf16 or fp32 (the kernel reads it once,
    into fp32).  ``save``: also return what the backward kernel needs,
    (G, states) in ``slstm_saved_torch``'s layout (else None)."""
    global LAUNCHES
    what = "slstm_scan_cuda"
    _check(what, gates_x.ndim == 5 and gates_x.shape[2] == 4,
           f"gates_x must be (B, S, 4, H, Dh), got {tuple(gates_x.shape)}")
    B, S, _, H, Dh = gates_x.shape
    _dims(what, B, S, H, Dh, r)
    _check(what, gates_x.dtype in DTYPE_CODES
           and stack_dtype in DTYPE_CODES,
           f"takes bf16/f32 gates and stack dtype, got {gates_x.dtype}, "
           f"{stack_dtype}")
    _check(what, gates_x.stride(-1) == 1,
           f"each head's values must be contiguous, strides "
           f"{gates_x.stride()}")
    st = [] if state is None else list(state)
    _check(what, gates_x.is_cuda and all(
        t.device == gates_x.device for t in [r] + st),
        "needs every tensor on one CUDA device")
    _check(what, all(tuple(t.shape) == (B, H, Dh) and t.dtype == torch.float32
                     and t.is_contiguous() for t in st),
           f"the state must be four contiguous fp32 {(B, H, Dh)}")
    dev = gates_x.device
    f32 = dict(dtype=torch.float32, device=dev)
    hs = torch.empty((B, S, H, Dh), dtype=stack_dtype, device=dev)
    fin = [torch.empty((B, H, Dh), **f32) for _ in range(4)]
    saved = ((torch.empty((H, S, B, 4 * Dh), **f32),
              torch.empty((4, H, S + 1, B, Dh), **f32)) if save else None)
    sb, s_t, sg, sh, _ = gates_x.stride()
    h0, c0, n0, m0 = (_ptr(t) for t in (st or [None] * 4))
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.slstm_fwd_launch(
            gates_x.data_ptr(), sb, s_t, sg, sh, r.data_ptr(),
            DTYPE_CODES[r.dtype], h0, c0, n0, m0, hs.data_ptr(),
            *(t.data_ptr() for t in fin),
            *((None, None) if saved is None
              else (t.data_ptr() for t in saved)),
            B, S, H, Dh, DTYPE_CODES[gates_x.dtype],
            DTYPE_CODES[stack_dtype], stream)
    _build.check(err, "slstm_fwd_launch")
    LAUNCHES += 1
    return hs, tuple(fin), saved


def slstm_scan_bwd_cuda(r, saved, dhs, dfinal=None, *, dtype):
    """The backward kernel, then dR as one ``bmm``: the cotangents of
    gates_x ((B, S, 4, H, Dh), contiguous, in ``dtype``, the gates'), of
    r ((H, Dh, 4 Dh) fp32, whatever r's dtype) and of the initial state
    ((dh, dc, dn, dm),
    each (B, H, Dh) fp32), from the forward kernel's ``saved``, the
    cotangent ``dhs`` of hs ((B, S, H, Dh) in the stack dtype) and
    ``dfinal``, the final state's (four, each None for zero)."""
    global BWD_LAUNCHES
    what = "slstm_scan_bwd_cuda"
    _check(what, dhs.ndim == 4, f"dhs must be (B, S, H, Dh), got "
           f"{tuple(dhs.shape)}")
    B, S, H, Dh = dhs.shape
    _dims(what, B, S, H, Dh, r)
    G, states = saved
    _check(what, dtype in DTYPE_CODES and dhs.dtype in DTYPE_CODES,
           f"takes bf16/f32 gates and stack dtype, got {dtype}, "
           f"{dhs.dtype}")
    _check(what, tuple(G.shape) == (H, S, B, 4 * Dh)
           and tuple(states.shape) == (4, H, S + 1, B, Dh)
           and G.is_contiguous() and states.is_contiguous(),
           "saved must be the forward kernel's (G, states)")
    dfinal = list(dfinal or (None,) * 4)
    dev = dhs.device
    _check(what, dhs.is_cuda and all(
        t.device == dev for t in [r, G, states] + [d for d in dfinal
                                                    if d is not None]),
        "needs every tensor on one CUDA device")
    dfinal = [None if d is None else d.float().contiguous() for d in dfinal]
    _check(what, all(d is None or tuple(d.shape) == (B, H, Dh)
                     for d in dfinal),
           f"the final state's cotangents must be {(B, H, Dh)}")
    dhs = dhs.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dgx = torch.empty((B, S, 4, H, Dh), dtype=dtype, device=dev)
    dG = torch.empty((H, S, B, 4 * Dh), **f32)
    d0 = [torch.empty((B, H, Dh), **f32) for _ in range(4)]
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.slstm_bwd_launch(
            r.data_ptr(), DTYPE_CODES[r.dtype], G.data_ptr(),
            states.data_ptr(), dhs.data_ptr(),
            *(_ptr(d) for d in dfinal), dgx.data_ptr(), dG.data_ptr(),
            *(t.data_ptr() for t in d0), B, S, H, Dh, DTYPE_CODES[dtype],
            DTYPE_CODES[dhs.dtype], stream)
    _build.check(err, "slstm_bwd_launch")
    BWD_LAUNCHES += 1
    # dR = sum over steps and rows of h_{t-1}^T dg_t
    dr = torch.bmm(states[0, :, :S].reshape(H, S * B, Dh).transpose(1, 2),
                   dG.view(H, S * B, 4 * Dh))
    return dgx, dr, tuple(d0)
