"""Recurrent sequence-mixing blocks: Mamba2 (SSD), mLSTM and sLSTM
(xLSTM).  The port of ``repro.models.ssm``.

Each block exposes:
  *_init(gen, d_model, cfg, dtype, device)    -> params
  *_fwd(p, x, cfg, d_model, *, state=None)    -> (y, state)
  *_state_spec(cfg, d_model, batch[, dtype])  -> tree of (shape, dtype)

``state=None`` means full-sequence (train/prefill) mode starting from
zeros; passing a state runs from it and writes the updated one back into
it, in place (decode passes S=1).  The xLSTM states hold tuples, as the
reference's: the mLSTM's ``{"conv", "mlstm": (C, n, m)}`` and the
sLSTM's ``{"slstm": (h, c, n, m)}``; their tensors are written in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import SSMConfig, XLSTMConfig
from repro_torch.models.layers import _he
from repro_torch.sharding import ctx as shard_ctx


# ---------------------------------------------------------------------------
# causal depthwise conv (width W) with cached tail for decode
# ---------------------------------------------------------------------------

def causal_conv(x, w, tail=None):
    """x: (B, S, C); w: (W, C); tail: (B, W-1, C) previous inputs or None.

    Returns (y, new_tail).  y[t] = sum_i w[i] * x_ext[t + i] where x_ext is
    x left-padded with the tail (or zeros).
    """
    W = w.shape[0]
    B, S, C = x.shape
    if tail is None:
        tail = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    ext = torch.cat([tail.to(x.dtype), x], dim=1)        # (B, S+W-1, C)
    y = sum(ext[:, i:i + S] * w[i].to(x.dtype) for i in range(W))
    new_tail = ext[:, -(W - 1):] if W > 1 else tail
    return y, new_tail


# ===========================================================================
# Mamba2
# ===========================================================================

def _dims(cfg: SSMConfig, d_model: int):
    di = cfg.expand * d_model
    return di, di // cfg.head_dim, cfg.state_dim


def mamba2_init(gen, d_model: int, cfg: SSMConfig, dtype, device):
    di, H, N = _dims(cfg, d_model)
    conv_ch = di + 2 * N
    f32 = torch.float32
    return {
        # order: [z(di), x(di), B(N), C(N), dt(H)]
        "w_in": _he(gen, (d_model, 2 * di + 2 * N + H), dtype, device),
        "conv_w": _he(gen, (cfg.conv_width, conv_ch), dtype, device,
                      fan_in=cfg.conv_width),
        "A_log": torch.zeros((H,), dtype=f32, device=device),
        "D": torch.ones((H,), dtype=f32, device=device),
        "dt_bias": torch.zeros((H,), dtype=f32, device=device),
        "norm": torch.ones((di,), dtype=dtype, device=device),
        "w_out": _he(gen, (di, d_model), dtype, device, fan_in=di),
    }


def mamba_columns(cfg: SSMConfig, d_model: int, M: int, r: int):
    """The columns of ``w_in`` (``[z, x, B, C, dt]``) and the channels of
    ``conv_w`` and the ``conv`` state (``[x, B, C]``) that rank ``r`` of
    a model column of M computes its H / M heads with: its heads' ``z``,
    ``x`` and ``dt``, and the whole ``B`` and ``C`` (one group, needed by
    every head).  Index lists, in the whole leaf's order."""
    di, H, N = _dims(cfg, d_model)
    Hl = H // M
    h0, dl = r * Hl, Hl * cfg.head_dim
    x0 = h0 * cfg.head_dim
    z = list(range(x0, x0 + dl))
    x = [di + i for i in z]
    bc = list(range(2 * di, 2 * di + 2 * N))
    dt = list(range(2 * di + 2 * N + h0, 2 * di + 2 * N + h0 + Hl))
    return z + x + bc + dt, [i - di for i in x + bc]


def _take(w, cols):
    """The columns ``cols`` (the last dim) of a leaf a rank computes its
    heads with: a leaf ``shard_ctx.full`` exchanged comes as them
    already (``plans.TPLayout.exchange``); one the plan replicates over
    ``model`` comes whole and is cut here."""
    if w.shape[-1] == len(cols):
        return w
    return w.index_select(-1, torch.tensor(cols, device=w.device))


def mamba2_fwd(p, x, cfg: SSMConfig, d_model: int, *, state=None,
               impl: str = "auto"):
    """Under tensor parallelism over ``model`` (the context's layout
    computes "mamba"; ``plans.MAMBA_SLICED``) a
    rank computes its H / M heads: ``x`` enters the sharded region
    (``copy_in``), the rank has its columns of ``w_in`` and ``conv_w``
    (``mamba_columns``: brought as them by ``shard_ctx.full``, or cut
    from a leaf the plan replicates, ``_take``) and takes its heads'
    ``A_log``, ``D`` and ``dt_bias``, runs the conv and the scan on its
    heads (a decode state of its heads' conv channels and ``ssm`` rows),
    and
    ``w_out``'s rows are its heads'.  The gated norm is over all of
    ``d_inner``: the column's ``y`` is gathered (``gather_sum``; its
    gradient summed back), normalised whole by the ``rmsnorm`` kernel
    with the whole ``norm``, and the rank keeps its heads' share, so
    the norm's numbers are one device's.  The row-parallel ``w_out``
    product is summed over the column (``reduce_out``).  At M = 1 every
    one of these is the whole and every join a no-op."""
    B, S, _ = x.shape
    di, H, N = _dims(cfg, d_model)
    tp = shard_ctx.tp_on("mamba")
    M, r = (shard_ctx.model_size(), shard_ctx.model_rank()) if tp else (1, 0)
    Hl, dl = H // M, di // M
    w_in, conv_w = p["w_in"], p["conv_w"]
    A_log, D, dt_bias = p["A_log"], p["D"], p["dt_bias"]
    if tp:
        x = shard_ctx.copy_in(x)
    if M > 1:
        cols, chans = mamba_columns(cfg, d_model, M, r)
        w_in, conv_w = _take(w_in, cols), _take(conv_w, chans)
        heads = slice(r * Hl, (r + 1) * Hl)
        A_log, D, dt_bias = A_log[heads], D[heads], dt_bias[heads]
    zxbcdt = x @ w_in
    z = zxbcdt[..., :dl]
    xbc = zxbcdt[..., dl:dl + dl + 2 * N]
    dt = zxbcdt[..., -Hl:]

    conv_tail = None if state is None else state["conv"]
    xbc, new_tail = causal_conv(xbc, conv_w, conv_tail)
    xbc = F.silu(xbc)
    # views of the conv output (row stride dl + 2N): the kernel reads them
    # through their strides
    xs = xbc[..., :dl].reshape(B, S, Hl, cfg.head_dim)
    Bm = xbc[..., dl:dl + N]
    Cm = xbc[..., dl + N:]
    dt = F.softplus(dt.float() + dt_bias)
    A = -torch.exp(A_log)

    h0 = None if state is None else state["ssm"]
    if S == 1 and state is not None:
        y, h = ops.ssd_decode_step(xs[:, 0], dt[:, 0], A, Bm[:, 0],
                                   Cm[:, 0], D, h0)
        y = y[:, None]
    else:
        y, h = ops.ssd_scan(xs, dt, A, Bm, Cm, D, chunk=cfg.chunk,
                            h0=h0, impl=impl)
    y = y.reshape(B, S, dl)
    if M > 1:
        y = ops.rmsnorm(shard_ctx.gather_sum(y, -1), p["norm"],
                        impl=impl)[..., r * dl:(r + 1) * dl]
    else:
        y = ops.rmsnorm(y, p["norm"], impl=impl)
    out = (y * F.silu(z)) @ p["w_out"]
    if tp:
        out = shard_ctx.reduce_out(out)
    if state is None:
        return out, {"conv": new_tail, "ssm": h}
    state["conv"].copy_(new_tail)
    state["ssm"].copy_(h)
    return out, state


def mamba2_state_spec(cfg: SSMConfig, d_model: int, batch: int,
                      dtype=torch.bfloat16):
    """The decode state's shapes and dtypes.  The reference keeps the conv
    tail in bf16 whatever the model's dtype, and its prefill hands back
    one in the compute dtype; here the in-place buffer takes ``dtype``
    (the param dtype), so an fp32 model's tail is not rounded to bf16."""
    di, H, N = _dims(cfg, d_model)
    return {"conv": ((batch, cfg.conv_width - 1, di + 2 * N), dtype),
            "ssm": ((batch, H, cfg.head_dim, N), torch.float32)}


# ===========================================================================
# mLSTM block (xLSTM)
# ===========================================================================

#: the mLSTM's causal conv width (its decode state keeps the last 3 inputs)
MLSTM_CONV_WIDTH = 4


def _mlstm_dims(d_model: int, cfg: XLSTMConfig):
    inner = int(cfg.proj_factor * d_model)
    qk_total = int(cfg.qk_factor * inner)
    H = cfg.n_heads
    return inner, qk_total // H, inner // H, H   # inner, Dk, Dv, H


def mlstm_init(gen, d_model: int, cfg: XLSTMConfig, dtype, device):
    inner, Dk, Dv, H = _mlstm_dims(d_model, cfg)
    return {
        "w_up": _he(gen, (d_model, 2 * inner), dtype, device),
        "conv_w": _he(gen, (MLSTM_CONV_WIDTH, inner), dtype, device,
                      fan_in=MLSTM_CONV_WIDTH),
        "wq": _he(gen, (inner, H * Dk), dtype, device, fan_in=inner),
        "wk": _he(gen, (inner, H * Dk), dtype, device, fan_in=inner),
        "wv": _he(gen, (inner, H * Dv), dtype, device, fan_in=inner),
        "w_if": _he(gen, (inner, 2 * H), dtype, device, fan_in=inner),
        "out_norm": torch.ones((inner,), dtype=dtype, device=device),
        "w_down": _he(gen, (inner, d_model), dtype, device, fan_in=inner),
    }


def mlstm_columns(d_model: int, cfg: XLSTMConfig, M: int, r: int):
    """The columns of ``w_up`` (``[xm, z]``) and of ``w_if`` (``[i,
    f]``, each head-major) that rank ``r`` of a model column of M
    computes its H / M heads with: all of ``xm`` (every head's ``q`` and
    ``k`` read all of the conv's output, its ``v`` all of ``xm``) and
    its heads' ``z``; its heads' ``i`` and ``f``.  Index lists, in the
    whole leaf's order."""
    inner, _, Dv, H = _mlstm_dims(d_model, cfg)
    Hl = H // M
    z0 = inner + r * Hl * Dv
    up = list(range(inner)) + list(range(z0, z0 + Hl * Dv))
    heads = list(range(r * Hl, (r + 1) * Hl))
    return up, heads + [H + h for h in heads]


def mlstm_fwd(p, x, cfg: XLSTMConfig, d_model: int, *, state=None,
              impl: str = "auto"):
    """Under tensor parallelism over ``model`` (the context's layout
    computes "mlstm"; ``plans.MLSTM_SLICED``) a rank computes its H / M
    heads: ``x`` enters the sharded region (``copy_in``), the rank has
    its columns of ``w_up`` (brought as them by ``shard_ctx.full``) and
    takes its columns of the whole ``w_if`` (replicated by the plan;
    ``mlstm_columns``, ``_take``), computes ``xm`` and the conv whole (a
    decode state of the whole conv tail), and ``wq``, ``wk``, ``wv``
    (columns) and ``w_down`` (rows) are its heads'.  The scan and the decode step
    run on its heads (a decode state of its heads' ``(C, n, m)``).  The
    output norm is over all of ``inner``: the column's ``h`` is gathered
    (``gather_sum``; its gradient summed back), normalised whole by the
    ``rmsnorm`` kernel with the whole ``out_norm``, and the rank keeps
    its heads' share, gated by its own ``z``.  The row-parallel
    ``w_down`` product is summed over the column (``reduce_out``).  At
    M = 1 every one of these is the whole and every join a no-op."""
    B, S, _ = x.shape
    inner, Dk, Dv, H = _mlstm_dims(d_model, cfg)
    tp = shard_ctx.tp_on("mlstm")
    M, r = (shard_ctx.model_size(), shard_ctx.model_rank()) if tp else (1, 0)
    Hl, dl = H // M, inner // M
    w_up, w_if = p["w_up"], p["w_if"]
    if tp:
        x = shard_ctx.copy_in(x)
    if M > 1:
        up_cols, if_cols = mlstm_columns(d_model, cfg, M, r)
        w_up, w_if = _take(w_up, up_cols), _take(w_if, if_cols)
    up = x @ w_up
    xm, z = up[..., :inner], up[..., inner:]
    conv_tail = None if state is None else state["conv"]
    xc, new_tail = causal_conv(xm, p["conv_w"], conv_tail)
    xc = F.silu(xc)
    q = (xc @ p["wq"]).reshape(B, S, Hl, Dk).transpose(1, 2)
    k = (xc @ p["wk"]).reshape(B, S, Hl, Dk).transpose(1, 2)
    v = (xm @ p["wv"]).reshape(B, S, Hl, Dv).transpose(1, 2)
    gates = (xc @ w_if).reshape(B, S, 2, Hl)
    ig = gates[:, :, 0].transpose(1, 2)      # (B, H, S)
    fg = gates[:, :, 1].transpose(1, 2)

    carry = None if state is None else state["mlstm"]
    if S == 1 and state is not None:
        h, new_carry = ops.mlstm_decode_step(q[:, :, 0], k[:, :, 0],
                                             v[:, :, 0], ig[:, :, 0],
                                             fg[:, :, 0], carry)
        h = h[:, :, None]
    else:
        h, new_carry = ops.mlstm_scan(q, k, v, ig, fg, chunk=cfg.chunk,
                                      carry=carry, impl=impl)
    h = h.transpose(1, 2).reshape(B, S, dl)
    if M > 1:
        h = ops.rmsnorm(shard_ctx.gather_sum(h, -1), p["out_norm"],
                        impl=impl)[..., r * dl:(r + 1) * dl]
    else:
        h = ops.rmsnorm(h, p["out_norm"], impl=impl)
    out = (h * F.silu(z)) @ p["w_down"]
    if tp:
        out = shard_ctx.reduce_out(out)
    if state is None:
        return out, {"conv": new_tail, "mlstm": new_carry}
    state["conv"].copy_(new_tail)
    for dst, src in zip(state["mlstm"], new_carry):
        dst.copy_(src)
    return out, state


def mlstm_state_spec(cfg: XLSTMConfig, d_model: int, batch: int,
                     dtype=torch.bfloat16, split: int = 1):
    """The decode state's shapes and dtypes.  As for Mamba2's, the conv
    tail takes ``dtype`` (the param dtype), where the reference's is bf16
    whatever the model's dtype and its prefill hands back one in the
    compute dtype.  ``split``: the heads split over that many ranks of a
    model column (a rank's ``(C, n, m)`` hold its H / split heads; the
    conv tail is whole)."""
    inner, Dk, Dv, H = _mlstm_dims(d_model, cfg)
    H //= split
    f32 = torch.float32
    return {"conv": ((batch, MLSTM_CONV_WIDTH - 1, inner), dtype),
            "mlstm": (((batch, H, Dk, Dv), f32), ((batch, H, Dk), f32),
                      ((batch, H), f32))}


# ===========================================================================
# sLSTM block (xLSTM scalar memory, true recurrence)
# ===========================================================================

#: the dtype each step's h is kept in before the output norm: bf16, as the
#: reference stacks it, whatever the model's dtype
SLSTM_STACK_DTYPE = torch.bfloat16

def slstm_init(gen, d_model: int, cfg: XLSTMConfig, dtype, device):
    """The reference draws ``w_ff_gate`` and ``w_ff_up`` from one key, so
    the two start equal; here each has its own draw."""
    H = cfg.n_heads
    Dh = d_model // H
    ff = int(d_model * 4 / 3)
    return {
        "w_gates": _he(gen, (d_model, 4 * d_model), dtype, device),  # z i f o
        "r_gates": _he(gen, (H, Dh, 4 * Dh), dtype, device,
                       fan_in=Dh),                                # block-diag
        "out_norm": torch.ones((d_model,), dtype=dtype, device=device),
        "w_ff_gate": _he(gen, (d_model, ff), dtype, device),
        "w_ff_up": _he(gen, (d_model, ff), dtype, device),
        "w_ff_down": _he(gen, (ff, d_model), dtype, device, fan_in=ff),
    }


def slstm_columns(d_model: int, cfg: XLSTMConfig, M: int, r: int):
    """The columns of ``w_gates`` (``[z, i, f, o]``, each head-major)
    that rank ``r`` of a model column of M computes its H / M heads
    with: its heads' columns of each of the four gates.  An index list,
    in the whole leaf's order."""
    dl = d_model // M
    return [g * d_model + c for g in range(4)
            for c in range(r * dl, (r + 1) * dl)]


def slstm_fwd(p, x, cfg: XLSTMConfig, d_model: int, *, state=None,
              impl: str = "auto"):
    """The recurrence runs one position at a time, as the reference's
    ``lax.scan``, with the heads leading ((H, B, Dh)) so the recurrent
    product is one ``bmm`` a step.  Each step's h is kept in
    ``SLSTM_STACK_DTYPE`` (bf16, as the reference stacks it).  The
    steps' gates are ``unbind`` views, whose backward stacks the steps'
    gradients once (indexing ``gates_x[t]`` would write a zero tensor of
    every step's gates for each step).

    Under tensor parallelism over ``model`` (the context's layout
    computes "slstm"; ``plans.SLSTM_SLICED``) a rank computes its H / M
    heads: ``x`` enters the sharded region (``copy_in``), the rank has
    its heads' columns of ``w_gates`` (``slstm_columns``: brought as
    them by ``shard_ctx.full``, ``_take``) and takes its heads of
    ``r_gates``, and runs the recurrence on them (a decode
    state of its heads' ``(h, c, n, m)``) with no collective inside the
    loop: ``r_gates`` is block-diagonal by head.  The column's ``h`` is
    then joined whole (``gather_out``: what follows is computed whole
    and alike on every rank, so the join's gradient is the rank's slice
    of it) and normalised whole.  The feed-forward is a region of its
    own where the layout computes "slstm_ff" (``copy_in``, the rank's
    columns of ``w_ff_gate`` and ``w_ff_up`` and rows of ``w_ff_down``,
    ``reduce_out``), else every rank computes it whole.  At M = 1 every
    one of these is the whole and every join a no-op."""
    B, S, _ = x.shape
    tp = shard_ctx.tp_on("slstm")
    M, rk = (shard_ctx.model_size(), shard_ctx.model_rank()) if tp else (1, 0)
    H = cfg.n_heads // M
    Dh = d_model // cfg.n_heads
    f32 = torch.float32
    w_gates, r_gates = p["w_gates"], p["r_gates"]
    if tp:
        x = shard_ctx.copy_in(x)
    if M > 1:
        w_gates = _take(w_gates, slstm_columns(d_model, cfg, M, rk))
        r_gates = r_gates[rk * H:(rk + 1) * H]
    # S steps of (4, H, B, Dh) gates, each contiguous
    gates_x = (x @ w_gates).reshape(B, S, 4, H, Dh).float().permute(
        1, 2, 3, 0, 4).contiguous().unbind(0)
    if state is None:
        h = torch.zeros((H, B, Dh), dtype=f32, device=x.device)
        c = torch.zeros_like(h)
        n = torch.ones_like(h)
        m = torch.zeros_like(h)
    else:
        h, c, n, m = (t.float().transpose(0, 1) for t in state["slstm"])
    r = r_gates.float()                                 # (H, Dh, 4 Dh)
    # torch.maximum against a tensor splits the gradient at a tie, as
    # jnp.maximum does (clamp_min would give it all to |n|)
    one = torch.ones((), dtype=f32, device=x.device)
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
        hs.append(h.to(SLSTM_STACK_DTYPE))
    # (S, H, B, Dh) -> (B, S, H * Dh)
    y = torch.stack(hs).permute(2, 0, 1, 3).reshape(B, S, H * Dh).to(
        x.dtype)
    if tp:
        y = shard_ctx.gather_out(y, -1)
    y = ops.rmsnorm(y, p["out_norm"], impl=impl)
    w_gate, w_up, w_down = p["w_ff_gate"], p["w_ff_up"], p["w_ff_down"]
    ff_tp = shard_ctx.tp_on("slstm_ff")
    if ff_tp:
        y = shard_ctx.copy_in(y)
    ff = F.silu(y @ w_gate) * (y @ w_up)
    out = ff @ w_down
    if ff_tp:
        out = shard_ctx.reduce_out(out)
    new = tuple(t.transpose(0, 1) for t in (h, c, n, m))
    if state is None:
        return out, {"slstm": new}
    for dst, src in zip(state["slstm"], new):
        dst.copy_(src)
    return out, state


def slstm_state_spec(cfg: XLSTMConfig, d_model: int, batch: int,
                     split: int = 1):
    """``split``: the heads split over that many ranks of a model column
    (a rank's states hold its H / split heads)."""
    H = cfg.n_heads
    s = ((batch, H // split, d_model // H), torch.float32)
    return {"slstm": (s, s, s, s)}
