"""Recurrent sequence-mixing blocks: Mamba2 (SSD).  The port of
``repro.models.ssm`` for the hybrid family (mLSTM and sLSTM come with the
xLSTM family).

The block exposes:
  mamba2_init(gen, d_model, cfg, dtype, device) -> params
  mamba2_fwd(p, x, cfg, d_model, *, state=None) -> (y, state)
  mamba2_state_spec(cfg, d_model, batch, dtype) -> {name: (shape, dtype)}

``state=None`` means full-sequence (train/prefill) mode starting from
zeros; passing a state runs from it and writes the updated one back into
it, in place (decode passes S=1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import SSMConfig
from repro_torch.models.layers import _he


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


def mamba2_fwd(p, x, cfg: SSMConfig, d_model: int, *, state=None,
               impl: str = "auto"):
    B, S, _ = x.shape
    di, H, N = _dims(cfg, d_model)
    zxbcdt = x @ p["w_in"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * N]
    dt = zxbcdt[..., -H:]

    conv_tail = None if state is None else state["conv"]
    xbc, new_tail = causal_conv(xbc, p["conv_w"], conv_tail)
    xbc = F.silu(xbc)
    # views of the conv output (row stride di + 2N): the kernel reads them
    # through their strides
    xs = xbc[..., :di].reshape(B, S, H, cfg.head_dim)
    Bm = xbc[..., di:di + N]
    Cm = xbc[..., di + N:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    h0 = None if state is None else state["ssm"]
    if S == 1 and state is not None:
        y, h = ops.ssd_decode_step(xs[:, 0], dt[:, 0], A, Bm[:, 0],
                                   Cm[:, 0], p["D"], h0)
        y = y[:, None]
    else:
        y, h = ops.ssd_scan(xs, dt, A, Bm, Cm, p["D"], chunk=cfg.chunk,
                            h0=h0, impl=impl)
    y = y.reshape(B, S, di)
    y = ops.rmsnorm(y, p["norm"], impl=impl) * F.silu(z)
    out = y @ p["w_out"]
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
