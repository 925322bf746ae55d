"""Shared layers: norms, RoPE, GQA attention (dense and paged), MLPs.

The port of ``repro.models.layers`` for the dense family (MLA waits for a
later slice).  Parameters are plain nested dicts of tensors in the JAX
tree's layout: ``x @ W`` orientation ``(d_in, d_out)``.  ``*_init(gen,
...)`` builds one layer's params from an explicit ``torch.Generator``.
Matmuls run in the param dtype with fp32 softmax/norm accumulation.

Caches and page pools are updated in place (the JAX functions return new
arrays, which XLA donates); the functions still return them so call sites
read like the reference's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import AttentionConfig


def _randn(shape, gen, device, dtype, std: float):
    """N(0, std^2) in fp32, cast to ``dtype``; on the ``meta`` device only
    the shape and dtype exist."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * std).to(dtype)


def _he(gen, shape, dtype, device, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    return _randn(shape, gen, device, dtype, 1.0 / math.sqrt(fan_in))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_init(d: int, kind: str, dtype, device):
    if kind == "layer":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def apply_norm(p, x, kind: str, eps: float = 1e-6, impl: str = "auto"):
    if kind == "layer":
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    return ops.rmsnorm(x, p["scale"], eps=eps, impl=impl)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float):
    """x: (..., S, D) with D even; positions: (S,) or (B, S).  Rotates the
    interleaved pairs (x[..., ::2], x[..., 1::2])."""
    D = x.shape[-1]
    inv = rope_freqs(D, theta, x.device)                     # (D/2,)
    ang = positions.to(x.device)[..., None].float() * inv    # (..., S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    # broadcast (S, D/2) or (B, S, D/2) against (..., S, D/2)
    while cos.ndim < x.ndim:
        cos, sin = cos[..., None, :, :], sin[..., None, :, :]
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_init(gen, d_model: int, a: AttentionConfig, dtype, device):
    vd = a.v_dim
    return {
        "wq": _he(gen, (d_model, a.n_heads * a.head_dim), dtype, device),
        "wk": _he(gen, (d_model, a.n_kv_heads * a.head_dim), dtype, device),
        "wv": _he(gen, (d_model, a.n_kv_heads * vd), dtype, device),
        "wo": _he(gen, (a.n_heads * vd, d_model), dtype, device,
                  fan_in=a.n_heads * vd),
    }


def _qkv(p, x, a: AttentionConfig, positions):
    B, S, _ = x.shape
    H, Hkv, D, vd = a.n_heads, a.n_kv_heads, a.head_dim, a.v_dim
    q = (x @ p["wq"]).reshape(B, S, H, D)
    k = (x @ p["wk"]).reshape(B, S, Hkv, D)
    v = (x @ p["wv"]).reshape(B, S, Hkv, vd)
    q = apply_rope(q.transpose(1, 2), positions, a.rope_theta)  # (B,H,S,D)
    k = apply_rope(k.transpose(1, 2), positions, a.rope_theta)  # (B,Hkv,S,D)
    return q, k, v.transpose(1, 2)


def attention_fwd(p, x, a: AttentionConfig, *, positions, cache=None,
                  cache_len=None, causal=None, impl: str = "auto"):
    """x: (B, S, d).  cache: dict(k,v: (B, Smax, Hkv, D)).

    Returns (out, cache).  In prefill mode (cache given, S>1) the K/V are
    written at positions [0, S) and the rest of the cache is zeroed; in
    decode (S==1) at position ``cache_len`` (a Python int).
    """
    B, S, _ = x.shape
    H, vd = a.n_heads, a.v_dim
    causal = a.causal if causal is None else causal
    q, k, v = _qkv(p, x, a, positions)

    if cache is None:
        o = ops.flash_attention(q, k, v, causal=causal,
                                sliding_window=a.sliding_window, impl=impl)
    elif S == 1:  # decode
        idx = int(cache_len)
        cache["k"][:, idx] = k[:, :, 0].to(cache["k"].dtype)
        cache["v"][:, idx] = v[:, :, 0].to(cache["v"].dtype)
        o = ops.decode_attention(
            q, cache["k"].transpose(1, 2), cache["v"].transpose(1, 2),
            idx + 1, sliding_window=a.sliding_window)
    else:  # prefill into cache
        o = ops.flash_attention(q, k, v, causal=causal,
                                sliding_window=a.sliding_window, impl=impl)
        cache["k"][:, :S] = k.transpose(1, 2).to(cache["k"].dtype)
        cache["v"][:, :S] = v.transpose(1, 2).to(cache["v"].dtype)
        cache["k"][:, S:] = 0
        cache["v"][:, S:] = 0
    o = o.transpose(1, 2).reshape(B, S, H * vd)
    return o @ p["wo"], cache


def paged_attention_fwd(p, x, a: AttentionConfig, *, pages, page_table,
                        seq_lens, impl: str = "auto"):
    """Decode one token per slot against a paged KV pool (continuous
    batching).  x: (B, 1, d); pages: dict(k/v: (n_pages, page, Hkv, D|Dv));
    page_table: (B, maxp) int32; seq_lens: (B,) int32 — tokens already
    cached per slot.  The new token's K/V is written at position
    ``seq_lens[b]`` (its page must already be allocated in the table), then
    the slot attends over ``seq_lens + 1`` entries.  Returns (out, pages)."""
    B, S, _ = x.shape
    H, Hkv, D, vd = a.n_heads, a.n_kv_heads, a.head_dim, a.v_dim
    q, k, v = _qkv(p, x, a, seq_lens[:, None])

    page = pages["k"].shape[1]
    # flat pool row of each slot's write position; inactive slots (their
    # table rows all point at the reserved trash page 0) scatter harmlessly
    sl = seq_lens.long()
    row = (page_table[torch.arange(B, device=sl.device), sl // page].long()
           * page + sl % page)
    pages["k"].view(-1, Hkv, D)[row] = k[:, :, 0].to(pages["k"].dtype)
    pages["v"].view(-1, Hkv, vd)[row] = v[:, :, 0].to(pages["v"].dtype)
    o = ops.paged_attention(q, pages["k"], pages["v"], page_table,
                            seq_lens + 1, impl=impl)
    o = o.transpose(1, 2).reshape(B, S, H * vd)
    return o @ p["wo"], pages


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model: int, d_ff: int, gated: bool, dtype, device):
    p = {"w_up": _he(gen, (d_model, d_ff), dtype, device),
         "w_down": _he(gen, (d_ff, d_model), dtype, device, fan_in=d_ff)}
    if gated:
        p["w_gate"] = _he(gen, (d_model, d_ff), dtype, device)
    return p


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp_fwd(p, x, act: str, gated: bool):
    h = x @ p["w_up"]
    if gated:
        g = x @ p["w_gate"]
        g = F.silu(g) if act == "silu" else _gelu(g)
        h = g * h
    else:
        h = _gelu(h) if act == "gelu" else F.silu(h)
    return h @ p["w_down"]
