"""Shared layers: norms, RoPE, GQA attention (dense and paged), Multi-head
Latent Attention (DeepSeek-V2), MLPs.

The port of ``repro.models.layers``.  Parameters are plain nested dicts of tensors in the JAX
tree's layout: ``x @ W`` orientation ``(d_in, d_out)``.  ``*_init(gen,
...)`` builds one layer's params from an explicit ``torch.Generator``.
Matmuls run in the param dtype with fp32 softmax/norm accumulation.

Caches and page pools are updated in place (the JAX functions return new
arrays, which XLA donates); the functions still return them so call sites
read like the reference's.

Under tensor parallelism over ``model`` (``tp=True``, item 8d) the GQA
attention, MLA and the MLP get a rank's shards of their weights: the
heads a rank computes are read off ``wq`` and ``wk``'s widths (H/M query
and Hkv/M kv heads, a decode cache of those kv heads) or MLA's ``wk_b``
(H/M heads over the whole compressed cache), ``wq``/``wk``/``wv``,
MLA's ``wq_b``/``wk_b``/``wv_b`` and ``w_up``/``w_gate`` are
column-parallel after ``copy_in``, and ``wo`` and ``w_down``
row-parallel before ``reduce_out`` (``sharding.ctx``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import AttentionConfig
from repro_torch.sharding import ctx as shard_ctx


def _randn(shape, gen, device, dtype, std: float):
    """N(0, std^2) in fp32, cast to ``dtype``; on the ``meta`` device only
    the shape and dtype exist.  The scaling is in place: a large leaf's
    fp32 draw exists once (llama4's (128, 5120, 8192) expert leaves draw
    21.5 GB each)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(std).to(dtype)


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
    """q (B, H, S, D), k (B, Hkv, S, D), v (B, Hkv, S, Dv) of the heads
    ``p``'s projections hold (all of them, or a rank's share)."""
    B, S, _ = x.shape
    D, vd = a.head_dim, a.v_dim
    H, Hkv = p["wq"].shape[-1] // D, p["wk"].shape[-1] // D
    q = (x @ p["wq"]).reshape(B, S, H, D)
    k = (x @ p["wk"]).reshape(B, S, Hkv, D)
    v = (x @ p["wv"]).reshape(B, S, Hkv, vd)
    q = apply_rope(q.transpose(1, 2), positions, a.rope_theta)  # (B,H,S,D)
    k = apply_rope(k.transpose(1, 2), positions, a.rope_theta)  # (B,Hkv,S,D)
    return q, k, v.transpose(1, 2)


def attention_fwd(p, x, a: AttentionConfig, *, positions, cache=None,
                  cache_len=None, causal=None, impl: str = "auto",
                  tp: bool = False):
    """x: (B, S, d).  cache: dict(k,v: (B, Smax, Hkv, D)).

    Returns (out, cache).  In prefill mode (cache given, S>1) the K/V are
    written at positions [0, S) and the rest of the cache is zeroed; in
    decode (S==1) at position ``cache_len``, a 0-d integer tensor on the
    cache's device (written through a device index: no host sync; an int
    is taken too).  ``tp``: ``p`` holds a rank's heads (and the cache
    its kv heads), summed over the model column after ``wo``.

    Under a context whose cache is sequence-split over the data ranks
    (``ShardCtx.seq_split``) the cache holds this rank's slice of the
    positions, ``[lo, lo + Smax_local)``: every rank computes the whole
    batch, a prefill writes the prompt's positions in its slice, a
    decode step's K/V are written only by the rank whose slice holds
    ``cache_len`` (a select on the device, so a captured step holds
    for any position), and each rank attends over its slice, the
    ranks' partial results merged (``ops.merge_attention``).
    """
    B, S, _ = x.shape
    causal = a.causal if causal is None else causal
    if tp:
        x = shard_ctx.copy_in(x)
    q, k, v = _qkv(p, x, a, positions)
    H = q.shape[1]

    lo = None if cache is None else shard_ctx.seq_offset(cache["k"].shape[1])
    if cache is None:
        o = ops.flash_attention(q, k, v, causal=causal,
                                sliding_window=a.sliding_window, impl=impl)
    elif S == 1:  # decode
        cache_len = torch.as_tensor(cache_len, device=cache["k"].device)
        if lo is None:
            idx = cache_len.reshape(1).long()
            cache["k"].index_copy_(1, idx, k.transpose(1, 2).to(
                cache["k"].dtype))
            cache["v"].index_copy_(1, idx, v.transpose(1, 2).to(
                cache["v"].dtype))
            o = ops.decode_attention(
                q, cache["k"].transpose(1, 2), cache["v"].transpose(1, 2),
                cache_len + 1, sliding_window=a.sliding_window, impl=impl)
        else:
            _write_owned(cache, {"k": k.transpose(1, 2),
                                 "v": v.transpose(1, 2)}, cache_len - lo)
            o, lse = ops.decode_attention(
                q, cache["k"].transpose(1, 2), cache["v"].transpose(1, 2),
                cache_len + 1, sliding_window=a.sliding_window, offset=lo,
                partials=True, impl=impl)
            o, _ = ops.merge_attention(shard_ctx.gather_data(o),
                                       shard_ctx.gather_data(lse))
            o = o.reshape(B, H, 1, a.v_dim).to(q.dtype)
    else:  # prefill into cache
        o = ops.flash_attention(q, k, v, causal=causal,
                                sliding_window=a.sliding_window, impl=impl)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        if lo is not None:          # this rank's positions of the prompt
            Sl = cache["k"].shape[1]
            kt, vt = kt[:, lo:lo + Sl], vt[:, lo:lo + Sl]
        n = kt.shape[1]
        cache["k"][:, :n] = kt.to(cache["k"].dtype)
        cache["v"][:, :n] = vt.to(cache["v"].dtype)
        cache["k"][:, n:] = 0
        cache["v"][:, n:] = 0
    o = o.transpose(1, 2).reshape(B, S, H * a.v_dim) @ p["wo"]
    return (shard_ctx.reduce_out(o) if tp else o), cache


def _write_owned(cache, rows, local):
    """A decode step's new rows, ``rows[name]`` (B, 1, ...) for each
    cache leaf named (GQA's ``k``/``v``, MLA's ``c_kv``/``k_rope``), at
    row ``local`` (a 0-d device tensor) of a rank's slice of a
    sequence-split cache (its dim 1), where the slice holds that row; a
    rank whose slice does not writes its row back as it was (no host
    sync)."""
    for name, t in rows.items():
        c = cache[name]
        Sl = c.shape[1]
        inside = (local >= 0) & (local < Sl)
        j = local.clamp(0, Sl - 1).reshape(1).long()
        c.index_copy_(1, j, torch.where(inside, t.to(c.dtype),
                                        c.index_select(1, j)))


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
# Multi-head Latent Attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_init(gen, d_model: int, a: AttentionConfig, dtype, device):
    H, Dn, Dr, Dv = a.n_heads, a.head_dim, a.qk_rope_head_dim, a.v_dim
    return {
        "wq_a": _he(gen, (d_model, a.q_lora_rank), dtype, device),
        "q_norm": torch.ones((a.q_lora_rank,), dtype=dtype, device=device),
        "wq_b": _he(gen, (a.q_lora_rank, H * (Dn + Dr)), dtype, device),
        "wkv_a": _he(gen, (d_model, a.kv_lora_rank + Dr), dtype, device),
        "kv_norm": torch.ones((a.kv_lora_rank,), dtype=dtype,
                              device=device),
        "wk_b": _he(gen, (a.kv_lora_rank, H * Dn), dtype, device),
        "wv_b": _he(gen, (a.kv_lora_rank, H * Dv), dtype, device),
        "wo": _he(gen, (H * Dv, d_model), dtype, device, fan_in=H * Dv),
    }


def mla_fwd(p, x, a: AttentionConfig, *, positions, cache=None,
            cache_len=None, impl: str = "auto", tp: bool = False):
    """MLA forward.  cache: dict(c_kv: (B, Smax, R), k_rope: (B, Smax, Dr)),
    updated in place.

    Train and prefill materialise per-head K and V and run flash
    attention at head dim Dn + Dr (value head dim Dv); a prefill writes
    the compressed rows [0, S) and zeroes the rest.  Decode (S == 1)
    writes row ``cache_len`` (a 0-d tensor on the cache's device, written
    through a device index, or an int) and scores against the compressed
    cache with the up-projections absorbed, in fp32 einsums, as the
    reference does outside any kernel (``mla_decode_attention``).

    ``tp``: ``p`` holds a rank's heads, H/M of them, read off ``wk_b``'s
    width, of ``wq_b``, ``wk_b``, ``wv_b`` and ``wo`` (summed over the
    model column after ``wo``), and the down-projections and their norms
    whole (``plans.MLA_WHOLE``): every rank computes ``cq``, ``c_kv`` and
    ``k_rope`` whole and holds the whole compressed cache.

    Under a context whose cache is sequence-split over the data ranks
    (``ShardCtx.seq_split``) the compressed cache holds this rank's slice
    of the positions, ``[lo, lo + Smax_local)``, as in
    ``attention_fwd``: a prefill writes the prompt's rows in its slice,
    a decode step's row is written only by the rank whose slice holds
    ``cache_len``, each rank scores its slice, and the ranks' fp32
    partial results are merged (``ops.merge_attention``) before the cast
    and ``wv_b``."""
    B, S, _ = x.shape
    Dn, Dr, Dv, R = (a.head_dim, a.qk_rope_head_dim, a.v_dim,
                     a.kv_lora_rank)
    if tp:
        x = shard_ctx.copy_in(x)
    H = p["wk_b"].shape[-1] // Dn
    scale = 1.0 / math.sqrt(Dn + Dr)
    cq = ops.rmsnorm(x @ p["wq_a"], p["q_norm"], impl=impl)
    q = (cq @ p["wq_b"]).reshape(B, S, H, Dn + Dr)
    q_nope, q_rope = q[..., :Dn], q[..., Dn:]
    q_rope = apply_rope(q_rope.transpose(1, 2), positions,
                        a.rope_theta)                          # (B,H,S,Dr)

    kv_a = x @ p["wkv_a"]
    # a strided view: the kernel reads its rows in place
    c_kv = ops.rmsnorm(kv_a[..., :R], p["kv_norm"], impl=impl)  # (B,S,R)
    k_rope = apply_rope(kv_a[..., None, R:].transpose(1, 2), positions,
                        a.rope_theta)                          # (B,1,S,Dr)

    lo = None if cache is None else shard_ctx.seq_offset(
        cache["c_kv"].shape[1])
    if cache is not None and S == 1:
        # ---- absorbed decode: score against the compressed cache ----
        c_cache, r_cache = cache["c_kv"], cache["k_rope"]
        cache_len = torch.as_tensor(cache_len, device=c_cache.device)
        if lo is None:
            idx = cache_len.reshape(1).long()
            c_cache.index_copy_(1, idx, c_kv.to(c_cache.dtype))
            r_cache.index_copy_(1, idx, k_rope[:, 0].to(r_cache.dtype))
        else:
            _write_owned(cache, {"c_kv": c_kv, "k_rope": k_rope[:, 0]},
                         cache_len - lo)
        wk_b = p["wk_b"].reshape(R, H, Dn)
        q_abs = torch.einsum("bshd,rhd->bhsr", q_nope, wk_b)   # (B,H,1,R)
        if lo is None:
            o_c = mla_decode_attention(q_abs, q_rope, c_cache, r_cache,
                                       cache_len + 1, scale)
        else:
            o_c, lse = mla_decode_attention(
                q_abs, q_rope, c_cache, r_cache, cache_len + 1, scale,
                offset=lo, partials=True)
            o_c, _ = ops.merge_attention(shard_ctx.gather_data(o_c),
                                         shard_ctx.gather_data(lse))
        wv_b = p["wv_b"].reshape(R, H, Dv)
        o = torch.einsum("bhsr,rhd->bshd", o_c.to(x.dtype), wv_b)
    else:
        # ---- train / prefill: materialize per-head K, V ----
        k_nope = (c_kv @ p["wk_b"]).reshape(B, S, H, Dn).transpose(1, 2)
        v = (c_kv @ p["wv_b"]).reshape(B, S, H, Dv).transpose(1, 2)
        k = torch.cat([k_nope, k_rope.expand(B, H, S, Dr)], dim=-1)
        qq = torch.cat([q_nope.transpose(1, 2), q_rope], dim=-1)
        o = ops.flash_attention(qq, k, v, causal=True, scale=scale,
                                impl=impl)
        o = o.transpose(1, 2)
        if cache is not None:
            ck, kr = c_kv, k_rope[:, 0]
            if lo is not None:      # this rank's positions of the prompt
                Sl = cache["c_kv"].shape[1]
                ck, kr = ck[:, lo:lo + Sl], kr[:, lo:lo + Sl]
            n = ck.shape[1]
            cache["c_kv"][:, :n] = ck.to(cache["c_kv"].dtype)
            cache["k_rope"][:, :n] = kr.to(cache["k_rope"].dtype)
            cache["c_kv"][:, n:] = 0
            cache["k_rope"][:, n:] = 0
    out = o.reshape(B, S, H * Dv) @ p["wo"]
    return (shard_ctx.reduce_out(out) if tp else out), cache


def mla_decode_attention(q_abs, q_rope, c_cache, r_cache, cache_len,
                         scale: float, offset=None, partials: bool = False):
    """The absorbed decode's attention over MLA's compressed cache, in
    fp32, the reference's einsums: q_abs (B, H, 1, R), the query with
    ``wk_b`` absorbed, and q_rope (B, H, 1, Dr) scored against c_cache
    (B, Smax, R) and r_cache (B, Smax, Dr), the positions from
    ``cache_len`` on masked (a 0-d tensor or an int), softmax, and the
    weights applied to c_cache: o_c (B, H, 1, R), normalised.
    ``offset``: the cache holds the positions from ``offset`` on (a
    rank's slice of a sequence-split cache).  ``partials``: also the
    scores' log-sum-exp (B, H, 1), for ``ops.merge_attention`` over the
    ranks that hold the other slices."""
    s = (torch.einsum("bhsr,btr->bhst", q_abs.float(), c_cache.float())
         + torch.einsum("bhsd,btd->bhst", q_rope.float(),
                        r_cache.float())) * scale
    pos = torch.arange(c_cache.shape[1], device=c_cache.device)
    if offset is not None:
        pos = pos + offset
    s = torch.where(pos < cache_len, s, ops.NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_c = torch.einsum("bhst,btr->bhsr", w, c_cache.float())
    if partials:
        return o_c, torch.logsumexp(s, dim=-1)
    return o_c


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


def mlp_fwd(p, x, act: str, gated: bool, tp: bool = False):
    """``tp``: ``p`` holds a rank's share of the width, summed over the
    model column after ``w_down``."""
    if tp:
        x = shard_ctx.copy_in(x)
    h = x @ p["w_up"]
    if gated:
        g = x @ p["w_gate"]
        g = F.silu(g) if act == "silu" else _gelu(g)
        h = g * h
    else:
        h = _gelu(h) if act == "gelu" else F.silu(h)
    out = h @ p["w_down"]
    return shard_ctx.reduce_out(out) if tp else out
