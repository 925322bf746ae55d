"""Stack assembly for every architecture family (the port of
``repro.models.transformer``).

The stack is a repeated *group* of sublayers with every parameter leaf
stacked ``(n_groups, ...)``, as in the JAX tree, so params move across
leaf for leaf:

  dense / vlm : group = [attn + mlp]
  encoder     : group = [attn + mlp], attention without the causal mask
                and no cache (hubert: LayerNorm, a plain GELU MLP)
  moe         : group = [attn + moe] when ``d_ff == 0`` (deepseek-v2, MLA
                attention), or [attn + mlp, attn + moe] (llama4-maverick:
                dense and MoE layers alternating; the tree's
                ``{"dense", "moe"}`` halves, and the cache's)
  xlstm       : group = [mLSTM x (k-1), sLSTM x 1]  (xlstm_350m; the
                mLSTM leaves are stacked ``(n_groups, k-1, ...)``, the
                sLSTM's ``(n_groups, ...)``; no attention and no KV cache:
                the cache holds the recurrent states, the reference's
                tuples among them)
  hybrid      : group = [mamba2 x m, shared-attn + mlp]  (zamba2; the
                mamba leaves are stacked ``(n_groups, m, ...)``, the
                attention block's params live once in ``params["extra"]``
                and are applied by every group, each with its own KV
                cache)

The frontends are the reference's stubs: ``"patch"`` (the VLM) projects
precomputed image patches with ``patch_proj`` and puts them in front of
the token embeddings; ``"frame"`` (the encoder) projects precomputed
audio frames with ``frame_proj``, puts ``mask_embed`` at the masked
frames, and has no embedding table.

Where the reference scans the groups (and a group's Mamba2 or mLSTM
sublayers) with ``lax.scan``, ``forward`` loops over them in Python.
Each stacked param leaf is ``torch.unbind`` once per forward, so under
autograd its backward stacks the group gradients once (indexing
``leaf[g]`` per group would write a zero tensor the size of the whole
stack for every group).
With ``cfg.remat == "full"`` and gradients on, each group runs under
``torch.utils.checkpoint`` and is recomputed in the backward, as the
reference wraps its scan body in ``jax.checkpoint``.  ``Transformer`` is
the ``nn.Module`` that owns one model's parameters on one device.

Under a block of several devices the param leaves are DTensors, each
rank holding its shards (``sharding.plans``).  ``forward`` unbinds each
stacked leaf's local shard once, and each group gathers its leaves
(``shard_ctx.full``) inside the checkpointed group function, so remat's
recompute gathers them again and nothing gathered outlives the group:
ZeRO-3, the gradients reduce-scattered back onto the shards.  The
embedding, the head, the final norm and the frontends' leaves are
gathered at their use, the hybrid's shared block in every group.  Under
tensor and expert parallelism (item 8d; the context's
``plans.TPLayout``) the leaves it computes sharded are gathered over the
data axes only: each rank runs its heads, MLP widths and experts, looks
up its rows of the vocabulary (``embed_inputs``: ids outside them give
zero rows, summed over the model column) and gives the logits of its
vocabulary, (B, S, V/M), which the loss reads as they are and the serve
paths gather whole (``vocab_whole``); a dense decode cache holds the
rank's kv heads (``init_cache``'s ``kv_split``).  The hybrid's Mamba2
sublayers compute the rank's heads (``ssm.mamba2_fwd``; its decode
state the rank's ``ssm`` heads and ``conv`` channels, ``mamba_split``,
``ssm.mamba_columns``), its shared block by the attention's and MLP's
rules.  MLA computes the rank's heads over the whole compressed cache
(``layers.mla_fwd``).  The xLSTM's mLSTM and sLSTM sublayers compute
the rank's heads (``ssm.mlstm_fwd``, ``ssm.slstm_fwd``; its decode
states the rank's heads, ``xlstm_split``).  A B = 1 serve cache, GQA's or MLA's, may hold a
slice of the positions on each data rank (``seq_split``;
``layers.attention_fwd``, ``layers.mla_fwd``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_randn, apply_norm, attention_fwd,
                                       attention_init, mla_fwd, mla_init,
                                       mlp_fwd, mlp_init, norm_init,
                                       paged_attention_fwd, _he)
from repro_torch.models.moe import moe_fwd, moe_init
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding.ctx import full

PORTED_FAMILIES = ("dense", "hybrid", "vlm", "encoder", "moe", "xlstm")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported to repro_torch "
            f"(ported: {PORTED_FAMILIES})")


# ---------------------------------------------------------------------------
# group structure
# ---------------------------------------------------------------------------

def group_size(cfg: ModelConfig) -> int:
    if cfg.family == "xlstm":
        return cfg.xlstm.slstm_every
    if cfg.family == "hybrid":
        return cfg.hybrid.mamba_per_group + 1
    if cfg.family == "moe" and cfg.d_ff > 0:
        return 2  # alternating dense / moe
    return 1


def n_groups(cfg: ModelConfig) -> int:
    _require_ported(cfg)
    g = group_size(cfg)
    if cfg.n_layers % g:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split "
                         f"into groups of {g}")
    return cfg.n_layers // g


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _empty_stack(tree, n: int, device):
    """Uninitialised (n, ...) leaves shaped like ``tree``'s."""
    if isinstance(tree, dict):
        return {k: _empty_stack(v, n, device) for k, v in tree.items()}
    return torch.empty((n,) + tuple(tree.shape), dtype=tree.dtype,
                       device=device)


def _put(stack, tree, g: int) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put(stack[k], v, g)
    else:
        stack[g].copy_(tree)


# ---------------------------------------------------------------------------
# per-group init and forward
# ---------------------------------------------------------------------------

def _attn_init(gen, cfg: ModelConfig, dtype, device):
    if cfg.attention.is_mla:
        return mla_init(gen, cfg.d_model, cfg.attention, dtype, device)
    return attention_init(gen, cfg.d_model, cfg.attention, dtype, device)


def _dense_sublayer_init(gen, cfg: ModelConfig, dtype, device):
    """[ln1, attn, ln2, mlp]."""
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "attn": _attn_init(gen, cfg, dtype, device),
        "ln2": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype,
                        device),
    }


def _moe_sublayer_init(gen, cfg: ModelConfig, dtype, device):
    """[ln1, attn, ln2, moe]."""
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "attn": _attn_init(gen, cfg, dtype, device),
        "ln2": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "moe": moe_init(gen, cfg.d_model, cfg.moe, dtype, device),
    }


def _stacked(make, m: int, device):
    """``m`` sublayers' params from ``make()``, stacked (m, ...)."""
    stack = None
    for i in range(m):
        lp = make()
        if stack is None:
            stack = _empty_stack(lp, m, device)
        _put(stack, lp, i)
    return stack


def group_init(gen, cfg: ModelConfig, dtype, device):
    """One group's params: a dense sublayer, a MoE sublayer (after a dense
    one when ``d_ff > 0``), the xlstm's mLSTM sublayers stacked (k-1, ...)
    and its sLSTM, or the hybrid's Mamba2 sublayers stacked (m, ...)."""
    if cfg.family == "moe":
        if cfg.d_ff > 0:
            return {"dense": _dense_sublayer_init(gen, cfg, dtype, device),
                    "moe": _moe_sublayer_init(gen, cfg, dtype, device)}
        return _moe_sublayer_init(gen, cfg, dtype, device)

    def sublayer(init, blk_cfg):
        return lambda: {"ln": norm_init(cfg.d_model, cfg.norm, dtype,
                                        device),
                        "blk": init(gen, cfg.d_model, blk_cfg, dtype,
                                    device)}

    if cfg.family == "xlstm":
        return {"mlstm": _stacked(sublayer(ssm.mlstm_init, cfg.xlstm),
                                  cfg.xlstm.slstm_every - 1, device),
                "slstm": sublayer(ssm.slstm_init, cfg.xlstm)()}
    if cfg.family != "hybrid":
        return _dense_sublayer_init(gen, cfg, dtype, device)
    return {"mamba": _stacked(sublayer(ssm.mamba2_init, cfg.ssm),
                              cfg.hybrid.mamba_per_group, device)}


def shared_extra_init(gen, cfg: ModelConfig, dtype, device):
    """Weight-shared sublayers applied once per group (zamba2 attention)."""
    if cfg.family == "hybrid":
        return _dense_sublayer_init(gen, cfg, dtype, device)
    return None


def _attn_fwd(p, h, cfg, *, positions, cache, cache_len, causal=None,
              page_table=None, seq_lens=None, impl: str = "auto"):
    """The sublayer's attention: paged, MLA or GQA (the last two computed
    sharded over ``model`` where the context's layout says)."""
    # `is not None`: an all-zeros page table is a valid (trash-only) table
    if page_table is not None:
        return paged_attention_fwd(p, h, cfg.attention, pages=cache,
                                   page_table=page_table, seq_lens=seq_lens,
                                   impl=impl)
    if cfg.attention.is_mla:
        return mla_fwd(p, h, cfg.attention, positions=positions,
                       cache=cache, cache_len=cache_len, impl=impl,
                       tp=shard_ctx.tp_on("attn"))
    return attention_fwd(p, h, cfg.attention, positions=positions,
                         cache=cache, cache_len=cache_len, causal=causal,
                         impl=impl, tp=shard_ctx.tp_on("attn"))


def _dense_sublayer_fwd(p, x, cfg, *, positions, cache, cache_len,
                        causal=None, page_table=None, seq_lens=None,
                        impl: str = "auto"):
    h = apply_norm(p["ln1"], x, cfg.norm, impl=impl)
    a, new_cache = _attn_fwd(p["attn"], h, cfg, positions=positions,
                             cache=cache, cache_len=cache_len, causal=causal,
                             page_table=page_table, seq_lens=seq_lens,
                             impl=impl)
    x = x + a
    h = apply_norm(p["ln2"], x, cfg.norm, impl=impl)
    x = x + mlp_fwd(p["mlp"], h, cfg.act, cfg.mlp_gated,
                    tp=shard_ctx.tp_on("mlp"))
    return x, new_cache


def _moe_sublayer_fwd(p, x, cfg, *, positions, cache, cache_len,
                      page_table=None, seq_lens=None, impl: str = "auto"):
    h = apply_norm(p["ln1"], x, cfg.norm, impl=impl)
    a, new_cache = _attn_fwd(p["attn"], h, cfg, positions=positions,
                             cache=cache, cache_len=cache_len,
                             page_table=page_table, seq_lens=seq_lens,
                             impl=impl)
    x = x + a
    h = apply_norm(p["ln2"], x, cfg.norm, impl=impl)
    m, aux = moe_fwd(p["moe"], h, cfg.moe, cfg.act)
    return x + m, aux, new_cache


def group_fwd(gp, x, cfg: ModelConfig, *, positions, cache, cache_len,
              extra=None, page_table=None, seq_lens=None,
              impl: str = "auto"):
    """Returns (x, aux, new_cache).  ``cache`` is this group's cache (or
    None), updated in place."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "xlstm":
        n_m = cfg.xlstm.slstm_every - 1
        for i, lp in enumerate(_unbind(gp["mlstm"], n_m)):
            st = None if cache is None else _index(cache["mlstm"], i)
            h = apply_norm(lp["ln"], x, cfg.norm, impl=impl)
            y, _ = ssm.mlstm_fwd(lp["blk"], h, cfg.xlstm, cfg.d_model,
                                 state=st, impl=impl)
            x = x + y
        sp = gp["slstm"]
        h = apply_norm(sp["ln"], x, cfg.norm, impl=impl)
        y, _ = ssm.slstm_fwd(sp["blk"], h, cfg.xlstm, cfg.d_model,
                             state=None if cache is None else cache["slstm"],
                             impl=impl)
        return x + y, aux, cache
    if cfg.family == "hybrid":
        n_m = cfg.hybrid.mamba_per_group
        for i, lp in enumerate(_unbind(gp["mamba"], n_m)):
            st = None if cache is None else _index(cache["mamba"], i)
            h = apply_norm(lp["ln"], x, cfg.norm, impl=impl)
            y, _ = ssm.mamba2_fwd(lp["blk"], h, cfg.ssm, cfg.d_model,
                                  state=st, impl=impl)
            x = x + y
        # weight-shared attention block (params from `extra`, cache per
        # group)
        a_cache = None if cache is None else cache["attn"]
        x, _ = _dense_sublayer_fwd(extra, x, cfg, positions=positions,
                                   cache=a_cache, cache_len=cache_len,
                                   impl=impl)
        return x, aux, cache
    if cfg.family == "encoder":
        x, _ = _dense_sublayer_fwd(gp, x, cfg, positions=positions,
                                   cache=None, cache_len=None, causal=False,
                                   impl=impl)
        return x, aux, None
    if cfg.family == "moe":
        kw = dict(positions=positions, cache_len=cache_len,
                  page_table=page_table, seq_lens=seq_lens, impl=impl)
        if cfg.d_ff > 0:
            x, _ = _dense_sublayer_fwd(
                gp["dense"], x, cfg,
                cache=None if cache is None else cache["dense"], **kw)
            gp, cache_m = gp["moe"], None if cache is None else cache["moe"]
        else:
            cache_m = cache
        x, aux, _ = _moe_sublayer_fwd(gp, x, cfg, cache=cache_m, **kw)
        return x, aux, cache
    x, nc = _dense_sublayer_fwd(gp, x, cfg, positions=positions,
                                cache=cache, cache_len=cache_len,
                                page_table=page_table, seq_lens=seq_lens,
                                impl=impl)
    return x, aux, nc


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _attn_cache_init(cfg: ModelConfig, lead, device, kv_split: int = 1):
    """One attention cache with leading dims ``lead``: MLA's compressed
    {"c_kv", "k_rope"}, else {"k", "v"} of ``n_kv_heads / kv_split``
    heads (a rank's share under tensor parallelism)."""
    a, dt = cfg.attention, _dtype(cfg)
    if a.is_mla:
        return {"c_kv": torch.zeros(lead + (a.kv_lora_rank,), dtype=dt,
                                    device=device),
                "k_rope": torch.zeros(lead + (a.qk_rope_head_dim,),
                                      dtype=dt, device=device)}
    Hkv = a.n_kv_heads // kv_split
    return {"k": torch.zeros(lead + (Hkv, a.head_dim), dtype=dt,
                             device=device),
            "v": torch.zeros(lead + (Hkv, a.v_dim), dtype=dt,
                             device=device)}


def _zeros(spec, lead, device):
    """Zeros shaped ``lead + shape`` for each (shape, dtype) of a state
    spec, in its dicts and tuples."""
    if isinstance(spec, dict):
        return {k: _zeros(v, lead, device) for k, v in spec.items()}
    if not isinstance(spec[1], torch.dtype):
        return tuple(_zeros(s, lead, device) for s in spec)
    shape, dtype = spec
    return torch.zeros(lead + shape, dtype=dtype, device=device)


def _xlstm_cache_init(cfg: ModelConfig, batch: int, device,
                      split: int = 1):
    """{"mlstm": {"conv", "mlstm": (C, n, m)} stacked (n_groups, k-1,
    ...), "slstm": {"slstm": (h, c, n, m)} stacked (n_groups, ...)}, as
    the reference's: the mLSTM's carry from ``_mlstm_zero_carry``, the
    sLSTM's n from ones; the states of H / ``split`` heads."""
    ng, dt = n_groups(cfg), _dtype(cfg)
    lead = (ng, cfg.xlstm.slstm_every - 1)
    spec = ssm.mlstm_state_spec(cfg.xlstm, cfg.d_model, batch, dt)
    mlstm = {"conv": _zeros(spec["conv"], lead, device),
             "mlstm": _mlstm_zero_carry(cfg, lead + (batch,), device,
                                        split)}
    slstm = _zeros(ssm.slstm_state_spec(cfg.xlstm, cfg.d_model, batch,
                                        split), (ng,), device)
    slstm["slstm"][2].fill_(1.0)
    return {"mlstm": mlstm, "slstm": slstm}


def _mlstm_zero_carry(cfg: ModelConfig, lead, device, split: int = 1):
    """(C, n, m) of H / ``split`` heads with leading dims ``lead``:
    zeros, and m = -inf."""
    _, Dk, Dv, H = ssm._mlstm_dims(cfg.d_model, cfg.xlstm)
    H //= split
    f32 = torch.float32
    return (torch.zeros(lead + (H, Dk, Dv), dtype=f32, device=device),
            torch.zeros(lead + (H, Dk), dtype=f32, device=device),
            torch.full(lead + (H,), float("-inf"), dtype=f32,
                       device=device))


def init_cache(cfg: ModelConfig, batch: int, smax: int, device,
               kv_split: int = 1, mamba_split: int = 1,
               seq_split: int = 1, xlstm_split: int = 1):
    """Stacked (n_groups, ...) cache: the dense family's (and the VLM's)
    KV cache; the moe family's, MLA's compressed {"c_kv", "k_rope"} or,
    with dense layers between, {"dense": kv, "moe": kv}; the xlstm's
    recurrent states (``_xlstm_cache_init``; no KV cache, so ``smax`` is
    unused); or the hybrid's {"mamba": {"conv", "ssm"} stacked (n_groups,
    m, ...), "attn": {"k", "v"}}; None for the encoder, which does not
    decode.  A rank's share of a block's cache (``plans.cache_layouts``):
    ``kv_split``, the GQA kv heads split over that many ranks of a model
    column (the attention computed sharded, ``plans.TPLayout``);
    ``mamba_split``, the Mamba2 heads so split (the ``ssm`` state's
    heads, the ``conv`` state's channels of those heads and the whole B
    and C, ``ssm.mamba_columns``); ``seq_split``, the attention cache's
    positions (GQA's K/V or MLA's compressed cache) split over that many
    data ranks (``ShardCtx.seq_split``); ``xlstm_split``, the xLSTM's
    heads so split (the mLSTM's ``(C, n, m)`` and the sLSTM's ``(h, c,
    n, m)`` of the rank's heads; the mLSTM's conv tail whole, every rank
    computing all of its channels).  MLA's compressed cache has no
    heads: ``kv_split`` leaves it whole."""
    dt, ng = _dtype(cfg), n_groups(cfg)
    if cfg.family == "encoder":
        return None
    if cfg.family == "xlstm":
        return _xlstm_cache_init(cfg, batch, device, xlstm_split)
    lead = (ng, batch, smax // seq_split)
    kv = _attn_cache_init(cfg, lead, device, kv_split)
    if cfg.family == "moe" and cfg.d_ff > 0:
        return {"dense": _attn_cache_init(cfg, lead, device, kv_split),
                "moe": kv}
    if cfg.family != "hybrid":
        return kv
    lead = (ng, cfg.hybrid.mamba_per_group)
    spec = ssm.mamba2_state_spec(cfg.ssm, cfg.d_model, batch, dt)
    if mamba_split > 1:
        (cs, cdt), (ss, sdt) = spec["conv"], spec["ssm"]
        di = cfg.ssm.expand * cfg.d_model
        n = di // mamba_split + 2 * cfg.ssm.state_dim
        spec = {"conv": (cs[:-1] + (n,), cdt),
                "ssm": ((ss[0], ss[1] // mamba_split) + ss[2:], sdt)}
    return {"mamba": _zeros(spec, lead, device), "attn": kv}


def conv_whole(conv, cfg: ModelConfig):
    """The whole ``conv`` state leaf, in the reference's channel order,
    from each rank's channels (``ssm.mamba_columns``) under the installed
    context whose layout computes "mamba" sharded: the column's ``x``
    channels gathered in rank order, then ``B`` and ``C`` (the same on
    every rank).  Forward only; ``conv`` itself at M = 1."""
    M = shard_ctx.model_size()
    if M == 1 or not shard_ctx.tp_on("mamba"):
        return conv
    dl = cfg.ssm.expand * cfg.d_model // M
    x = shard_ctx.gather_out(conv[..., :dl].contiguous(), -1)
    return torch.cat([x, conv[..., dl:]], -1)


def conv_of_rank(conv, cfg: ModelConfig):
    """This rank's channels (``ssm.mamba_columns``) of a whole ``conv``
    state leaf under the installed context; ``conv`` itself at M = 1."""
    M = shard_ctx.model_size()
    if M == 1 or not shard_ctx.tp_on("mamba"):
        return conv
    _, chans = ssm.mamba_columns(cfg.ssm, cfg.d_model, M,
                                 shard_ctx.model_rank())
    idx = torch.tensor(chans, device=conv.device)
    return conv.index_select(conv.ndim - 1, idx)


def check_paged_support(cfg: ModelConfig) -> None:
    """Paged decode covers the plain-GQA attention families; recurrent
    states (xlstm/hybrid) and MLA's compressed cache page differently and
    stay on the dense path."""
    if cfg.family not in ("dense", "vlm", "moe") or cfg.attention is None:
        raise ValueError(
            f"paged decode unsupported for family {cfg.family!r}")
    if cfg.attention.is_mla:
        raise ValueError("paged decode does not support MLA caches")
    if cfg.attention.sliding_window > 0:
        raise ValueError("paged decode does not support sliding windows")


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int, device):
    """Stacked (n_groups, ...) page-pool tree shared by all live slots.
    Page 0 is reserved as the trash page (never allocated to a session):
    inactive slots' table rows point at it so their scatter writes and
    gathered garbage stay masked out."""
    check_paged_support(cfg)
    lead = (n_groups(cfg), n_pages, page_size)
    if cfg.family == "moe" and cfg.d_ff > 0:
        return {"dense": _attn_cache_init(cfg, lead, device),
                "moe": _attn_cache_init(cfg, lead, device)}
    return _attn_cache_init(cfg, lead, device)


# ---------------------------------------------------------------------------
# full-stack params + forward
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                place=None) -> Dict[str, Any]:
    """Random params from ``seed`` through one ``torch.Generator`` on
    ``device`` (``cuda`` by default, which raises without a card; pass
    ``device="cpu"`` for the host; the ``meta`` device gives shapes only).
    Not the JAX package's numbers: to compare, move its params across with
    ``repro_torch.interop``.

    ``place(path, leaf)``, when given, maps each leaf as it is drawn to
    what the tree keeps of it (a rank's shard: ``place`` slices, the
    stacked leaves' group slices without their stack dim), so the draws
    are the unsharded tree's, one group at a time, and no rank ever holds
    the whole model."""
    _require_ported(cfg)
    dtype = _dtype(cfg)
    device = resolve(device)
    keep = place or (lambda path, leaf: leaf)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    # one group at a time into stacked leaves: neither the fp32 draw of
    # the whole stack nor a second copy of it ever exists; the leaves of a
    # single group, kept whole, are their own stack (llama4's one-group cut
    # is 33 GB)
    ng = n_groups(cfg)
    stack: Dict[str, torch.Tensor] = {}
    for g in range(ng):
        for path, leaf in flatten(group_init(gen, cfg, dtype, device)):
            kept = keep("layers/" + path, leaf)
            if ng == 1 and kept is leaf:
                stack[path] = leaf.unsqueeze(0)
                continue
            if g == 0:
                stack[path] = torch.empty((ng,) + tuple(kept.shape),
                                          dtype=kept.dtype, device=device)
            stack[path][g].copy_(kept)
    params: Dict[str, Any] = {"layers": unflatten(stack.items())}
    if cfg.frontend == "frame":
        params["frame_proj"] = _he(gen, (cfg.frontend_dim, cfg.d_model),
                                   dtype, device)
        params["mask_embed"] = _randn((cfg.d_model,), gen, device, dtype,
                                      0.02)
    else:
        params["embed"] = _randn((cfg.vocab_size, cfg.d_model), gen, device,
                                 dtype, 0.02)
    if cfg.frontend == "patch":
        params["patch_proj"] = _he(gen, (cfg.frontend_dim, cfg.d_model),
                                   dtype, device)
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm, dtype, device)
    extra = shared_extra_init(gen, cfg, dtype, device)
    if extra is not None:
        params["extra"] = extra
    if not cfg.tie_embeddings:
        params["lm_head"] = _he(gen, (cfg.d_model, cfg.vocab_size), dtype,
                                device)
    if place is not None:
        layers = params.pop("layers")
        params = unflatten((path, keep(path, leaf))
                           for path, leaf in flatten(params))
        params["layers"] = layers
    return params


def place_params(cfg: ModelConfig, layouts, *, seed: int = 0,
                 params: Optional[Dict[str, Any]] = None, device="cuda"):
    """The param tree on a mesh: every leaf a DTensor of this rank's
    shards in ``layouts`` (a tree of ``plans.Layout`` by the params'
    paths).  Random weights are drawn as the unsharded init draws them,
    one group at a time, and sliced (``init_params``' ``place``); a given
    whole tree is sliced, and a given tree of DTensors (a sharded
    restore's) is kept as it is."""
    lay = dict(flatten(layouts))

    def place(path, leaf):
        if path.startswith("layers/"):      # a group's slice, no stack dim
            return leaf[lay[path].index((1,) + tuple(leaf.shape))[1:]]
        return leaf[lay[path].index(tuple(leaf.shape))].clone()

    if params is None:
        local = init_params(cfg, seed=seed, device=device, place=place)
        return unflatten((path, lay[path].wrap(leaf))
                         for path, leaf in flatten(local))
    return unflatten(
        (path, leaf if isinstance(leaf, DTensor)
         else lay[path].shard(leaf.to(device)))
        for path, leaf in flatten(params))


def _stub_proj(inputs, w):
    """``inputs.astype(bf16) @ w`` as ``jnp`` computes it: the inputs
    rounded to bf16, then the product in ``w``'s dtype (with fp32 params
    ``jnp`` promotes the bf16 operand to fp32; ``torch.matmul`` takes no
    mixed dtypes)."""
    return inputs.to(torch.bfloat16).to(w.dtype) @ w


def embed_inputs(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """Build the (B, S, d) input activations from the batch dict: frames
    projected (``mask_embed`` where ``batch["mask"]`` is set), or token
    embeddings with the projected patches in front of them when the batch
    has ``"patches"``."""
    _require_ported(cfg)
    if cfg.frontend == "frame":
        x = _stub_proj(batch["frames"], full(params["frame_proj"]))
        if "mask" in batch:
            x = torch.where(batch["mask"].bool()[..., None],
                            full(params["mask_embed"]), x)
        return x
    tok = _lookup(full(params["embed"], "embed"), batch["tokens"].long())
    if cfg.frontend == "patch" and "patches" in batch:
        patches = _stub_proj(batch["patches"], full(params["patch_proj"]))
        tok = torch.cat([patches, tok], dim=1)
    return tok


def _lookup(embed, ids):
    """The embedding rows of ``ids``; vocab-parallel where ``embed`` is a
    rank's rows of the table: ids outside them give zero rows, and the
    model column's rows are summed (one of them nonzero, so the sum is
    the row exactly)."""
    if not shard_ctx.tp_on("vocab") or shard_ctx.model_size() == 1:
        return embed[ids]
    V = embed.shape[0]
    local = ids - shard_ctx.model_rank() * V
    mine = (local >= 0) & (local < V)
    rows = embed[torch.where(mine, local, 0)]
    return shard_ctx.reduce_out(torch.where(mine[..., None], rows, 0))


def vocab_whole(logits):
    """Logits of the whole vocabulary: those of a rank's vocabulary
    (``forward``'s under vocab parallelism) gathered over the model
    column, in rank order; ``logits`` itself otherwise."""
    if not shard_ctx.tp_on("vocab"):
        return logits
    return shard_ctx.gather_out(logits, -1)


def forward(params, cfg: ModelConfig, x, *, positions, cache=None,
            cache_len=None, page_table=None, seq_lens=None,
            impl: str = "auto"):
    """Run the stack on embedded inputs x: (B, S, d).

    With ``page_table``/``seq_lens`` set, ``cache`` is the stacked paged
    pool from ``init_paged_cache`` and decode runs the paged-attention path
    (the table and lengths are shared across groups; each group works on
    its own pool slice).  Returns (logits (B, S, V), aux_loss, cache); the
    cache is updated in place.  Under vocab parallelism the logits are
    the rank's vocabulary's, (B, S, V/M) (``vocab_whole``).
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    extra = params.get("extra")
    groups = _unbind(params["layers"], n_groups(cfg))
    remat = (cfg.remat != "none" and cache is None
             and torch.is_grad_enabled())
    for g, gp in enumerate(groups):
        if remat:
            # the reference's "dots" policy saves the matmul outputs; here
            # both policies recompute the whole group
            # the sharding context goes in as an argument: the recompute
            # runs in the backward, on the autograd engine's device
            # thread for a CUDA tensor, where the caller's thread-local
            # context is not installed
            x, a = checkpoint(_train_group, gp, x, cfg, positions, extra,
                              impl, shard_ctx.current(),
                              use_reentrant=False)
        else:
            gc = None if cache is None else _index(cache, g)
            x, a, _ = group_fwd(shard_ctx.full_tree(gp, "layers"), x, cfg,
                                positions=positions, cache=gc,
                                cache_len=cache_len,
                                extra=shard_ctx.full_tree(extra, "extra"),
                                page_table=page_table, seq_lens=seq_lens,
                                impl=impl)
        aux = aux + a
    x = apply_norm(shard_ctx.full_tree(params["final_norm"], "final_norm"),
                   x, cfg.norm, impl=impl)
    head = (full(params["embed"], "embed").T if cfg.tie_embeddings
            else full(params["lm_head"], "lm_head"))
    if shard_ctx.tp_on("vocab"):
        x = shard_ctx.copy_in(x)
    logits = x @ head
    if cfg.logits_softcap > 0:
        logits = torch.tanh(logits / cfg.logits_softcap) * cfg.logits_softcap
    return logits, aux, cache


def _train_group(gp, x, cfg, positions, extra, impl, ctx=None):
    with shard_ctx.use(ctx):
        x, a, _ = group_fwd(shard_ctx.full_tree(gp, "layers"), x, cfg,
                            positions=positions, cache=None, cache_len=None,
                            extra=shard_ctx.full_tree(extra, "extra"),
                            impl=impl)
    return x, a


def _index(tree, g: int):
    """View of group ``g`` of a stacked tree, in its dicts and tuples
    (writes go to the stack)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, g) for v in tree)
    return tree[g]


def _unbind_leaf(leaf):
    """``torch.unbind(leaf, 0)``; a DTensor's local shard is unbound and
    each slice wrapped again with its placements one dim lower (the plan
    leaves the stack dims unsharded)."""
    if not isinstance(leaf, DTensor):
        return torch.unbind(leaf, 0)
    placements = []
    for pl in leaf.placements:
        if isinstance(pl, Shard):
            assert pl.dim > 0, ("a stack dim is sharded", leaf.placements)
            pl = Shard(pl.dim - 1)
        placements.append(pl)
    return [DTensor.from_local(t, leaf.device_mesh, placements,
                               run_check=False)
            for t in torch.unbind(leaf.to_local(), 0)]


def _unbind(tree, n: int):
    """The stacked tree as ``n`` per-group trees, each leaf unbound once."""
    flat = [(path, _unbind_leaf(leaf)) for path, leaf in flatten(tree)]
    return [unflatten((path, parts[g]) for path, parts in flat)
            for g in range(n)]


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

def flatten(tree, prefix: str = ""):
    """[(path, leaf)] of a nested dict, paths joined with '/', in
    ``jax.tree`` order; a tuple's items (the xlstm cache's) are walked in
    order, their paths ending in the index."""
    out = []
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        out.extend(flatten(v, path) if isinstance(v, (dict, tuple))
                   else [(path, v)])
    return out


def unflatten(pairs) -> Dict[str, Any]:
    """The nested dict of ``flatten``'s pairs (a param tree: no
    tuples)."""
    tree: Dict[str, Any] = {}
    for path, leaf in pairs:
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


class Transformer(nn.Module):
    """One model of a ported family on one device.  Holds the
    JAX-layout param tree as ``nn.Parameter`` leaves named by tree path
    (``layers/attn/wq``, ``extra/mlp/w_up``), so ``state_dict()`` keys are
    the tree's paths;
    ``params`` rebuilds the nested dict of the same tensors.
    ``params=None`` draws random weights from ``seed``.  The leaves
    require gradients only with ``requires_grad=True`` (a train block);
    serving keeps them frozen.  On a mesh the given leaves are DTensors
    (``place_params``), each parameter a DTensor of this rank's shards,
    and ``forward`` gathers them a group at a time."""

    def __init__(self, cfg: ModelConfig, params: Optional[Dict] = None, *,
                 seed: int = 0, device="cuda", requires_grad: bool = False):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        self.device = resolve(device)
        if params is None:
            params = init_params(cfg, seed=seed, device=self.device)
        for path, leaf in flatten(params):
            self.register_parameter(path, nn.Parameter(
                leaf.detach().to(self.device), requires_grad=requires_grad))

    @property
    def params(self) -> Dict[str, Any]:
        return unflatten(self.named_parameters())

    def forward(self, x, *, positions, cache=None, cache_len=None,
                page_table=None, seq_lens=None, impl: str = "auto"):
        return forward(self.params, self.cfg, x, positions=positions,
                       cache=cache, cache_len=cache_len,
                       page_table=page_table, seq_lens=seq_lens, impl=impl)
