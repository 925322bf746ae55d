"""Stack assembly for the dense and hybrid families (the port of
``repro.models.transformer``; the other families come with later slices).

The stack is a repeated *group* of sublayers with every parameter leaf
stacked ``(n_groups, ...)``, as in the JAX tree, so params move across
leaf for leaf:

  dense  : group = [attn + mlp]
  hybrid : group = [mamba2 x m, shared-attn + mlp]  (zamba2; the mamba
           leaves are stacked ``(n_groups, m, ...)``, the attention block's
           params live once in ``params["extra"]`` and are applied by every
           group, each with its own KV cache)

Where the reference scans the groups (and a group's Mamba2 sublayers)
with ``lax.scan``, ``forward`` loops over them in Python.  Each stacked
param leaf is ``torch.unbind`` once per forward, so under autograd its
backward stacks the group gradients once (indexing ``leaf[g]`` per group
would write a zero tensor the size of the whole stack for every group).
With ``cfg.remat == "full"`` and gradients on, each group runs under
``torch.utils.checkpoint`` and is recomputed in the backward, as the
reference wraps its scan body in ``jax.checkpoint``.  ``Transformer`` is
the ``nn.Module`` that owns one model's parameters on one device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_randn, apply_norm, attention_fwd,
                                       attention_init, mlp_fwd, mlp_init,
                                       norm_init, paged_attention_fwd,
                                       _he)

PORTED_FAMILIES = ("dense", "hybrid")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported to repro_torch "
            f"(ported: {PORTED_FAMILIES})")
    if cfg.attention is not None and cfg.attention.is_mla:
        raise NotImplementedError("MLA attention is not yet ported")


# ---------------------------------------------------------------------------
# group structure
# ---------------------------------------------------------------------------

def group_size(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.hybrid.mamba_per_group + 1
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

def _dense_sublayer_init(gen, cfg: ModelConfig, dtype, device):
    """[ln1, attn, ln2, mlp]."""
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "attn": attention_init(gen, cfg.d_model, cfg.attention, dtype,
                               device),
        "ln2": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype,
                        device),
    }


def group_init(gen, cfg: ModelConfig, dtype, device):
    """One group's params: a dense sublayer, or the hybrid's Mamba2
    sublayers stacked (m, ...)."""
    if cfg.family != "hybrid":
        return _dense_sublayer_init(gen, cfg, dtype, device)
    m, stack = cfg.hybrid.mamba_per_group, None
    for i in range(m):
        lp = {"ln": norm_init(cfg.d_model, cfg.norm, dtype, device),
              "blk": ssm.mamba2_init(gen, cfg.d_model, cfg.ssm, dtype,
                                     device)}
        if stack is None:
            stack = _empty_stack(lp, m, device)
        _put(stack, lp, i)
    return {"mamba": stack}


def shared_extra_init(gen, cfg: ModelConfig, dtype, device):
    """Weight-shared sublayers applied once per group (zamba2 attention)."""
    if cfg.family == "hybrid":
        return _dense_sublayer_init(gen, cfg, dtype, device)
    return None


def _dense_sublayer_fwd(p, x, cfg, *, positions, cache, cache_len,
                        causal=None, page_table=None, seq_lens=None,
                        impl: str = "auto"):
    h = apply_norm(p["ln1"], x, cfg.norm, impl=impl)
    # `is not None`: an all-zeros page table is a valid (trash-only) table
    if page_table is not None:
        a, new_cache = paged_attention_fwd(p["attn"], h, cfg.attention,
                                           pages=cache,
                                           page_table=page_table,
                                           seq_lens=seq_lens, impl=impl)
    else:
        a, new_cache = attention_fwd(p["attn"], h, cfg.attention,
                                     positions=positions, cache=cache,
                                     cache_len=cache_len, causal=causal,
                                     impl=impl)
    x = x + a
    h = apply_norm(p["ln2"], x, cfg.norm, impl=impl)
    x = x + mlp_fwd(p["mlp"], h, cfg.act, cfg.mlp_gated)
    return x, new_cache


def group_fwd(gp, x, cfg: ModelConfig, *, positions, cache, cache_len,
              extra=None, page_table=None, seq_lens=None,
              impl: str = "auto"):
    """Returns (x, aux, new_cache).  ``cache`` is this group's cache (or
    None), updated in place."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
    x, nc = _dense_sublayer_fwd(gp, x, cfg, positions=positions,
                                cache=cache, cache_len=cache_len,
                                page_table=page_table, seq_lens=seq_lens,
                                impl=impl)
    return x, aux, nc


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, smax: int, device):
    """Stacked (n_groups, ...) cache: the dense family's KV cache, or the
    hybrid's {"mamba": {"conv", "ssm"} stacked (n_groups, m, ...),
    "attn": {"k", "v"}}."""
    a, dt, ng = cfg.attention, _dtype(cfg), n_groups(cfg)
    kv = {"k": torch.zeros((ng, batch, smax, a.n_kv_heads, a.head_dim),
                           dtype=dt, device=device),
          "v": torch.zeros((ng, batch, smax, a.n_kv_heads, a.v_dim),
                           dtype=dt, device=device)}
    if cfg.family != "hybrid":
        return kv
    lead = (ng, cfg.hybrid.mamba_per_group)
    spec = ssm.mamba2_state_spec(cfg.ssm, cfg.d_model, batch, dt)
    return {"mamba": {k: torch.zeros(lead + shape, dtype=d, device=device)
                      for k, (shape, d) in spec.items()},
            "attn": kv}


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
    a, dt, ng = cfg.attention, _dtype(cfg), n_groups(cfg)
    return {"k": torch.zeros((ng, n_pages, page_size, a.n_kv_heads,
                              a.head_dim), dtype=dt, device=device),
            "v": torch.zeros((ng, n_pages, page_size, a.n_kv_heads,
                              a.v_dim), dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# full-stack params + forward
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random params from ``seed`` through one ``torch.Generator`` on
    ``device`` (``cuda`` by default, which raises without a card; pass
    ``device="cpu"`` for the host; the ``meta`` device gives shapes only).
    Not the JAX package's numbers: to compare, move its params across with
    ``repro_torch.interop``."""
    _require_ported(cfg)
    dtype = _dtype(cfg)
    device = resolve(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    # one group at a time into preallocated stacked leaves: neither the
    # fp32 draw of the whole stack nor a second copy of it ever exists
    ng = n_groups(cfg)
    layers = _empty_stack(group_init(None, cfg, dtype, "meta"), ng, device)
    if device.type != "meta":
        for g in range(ng):
            _put(layers, group_init(gen, cfg, dtype, device), g)
    params: Dict[str, Any] = {
        "layers": layers,
        "embed": _randn((cfg.vocab_size, cfg.d_model), gen, device, dtype,
                        0.02),
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, device),
    }
    extra = shared_extra_init(gen, cfg, dtype, device)
    if extra is not None:
        params["extra"] = extra
    if not cfg.tie_embeddings:
        params["lm_head"] = _he(gen, (cfg.d_model, cfg.vocab_size), dtype,
                                device)
    return params


def embed_inputs(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """Build the (B, S, d) input activations from the batch dict."""
    _require_ported(cfg)
    return params["embed"][batch["tokens"].long()]


def forward(params, cfg: ModelConfig, x, *, positions, cache=None,
            cache_len=None, page_table=None, seq_lens=None,
            impl: str = "auto"):
    """Run the stack on embedded inputs x: (B, S, d).

    With ``page_table``/``seq_lens`` set, ``cache`` is the stacked paged
    pool from ``init_paged_cache`` and decode runs the paged-attention path
    (the table and lengths are shared across groups; each group works on
    its own pool slice).  Returns (logits (B, S, V), aux_loss, cache); the
    cache is updated in place.
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
            x, a = checkpoint(_train_group, gp, x, cfg, positions, extra,
                              impl, use_reentrant=False)
        else:
            gc = None if cache is None else _index(cache, g)
            x, a, _ = group_fwd(gp, x, cfg, positions=positions, cache=gc,
                                cache_len=cache_len, extra=extra,
                                page_table=page_table, seq_lens=seq_lens,
                                impl=impl)
        aux = aux + a
    x = apply_norm(params["final_norm"], x, cfg.norm, impl=impl)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.logits_softcap > 0:
        logits = torch.tanh(logits / cfg.logits_softcap) * cfg.logits_softcap
    return logits, aux, cache


def _train_group(gp, x, cfg, positions, extra, impl):
    x, a, _ = group_fwd(gp, x, cfg, positions=positions, cache=None,
                        cache_len=None, extra=extra, impl=impl)
    return x, a


def _index(tree, g: int):
    """View of group ``g`` of a stacked tree (writes go to the stack)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _unbind(tree, n: int):
    """The stacked tree as ``n`` per-group trees, each leaf unbound once."""
    flat = [(path, torch.unbind(leaf, 0)) for path, leaf in flatten(tree)]
    return [unflatten((path, parts[g]) for path, parts in flat)
            for g in range(n)]


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

def flatten(tree, prefix: str = ""):
    """[(path, leaf)] of a nested dict, paths joined with '/'."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        out.extend(flatten(v, path) if isinstance(v, dict) else [(path, v)])
    return out


def unflatten(pairs) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in pairs:
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


class Transformer(nn.Module):
    """One dense- or hybrid-family model on one device.  Holds the
    JAX-layout param tree as ``nn.Parameter`` leaves named by tree path
    (``layers/attn/wq``, ``extra/mlp/w_up``), so ``state_dict()`` keys are
    the tree's paths;
    ``params`` rebuilds the nested dict of the same tensors.
    ``params=None`` draws random weights from ``seed``.  The leaves
    require gradients only with ``requires_grad=True`` (a train block);
    serving keeps them frozen."""

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
