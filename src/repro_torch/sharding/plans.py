"""Partition-spec plans: map param/batch/cache trees to partition specs
(the port of ``repro.sharding.plans``), and specs to DTensor placements.

Axis roles:
  dp axes   ("pod","data") or ("data",) — data parallel + FSDP (ZeRO-3)
  model     "model"                     — TP (heads/ff/vocab) + EP (experts)

Rules are keyed on leaf *names* (unique across the model substrate) with the
base (unstacked) spec; leading stack dims get ``None``.  A dim is only
sharded if divisible by the axis size — otherwise it is replicated.

A spec keeps the reference's ``PartitionSpec`` form as a tuple: one entry
per tensor dim, an axis name, a tuple of axis names or ``None`` (a leaf
whose name has no rule gets ``()``, fully replicated, as ``P()``).  A
``mesh`` is a ``torch.distributed`` ``DeviceMesh`` with named dims, or a
``{axis name: size}`` dict in mesh order (the shape arithmetic alone, as
a ``jax.sharding.AbstractMesh`` gives it).  ``to_placements`` turns a
spec into one ``Shard(dim)`` or ``Replicate()`` per mesh dim; a tensor
dim sharded over ``("pod", "data")`` is ``Shard(d)`` on both, pod first.

Two departures serve the port's optimizer, which updates each rank's
local shard with the fused AdamW kernel (``update_spec``): int8 moments
quantize in blocks of 256 along the last dim of the whole leaf, so a
rank's slice of that dim must hold whole blocks.  Where the plan's shard
of the last dim would cut a block, the update (and the moments' storage)
moves that mesh axis to the first leading dim it divides (after the
axes already sharding it), else replicates it; and the scales ``s`` follow ``q``'s last dim where ``q``'s
shards hold whole blocks (``moment_specs``), where ``opt_state_specs``
replicates them.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

from torch.distributed.tensor import DTensor, Replicate, Shard

Spec = Tuple[Any, ...]

#: elements of an int8 moment's quantization block (``quantized_state``)
QBLOCK = 256


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, of a DeviceMesh or such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: Tuple[str, ...]          # e.g. ("pod", "data") or ("data",)
    model: str                   # "model"

    @staticmethod
    def from_mesh(mesh) -> "MeshAxes":
        names = tuple(axis_sizes(mesh))
        assert "model" in names, names
        dp = tuple(n for n in names if n != "model")
        return MeshAxes(dp=dp, model="model")


# base spec per leaf name: tuple of roles, one per base dim.
#   "fsdp"  -> sharded over dp axes (ZeRO-3 param shard)
#   "model" -> sharded over model axis (TP / EP / vocab)
#   None    -> replicated
_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / heads
    "embed": ("model", "fsdp"),
    "lm_head": ("fsdp", "model"),
    "frame_proj": (None, "fsdp"),
    "patch_proj": (None, "fsdp"),
    "mask_embed": (None,),
    # attention (dense / GQA)
    "wq": ("fsdp", "model"),
    "wk": ("fsdp", "model"),
    "wv": ("fsdp", "model"),
    "wo": ("model", "fsdp"),
    # MLA (lora ranks kept replicated; fused head dims column-parallel)
    "wq_a": ("fsdp", None),
    "wq_b": ("fsdp", "model"),
    "wkv_a": ("fsdp", None),
    "wk_b": ("fsdp", "model"),
    "wv_b": ("fsdp", "model"),
    "q_norm": (None,),
    "kv_norm": (None,),
    # MLP
    "w_up": ("fsdp", "model"),
    "w_gate": ("fsdp", "model"),
    "w_down": ("model", "fsdp"),
    # MoE (3D expert weights; detected by the path)
    "router": ("fsdp", None),
    # mamba2
    "w_in": ("fsdp", "model"),
    "conv_w": (None, "model"),
    "A_log": (None,),
    "D": (None,),
    "dt_bias": (None,),
    "norm": ("model",),
    "w_out": ("model", "fsdp"),
    # xlstm
    "w_if": ("fsdp", None),
    "r_gates": (None, None, None),
    "w_gates": ("fsdp", "model"),
    "w_ff_gate": ("fsdp", "model"),
    "w_ff_up": ("fsdp", "model"),
    "w_ff_down": ("model", "fsdp"),
    "out_norm": ("model",),
    # norms
    "scale": (None,),
    "bias": (None,),
}

_MOE_EXPERT_RULES = {           # (E, d, ff) / (E, ff, d): EP over model
    "w_up": ("model", "fsdp", None),
    "w_gate": ("model", "fsdp", None),
    "w_down": ("model", None, "fsdp"),
}


def _leaf_name(keys) -> str:
    """The last dict key of a leaf's path (a tuple index is no name)."""
    for k in reversed(keys):
        if isinstance(k, str):
            return k
    return ""


def _map_with_path(fn, tree, keys=()):
    """``fn(keys, leaf)`` over a nested dict (and the tuples of a cache)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, keys + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map_with_path(fn, v, keys + (i,))
                     for i, v in enumerate(tree))
    return fn(keys, tree)


def _dict_leaves(tree, keys=()):
    """(keys, leaf) of a nested dict's leaves (a spec tuple is a leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _dict_leaves(v, keys + (k,))
    else:
        yield keys, tree


def _dp_size(axes: MeshAxes, sizes: Dict[str, int]) -> int:
    return math.prod(sizes[a] for a in axes.dp)


def _roles_to_spec(roles, shape, axes: MeshAxes, mesh,
                   no_tp: bool = False) -> Spec:
    """Resolve role names to mesh axes, honoring divisibility.  With
    ``no_tp`` the model axis is folded into dp (small models: pure ZeRO-3
    data parallelism, no tensor parallelism)."""
    sizes = axis_sizes(mesh)
    dp_size = _dp_size(axes, sizes)
    spec = []
    for role, dim in zip(roles, shape):
        if no_tp and role == "model":
            role = None
        if role == "fsdp" and dim % dp_size == 0:
            spec.append(axes.dp if len(axes.dp) > 1 else axes.dp[0])
        elif role == "model" and dim % sizes[axes.model] == 0:
            spec.append(axes.model)
        else:
            spec.append(None)
    return tuple(spec)


def param_specs(params_abstract, mesh, axes: Optional[MeshAxes] = None,
                no_tp: bool = False):
    """Spec tree mirroring ``params_abstract`` (anything with ``.shape``)."""
    axes = axes or MeshAxes.from_mesh(mesh)

    def spec_for(keys, leaf):
        name = _leaf_name(keys)
        ndim = len(leaf.shape)
        if name in _MOE_EXPERT_RULES and "moe" in keys \
                and "shared" not in keys:
            stack = ndim - 3
            return (None,) * stack + _roles_to_spec(
                _MOE_EXPERT_RULES[name], leaf.shape[stack:], axes, mesh,
                no_tp)
        roles = _RULES.get(name)
        if roles is None:
            return ()
        stack = ndim - len(roles)
        if stack < 0:
            return ()
        return (None,) * stack + _roles_to_spec(roles, leaf.shape[stack:],
                                                axes, mesh, no_tp)

    return _map_with_path(spec_for, params_abstract)


# ------------------------------------------ tensor and expert parallelism

#: the leaves of a Mamba2 sublayer whose heads compute sharded of which a
#: rank computes only its share: ``w_in``'s fused columns ``[z, x, B, C,
#: dt]`` and ``conv_w``'s channels ``[x, B, C]`` are cut by the plan into
#: contiguous chunks that do not line up with heads, and B and C are
#: needed whole by every head, so a rank brings only its heads' columns
#: and the whole B and C (``EXCHANGED``); the gated norm's ``norm`` is
#: gathered whole, for the norm over all of ``d_inner``
#: (``models.ssm``); ``A_log``, ``D`` and ``dt_bias`` are replicated by
#: the plan.  Its ``w_out``, whose rows are head-aligned, comes back as
#: the rank's model shard.
MAMBA_SLICED = ("w_in", "conv_w", "norm", "A_log", "D", "dt_bias")

#: the leaves of an MLA attention whose heads compute sharded that every
#: rank of a model column holds whole, as the plan replicates them over
#: ``model``: the query and KV down-projections and their norms give
#: ``cq``, ``c_kv`` and ``k_rope``, which every head reads whole.  Each
#: rank computes them whole and uses them for its heads only, so their
#: gradients are each rank's part, summed over the column
#: (``TPLayout.partial``).  ``wq_b``, ``wk_b`` and ``wv_b``, whose
#: columns are head-major, and ``wo``, whose rows are, come back as the
#: rank's model shard: the plan's contiguous chunks are whole heads.
MLA_WHOLE = ("wq_a", "q_norm", "wkv_a", "kv_norm")

#: the leaves of an mLSTM sublayer whose heads compute sharded of which a
#: rank computes only its share (``ssm.mlstm_columns``): ``w_up``'s
#: columns ``[xm, z]`` (every head reads all of ``xm``, so a rank
#: computes it and the conv whole, and brings all of ``xm`` and its
#: heads' ``z``, ``EXCHANGED``), ``conv_w`` and the output norm's
#: ``out_norm``, gathered whole for the conv and the norm over all of
#: ``inner``, and ``w_if`` (replicated by the plan; the rank takes its
#: heads' ``i`` and ``f`` columns).  Its ``wq``, ``wk`` and ``wv``, whose
#: columns are head-major, and ``w_down``, whose rows are, come back as
#: the rank's model shard.
MLSTM_SLICED = ("w_up", "conv_w", "w_if", "out_norm")

#: the leaves of an sLSTM sublayer whose heads compute sharded of which a
#: rank computes only its share (``ssm.slstm_columns``): ``w_gates``,
#: whose columns ``[z, i, f, o]`` the plan cuts by gate and not by head
#: (a rank brings its heads' columns of each gate, ``EXCHANGED``), and
#: ``r_gates`` (replicated by the plan, block-diagonal by head).  Its
#: ``out_norm`` is gathered whole and used whole and alike on every
#: rank, after the heads' ``h`` is joined (``shard_ctx.gather_out``).
SLSTM_SLICED = ("w_gates", "r_gates")

#: the leaves of ``MAMBA_SLICED``, ``MLSTM_SLICED`` and ``SLSTM_SLICED``
#: that a rank brings only the columns of (their last dim) that its heads
#: compute with, by (sublayer, name), where the plan shards them over
#: ``model``: ``shard_ctx.full`` exchanges the columns between the ranks
#: of the model column (``TPLayout.exchange``) instead of gathering the
#: leaf whole
EXCHANGED = (("mamba", "w_in"), ("mamba", "conv_w"), ("mlstm", "w_up"),
             ("slstm", "w_gates"))

#: the sLSTM's feed-forward leaves: they compute sharded (kind
#: "slstm_ff") where the plan shards them, the feed-forward width
#: ``int(4 / 3 d)`` dividing by M
SLSTM_FF = ("w_ff_gate", "w_ff_up", "w_ff_down")


def _sliced(keys, kinds) -> bool:
    """Whether the param leaf at path ``keys`` is gathered whole while
    each rank computes only its share of it (``TPLayout.partial``)."""
    name = _leaf_name(keys)
    return (("mamba" in kinds and "mamba" in keys and name in MAMBA_SLICED)
            or ("attn" in kinds and "attn" in keys and name in MLA_WHOLE)
            or ("mlstm" in kinds and "mlstm" in keys
                and name in MLSTM_SLICED)
            or ("slstm" in kinds and "slstm" in keys
                and name in SLSTM_SLICED))


def _exchanged(keys) -> Optional[Tuple[str, str]]:
    """The (sublayer, name) of ``EXCHANGED`` the param leaf at path
    ``keys`` is, or None."""
    name = _leaf_name(keys)
    for sub, n in EXCHANGED:
        if sub in keys and name == n:
            return sub, n
    return None


def exchange_columns(cfg, sub: str, name: str, M: int):
    """For each rank of a model column of M, the columns of the
    ``EXCHANGED`` leaf (``sub``, ``name``) that its heads compute with,
    ascending (``ssm.mamba_columns``, ``mlstm_columns``,
    ``slstm_columns``, the one definition of them)."""
    from repro_torch.models import ssm

    def of(r):
        if sub == "mamba":
            cols, chans = ssm.mamba_columns(cfg.ssm, cfg.d_model, M, r)
            return cols if name == "w_in" else chans
        if sub == "mlstm":
            return ssm.mlstm_columns(cfg.d_model, cfg.xlstm, M, r)[0]
        return ssm.slstm_columns(cfg.d_model, cfg.xlstm, M, r)

    out = tuple(tuple(of(r)) for r in range(M))
    assert all(list(c) == sorted(c) for c in out), (sub, name)
    return out


def _tp_kind(keys) -> Optional[str]:
    """What a param leaf at path ``keys`` computes under tensor or expert
    parallelism: "vocab" (the embedding and the LM head), "attn" (a
    GQA or MLA attention's projections), "mlp", "shared" (a MoE layer's
    shared expert), "experts", "mamba" (a Mamba2 sublayer's leaves the
    plan puts on ``model``: ``w_in``, ``conv_w``, ``norm``, ``w_out``),
    "mlstm" (an mLSTM sublayer's: ``w_up``, ``conv_w``, ``wq``, ``wk``,
    ``wv``, ``out_norm``, ``w_down``), "slstm" (an sLSTM sublayer's
    ``w_gates``), "slstm_ff" (its feed-forward, ``SLSTM_FF``); None for
    a leaf every rank uses whole (norms, the router, the frontends'
    stubs, Mamba2's replicated ``A_log``, ``D``, ``dt_bias``, the
    xLSTM's replicated ``w_if`` and ``r_gates``, the sLSTM's
    ``out_norm``)."""
    name = _leaf_name(keys)
    if len(keys) == 1 and name in ("embed", "lm_head"):
        return "vocab"
    if name in _MOE_EXPERT_RULES and "moe" in keys:
        return "shared" if "shared" in keys else "experts"
    if "attn" in keys:
        return "attn"
    if "mlp" in keys and name in _MOE_EXPERT_RULES:
        return "mlp"
    if "mamba" in keys and name in ("w_in", "conv_w", "norm", "w_out"):
        return "mamba"
    if "mlstm" in keys and name in ("w_up", "conv_w", "wq", "wk", "wv",
                                    "out_norm", "w_down"):
        return "mlstm"
    if "slstm" in keys and name == "w_gates":
        return "slstm"
    if "slstm" in keys and name in SLSTM_FF:
        return "slstm_ff"
    return None


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """What a block computes sharded over ``model`` (item 8d), from
    ``tp_layout``.  ``model``: M, the model axis's size.  ``kinds``: the
    leaf kinds (``_tp_kind``) each rank holds and computes a 1/M share
    of.  ``leaves``: the param paths of those kinds (``flatten``'s, the
    stack dims dropped) that ``shard_ctx.full`` gathers over the data
    axes only, handing each rank its ``model`` shard.  ``partial``: the
    paths of which a rank computes only its share (a Mamba2 sublayer's
    ``MAMBA_SLICED``, an MLA attention's ``MLA_WHOLE``, the xLSTM's
    ``MLSTM_SLICED`` and ``SLSTM_SLICED``).  ``exchange``: those of them
    (``EXCHANGED``, at M > 1, where the plan shards them over ``model``)
    whose columns ``full`` brings a rank only as its heads compute with,
    each path's columns for every rank of the model column
    (``exchange_columns``); their gradients go back to the ranks owning
    the columns.  The other paths of ``partial`` are gathered whole, so
    their gradients are each rank's part, summed over the model column.
    ``heads``: the (query, kv) heads a rank's attention computes (the
    xLSTM's: its mLSTM and sLSTM heads, twice).  ``kept``: the rules
    that kept a part in 8a's layout (gathered whole over ``model``, every
    rank of a model column computing it whole).  ``bytes_top`` and
    ``bytes_groups``: the bytes ``full`` brings over ``model`` in one
    forward, for the leaves outside the stack and the groups' leaves
    (the hybrid's shared block once a group): a leaf gathered whole over
    ``model`` (kept, or in ``partial``) brings the (M - 1) / M of it the
    other ranks hold, an exchanged one the columns a rank needs that
    its own chunk lacks, for the rank that receives the most.
    ``exchange_in`` and ``exchange_back``: for each rank of the model
    column, the bytes the exchange brings it in one forward (its needed
    columns held by the other ranks) and in one backward (the gradients
    of its own columns that the other ranks computed with);
    ``exchange_whole``: what one forward would bring had the exchanged
    leaves been gathered whole.  ``group_bytes``: the bytes of one
    group's leaves a rank holds once ``full`` has brought them (the
    hybrid's shared block among them; the rank that holds the most),
    beside ``group_bytes_whole``, the group whole, as 8a gathers it."""
    model: int
    kinds: frozenset
    leaves: frozenset
    heads: Tuple[int, int]
    kept: Tuple[str, ...]
    bytes_top: int
    bytes_groups: int
    group_bytes: int
    group_bytes_whole: int
    partial: frozenset
    exchange: Dict[str, Tuple[Tuple[int, ...], ...]]
    exchange_in: Tuple[int, ...]
    exchange_back: Tuple[int, ...]
    exchange_whole: int

    def computes(self, kind: str) -> bool:
        return kind in self.kinds

    def step_bytes(self, n_micro: int = 1, remat: bool = False,
                   backward: bool = False, rank: Optional[int] = None) -> int:
        """The bytes ``full`` brings over ``model`` in a step of
        ``n_micro`` forwards (a train step's microbatches; 1 for a
        prefill or a decode step) to rank ``rank`` of the model column,
        by default to the rank that receives the most; with ``remat``
        the groups are brought again in the backward; with ``backward``
        each microbatch's backward sends the exchanged leaves' gradient
        columns back to their owners."""
        if rank is None:
            return max(self.step_bytes(n_micro, remat, backward, r)
                       for r in range(self.model))
        groups = (self.bytes_groups - max(self.exchange_in)
                  + self.exchange_in[rank])
        return n_micro * (self.bytes_top + groups * (2 if remat else 1)
                          + (self.exchange_back[rank] if backward else 0))

    def step_bytes_whole(self, n_micro: int = 1, remat: bool = False,
                         backward: bool = False) -> int:
        """``step_bytes`` had the exchanged leaves been gathered whole, as
        the port gathered them before the exchange; with ``backward``
        their gradients reduce-scattered over the model column once a
        microbatch, (M - 1) / M of each coming to a rank."""
        groups = (self.bytes_groups - max(self.exchange_in)
                  + self.exchange_whole)
        return n_micro * (self.bytes_top + groups * (2 if remat else 1)
                          + (self.exchange_whole if backward else 0))

    def summary(self) -> Dict[str, Any]:
        """The layout as the launchers and ``chip_smoke.py`` print it."""
        return {"model": self.model, "heads": list(self.heads),
                "sharded": sorted(self.kinds), "kept_8a": list(self.kept)}


def tp_layout(cfg, mesh, paged: bool = False) -> TPLayout:
    """The layout rule of tensor parallelism (TP: heads, MLP widths,
    Mamba2 heads and the vocabulary) and expert parallelism (EP: the MoE
    experts) over ``model``, in one place:

    * a GQA attention computes sharded only where ``n_heads`` and
      ``n_kv_heads`` both divide by M: a rank cannot run attention on
      part of a head, though the plan shards the fused ``H * hd`` dim
      wherever it divides; else its leaves are gathered whole over
      ``model`` (rule "heads");
    * an MLA attention computes sharded where ``n_heads`` H divides by
      M, each rank its H / M heads (``MLA_WHOLE`` says which leaves it
      gathers whole); else every rank computes all of it (rule "mla:
      heads", naming H and M);
    * a Mamba2 sublayer computes sharded where its head count H =
      ``d_inner / head_dim`` divides by M, each rank its H / M heads
      (``MAMBA_SLICED`` says which leaves it brings whole and which only
      as its heads' columns); else every rank computes all of it (rule
      "mamba", naming H and M);
    * the xLSTM's mLSTM and sLSTM sublayers compute sharded where its
      ``n_heads`` H divides by M, each rank its H / M heads
      (``MLSTM_SLICED`` and ``SLSTM_SLICED`` say which leaves it brings
      whole and which only as its heads' columns); else every rank
      computes all of them (rule "xlstm: heads", naming H and M).  A
      leaf of ``EXCHANGED`` whose columns do not divide by M is
      replicated by the plan (``_roles_to_spec``): every rank holds it
      whole, brings nothing over ``model`` and takes its columns.  The
      sLSTM's feed-forward is a
      region of its own, sharded where its width divides by M (rule
      "slstm_ff" where it does not);
    * the MLP, a MoE layer's shared expert, the vocabulary (embedding
      and LM head) and the experts compute sharded where their dim
      divides by M, as ``_roles_to_spec`` decides (rules "mlp",
      "shared", "vocab", "experts" where it does not);
    * these keep 8a's layout, each a named rule: the paged serve plane
      ("paged": its rounds run with no sharding context), and the frame
      and patch stubs ("frontend": never sharded over ``model``).

    The hybrid's shared attention block and its MLP compute sharded by
    the attention's and the MLP's rules.  The plan's specs are the
    reference's whatever this says; a leaf computes sharded only where
    its spec puts ``model`` on a dim."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.transformer import n_groups
    sizes = axis_sizes(mesh)
    M = sizes["model"]
    a, moe = cfg.attention, cfg.moe
    kinds, kept = set(), []
    H_m = 0
    if cfg.ssm is not None:
        H_m = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    if paged:
        kept.append("paged")
    else:
        dims = {"mlp": cfg.d_ff, "vocab": cfg.vocab_size}
        if cfg.xlstm is not None:
            dims["slstm_ff"] = int(cfg.d_model * 4 / 3)
        if moe is not None:
            dims["experts"] = moe.n_experts
            if moe.n_shared:
                dims["shared"] = moe.n_shared * moe.shared_ff
        for kind, n in dims.items():
            if n and n % M == 0:
                kinds.add(kind)
            elif n:
                kept.append(f"{kind}: {n} % {M}")
        if cfg.xlstm is not None and cfg.xlstm.n_heads % M:
            kept.append(f"xlstm: heads {cfg.xlstm.n_heads} % {M}")
        elif cfg.xlstm is not None:             # no attention
            kinds.update(("mlstm", "slstm"))
        elif a.is_mla and a.n_heads % M:
            kept.append(f"mla: heads {a.n_heads} % {M}")
        elif a.is_mla:
            kinds.add("attn")
        elif a.n_heads % M or a.n_kv_heads % M:
            kept.append(f"heads: {a.n_heads}/{a.n_kv_heads} % {M}")
        else:
            kinds.add("attn")
        if H_m and H_m % M:
            kept.append(f"mamba: {H_m} % {M}")
        elif H_m:
            kinds.add("mamba")
    if cfg.frontend in ("frame", "patch"):
        kept.append(f"frontend: {cfg.frontend}")
    if cfg.xlstm is not None:
        H = cfg.xlstm.n_heads
        heads = (H // M, H // M) if "mlstm" in kinds else (H, H)
    else:
        heads = (0, 0) if a is None else (
            (a.n_heads // M, a.n_kv_heads // M) if "attn" in kinds
            else (a.n_heads, a.n_kv_heads))

    params = model_lib.abstract_params(cfg)
    specs = dict(_dict_leaves(param_specs(params, mesh)))
    ng = n_groups(cfg)
    leaves, partial, exchange = set(), set(), {}
    top, groups, group, whole = 0, 0, [0] * M, 0
    ex_in, ex_back, ex_whole = [0] * M, [0] * M, 0
    for keys, leaf in _dict_leaves(params):
        path = "/".join(keys)
        on_model = "model" in [x for e in specs[keys] for x in _axes_of(e)]
        kind = _tp_kind(keys[1:] if keys[0] == "layers" else keys)
        nbytes = leaf.numel() * leaf.element_size()
        sliced = _sliced(keys, kinds)
        if sliced:
            partial.add(path)
        ex = _exchanged(keys) if sliced and on_model and M > 1 else None
        if ex is not None:
            assert keys[0] == "layers", path
            cols = exchange[path] = exchange_columns(cfg, *ex, M)
            chunk = leaf.shape[-1] // M
            col = nbytes // leaf.shape[-1]      # a column, every group's
            for r, need in enumerate(cols):
                # the columns r needs that rank s holds, and their
                # gradients back to s
                owners = collections.Counter(c // chunk for c in need)
                for s, n in owners.items():
                    if s != r:
                        ex_in[r] += n * col
                        ex_back[s] += n * col
                group[r] += len(need) * col // ng
            ex_whole += nbytes * (M - 1) // M
            whole += nbytes // ng
            continue
        if keys[0] in ("layers", "extra"):
            one = nbytes // ng if keys[0] == "layers" else nbytes
            whole += one
            group = [g + (one // M if kind in kinds and not sliced else one)
                     for g in group]
        if kind in kinds and not sliced:
            assert on_model, (path, specs[keys])
            leaves.add(path)
            continue
        if not on_model or M == 1:
            continue
        brought = nbytes * (M - 1) // M
        if keys[0] == "layers":
            groups += brought
        elif keys[0] == "extra":        # applied by every group
            groups += brought * ng
        else:
            top += brought * (2 if path == "embed" and cfg.tie_embeddings
                              else 1)
    return TPLayout(model=M, kinds=frozenset(kinds),
                    leaves=frozenset(leaves), heads=heads, kept=tuple(kept),
                    bytes_top=top, bytes_groups=groups + max(ex_in),
                    group_bytes=max(group), group_bytes_whole=whole,
                    partial=frozenset(partial), exchange=exchange,
                    exchange_in=tuple(ex_in), exchange_back=tuple(ex_back),
                    exchange_whole=ex_whole)


def batch_specs(batch_abstract, mesh, axes: Optional[MeshAxes] = None):
    """Shard every batch leaf on its leading (global-batch) dim over dp."""
    axes = axes or MeshAxes.from_mesh(mesh)
    dp_size = _dp_size(axes, axis_sizes(mesh))
    dp = axes.dp if len(axes.dp) > 1 else axes.dp[0]

    def spec_for(keys, leaf):
        shape = tuple(leaf.shape)
        if shape and shape[0] % dp_size == 0:
            return (dp,) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    return _map_with_path(spec_for, batch_abstract)


def cache_specs(cache_abstract, cfg, mesh, axes: Optional[MeshAxes] = None,
                batch_size: int = 0):
    """KV/state caches: batch over dp when divisible, else sequence over dp
    (long-context B=1 decode); kv-heads/channels over model when divisible.

    Cache leaves all carry a leading (n_groups[, n_sub]) stack; the batch dim
    is located per leaf name."""
    axes = axes or MeshAxes.from_mesh(mesh)
    sizes = axis_sizes(mesh)
    dp_size = _dp_size(axes, sizes)
    model_size = sizes[axes.model]
    dp = axes.dp if len(axes.dp) > 1 else axes.dp[0]

    # per leaf name: (batch_dim_from_end, seq_dim_from_end or None,
    #                 model_dim_from_end or None)
    layout = {
        "k": (4, 3, 2), "v": (4, 3, 2),            # (..., B, S, Hkv, D)
        "c_kv": (3, 2, None), "k_rope": (3, 2, None),   # (..., B, S, R)
        "conv": (3, None, 1),                      # (..., B, W-1, C)
        "ssm": (4, None, 3),                       # (..., B, H, P, N)
    }

    def spec_for(keys, leaf):
        name = _leaf_name(keys)
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        lay = layout.get(name)
        if lay is None:
            # xlstm/slstm tuple states: shard the batch dim if any dim ==
            # batch_size and divisible
            for i, d in enumerate(shape):
                if batch_size and d == batch_size and d % dp_size == 0:
                    spec[i] = dp
                    break
            return tuple(spec)
        b_i, s_i, m_i = lay
        if b_i is not None and nd - b_i >= 0 and \
                shape[nd - b_i] % dp_size == 0:
            spec[nd - b_i] = dp
        elif s_i is not None and shape[nd - s_i] % dp_size == 0:
            spec[nd - s_i] = dp    # sequence-shard the cache (B==1 long ctx)
        if m_i is not None and shape[nd - m_i] % model_size == 0:
            spec[nd - m_i] = axes.model
        return tuple(spec)

    return _map_with_path(spec_for, cache_abstract)


#: top-level cache keys whose leaves are stacked twice, (n_groups, n_sub,
#: batch, ...): the hybrid's Mamba2 and the xlstm's mLSTM sublayers
_SUB_STACKED = ("mamba", "mlstm")


def cache_batch_dim(keys) -> int:
    """The batch dim of the cache leaf at path ``keys``: after the group
    stack, and the sublayer stack under ``_SUB_STACKED``."""
    return 2 if keys and keys[0] in _SUB_STACKED else 1


def cache_layouts(cache_abstract, mesh, axes: Optional[MeshAxes] = None,
                  split: bool = True, tp: Optional[TPLayout] = None,
                  seq: bool = False):
    """A dense serve block's cache on its mesh: a ``Layout`` for every
    leaf of the cache tree (its dicts and tuples kept).

    * The batch dim over dp when the batch's rows split over the data
      ranks (``split``); else, with ``seq``, the sequence dim of the GQA
      ``k`` and ``v`` leaves and of MLA's compressed ``c_kv`` and
      ``k_rope`` over dp, each rank holding a slice of the positions
      (the reference's ``cache_specs`` for a batch that does not split,
      "B==1 long ctx"; ``ShardCtx.seq_split``); else whole.
    * Over ``model``, where ``tp`` computes the part sharded (the model
      dims of ``cache_specs``): the kv heads of ``k`` and ``v`` (each
      rank holding its heads' rows), and the heads of the Mamba2
      ``ssm`` state.
    * The Mamba2 ``conv`` state departs: ``cache_specs`` cuts its
      channels into contiguous chunks, which do not line up with heads,
      and a rank computing its heads needs their ``x`` channels and the
      whole ``B`` and ``C``; so a rank holds those
      (``ssm.mamba_columns``), and its layout here is the whole
      leaf over ``model``, the checkpoint's: ``transformer.conv_whole``
      joins the ranks' channels for a save, and a restore cuts them.

    * The xLSTM's recurrent states depart too, where ``tp`` computes
      its heads sharded: a rank holds its heads' rows of the mLSTM's
      ``(C, n, m)`` and of the sLSTM's ``(h, c, n, m)`` (the head dim
      after the batch), where ``cache_specs`` holds them by batch only;
      and the mLSTM's ``conv`` tail whole, every rank computing all of
      its channels, where ``cache_specs`` cuts them over ``model``.
      Heads are contiguous rows, so a save joins them whole and a
      restore cuts them again through these layouts.

    Every other dim is whole: without ``tp``, every rank of a model
    column holds the whole leaf (8a's layout); MLA's compressed cache
    has no head dim, so every rank of a model column holds its data
    slice of it whole (the reference's spec puts no model axis on
    it)."""
    axes = axes or MeshAxes.from_mesh(mesh)
    dp = axes.dp if len(axes.dp) > 1 else axes.dp[0]
    heads = tp is not None and tp.computes("attn")
    mamba = tp is not None and tp.computes("mamba")
    xlstm = tp is not None and tp.computes("mlstm")

    def layout_for(keys, leaf):
        spec = [None] * len(leaf.shape)
        name = _leaf_name(keys)
        if split:
            spec[cache_batch_dim(keys)] = dp
        elif seq and name in ("k", "v"):
            spec[-3] = dp                   # (..., B, S, Hkv, D)
        elif seq and name in ("c_kv", "k_rope"):
            spec[-2] = dp                   # (..., B, S, R)
        if heads and name in ("k", "v"):
            spec[-2] = axes.model
        if mamba and name == "ssm":
            spec[-3] = axes.model           # (..., B, H, P, N)
        if xlstm and name in ("mlstm", "slstm"):
            spec[cache_batch_dim(keys) + 1] = axes.model    # (..., B, H..)
        return Layout(mesh, to_placements(tuple(spec), mesh))

    return _map_with_path(layout_for, cache_abstract)


def seq_splits(cfg, batch: int, smax: int, dp: int) -> bool:
    """Whether a dense serve block's cache holds its sequence over the
    data ranks: its batch does not split over the ``dp`` data ranks, its
    ``smax`` positions do, and it has an attention cache, GQA's
    ``k``/``v`` or MLA's ``c_kv``/``k_rope`` (the reference's
    ``cache_specs`` rule; the xlstm's recurrent states have no
    positions)."""
    return (dp > 1 and batch % dp != 0 and smax % dp == 0
            and cfg.family != "xlstm" and not cfg.is_encoder
            and cfg.attention is not None)


def _is_q(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"q", "s"}


def _zip_map(fn, moments, specs):
    if _is_q(moments) or not isinstance(moments, dict):
        return fn(moments, specs)
    return {k: _zip_map(fn, moments[k], specs[k]) for k in moments}


def opt_state_specs(opt_abstract, param_spec_tree):
    """Specs for an optimizer-state tree: m/v mirror their params; int8
    quantized states {"q","s"} give q the param spec and s the param spec
    with the (blocked) last dim replicated."""

    def moment_spec(mleaf, pspec):
        if _is_q(mleaf):
            nd = len(mleaf["q"].shape)
            entries = list(pspec) + [None] * (nd - len(pspec))
            s_spec = tuple(entries[:-1]) + (None,) if nd else ()
            return {"q": pspec, "s": s_spec}
        return pspec

    return {"m": _zip_map(moment_spec, opt_abstract["m"], param_spec_tree),
            "v": _zip_map(moment_spec, opt_abstract["v"], param_spec_tree),
            "step": ()}


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(spec: Spec, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where tensor dim ``d``'s
    entry names that axis, else ``Replicate()``."""
    out = []
    for name in axis_sizes(mesh):
        dims = [d for d, e in enumerate(spec) if name in _axes_of(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, e in enumerate(spec):
        for a in _axes_of(e):
            assert out[d] % sizes[a] == 0, (shape, spec, sizes)
            out[d] //= sizes[a]
    return tuple(out)


def update_spec(pspec: Spec, shape, mesh) -> Spec:
    """The spec an int8-moment leaf is updated (and its moments stored)
    in: ``pspec``, unless the shard of the last dim would cut a
    quantization block; then each axis sharding the last dim moves to the
    first leading dim it divides (after the axes already there), or is
    dropped (that part replicated)."""
    nd = len(shape)
    if nd == 0:
        return pspec
    spec = list(pspec) + [None] * (nd - len(pspec))
    if not _axes_of(spec[-1]):
        return tuple(pspec)
    if local_shape(shape, tuple(spec), mesh)[-1] % QBLOCK == 0:
        return tuple(pspec)
    sizes = axis_sizes(mesh)
    moved = list(spec[:-1]) + [None]
    for a in _axes_of(spec[-1]):
        for d in range(nd - 1):
            have = _axes_of(moved[d])
            if shape[d] % (math.prod(sizes[x] for x in have) * sizes[a]):
                continue
            order = list(sizes)         # mesh order, as DTensor nests
            moved[d] = (tuple(sorted(have + (a,), key=order.index))
                        if have else a)
            break
    return tuple(moved)


def scale_spec(qspec: Spec, shape, mesh) -> Spec:
    """The scales' spec beside ``q``'s: the leading dims as ``q``'s, the
    block dim sharded as ``q``'s last dim where its shards hold whole
    blocks (a replicated block dim otherwise)."""
    nd = len(shape)
    if nd == 0:
        return ()
    spec = list(qspec) + [None] * (nd - len(qspec))
    last = spec[-1]
    if _axes_of(last) and local_shape(shape, tuple(spec), mesh)[-1] \
            % QBLOCK:
        last = None
    return tuple(spec[:-1]) + (last,)


def moment_specs(params_abstract, param_spec_tree, mesh,
                 state_bits: Optional[int]):
    """The port's storage specs of the optimizer state: fp32 moments as
    their params; int8 ones as ``update_spec`` and ``scale_spec`` give
    them (see the module docstring)."""

    def moment(p, pspec):
        if state_bits != 8:
            return pspec
        q = update_spec(pspec, p.shape, mesh)
        return {"q": q, "s": scale_spec(q, p.shape, mesh)}

    tree = _zip_map(moment, params_abstract, param_spec_tree)
    return {"m": tree, "v": tree, "step": ()}


# ------------------------------------------------- placements on a mesh

def placement_index(shape, placements, mesh):
    """The slices of a whole leaf this rank holds under ``placements`` on
    the DeviceMesh ``mesh`` (even shards; mesh dims split in order, the
    first outermost, as DTensor lays them out)."""
    coord = mesh.get_coordinate()
    sizes = mesh.mesh.shape
    lo, ext = [0] * len(shape), list(shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d = pl.dim
            assert ext[d] % sizes[i] == 0, (shape, placements)
            ext[d] //= sizes[i]
            lo[d] += coord[i] * ext[d]
    return tuple(slice(a, a + e) for a, e in zip(lo, ext))


@dataclasses.dataclass(frozen=True)
class Layout:
    """A leaf's place on a mesh: the DeviceMesh and one placement per
    mesh dim (``to_placements``)."""
    mesh: Any
    placements: tuple

    def index(self, shape):
        return placement_index(shape, self.placements, self.mesh)

    def local_shape(self, shape) -> Tuple[int, ...]:
        return tuple(s.stop - s.start for s in self.index(shape))

    def wrap(self, local):
        """The DTensor whose shard on this rank is ``local``."""
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False)

    def shard(self, full):
        """This rank's DTensor of a whole tensor ``full``."""
        return self.wrap(full[self.index(full.shape)].contiguous())


def layouts(spec_tree, mesh):
    """``Layout`` over a spec tree."""
    if isinstance(spec_tree, dict):
        return {k: layouts(v, mesh) for k, v in spec_tree.items()}
    return Layout(mesh, to_placements(spec_tree, mesh))


def state_layouts(params_abstract, mesh, axes: Optional[MeshAxes] = None,
                  *, train: bool = True, state_bits: Optional[int] = None,
                  no_tp: bool = False):
    """A block's sharded state as a ``Layout`` tree: the params as the
    plan shards them (``param_specs``) and, for a train block, the
    moments as ``moment_specs`` (the step counter whole, ``None``)."""
    p_spec = param_specs(params_abstract, mesh, axes, no_tp=no_tp)
    if not train:
        return {"params": layouts(p_spec, mesh)}
    opt = moment_specs(params_abstract, p_spec, mesh, state_bits)
    lay = layouts({"params": p_spec, "opt": opt}, mesh)
    lay["opt"]["step"] = None
    return lay
