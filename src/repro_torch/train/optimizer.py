"""AdamW over bf16 params with fp32 *or* block-quantized int8 moments,
global-norm clipping and a warmup+cosine schedule (the port of
``repro.train.optimizer``).

With ``state_bits=8`` the m/v trees hold {"q": int8, "s": f32} leaves (see
``quantized_state``), cutting optimizer memory 4x; deepseek_7b's full
state fits one 80 GB card only that way.

``apply`` updates the params and the moments IN PLACE (the reference
returns new trees, which XLA donates) and returns the same objects.

Under a block of several devices the params, grads and moments are
DTensors: ``init`` builds each rank's moment shards in the plan's
placements (``init(..., layouts=)``), ``global_norm`` sums each leaf's
local squares and adds them over the mesh dims the leaf is sharded on
only (a leaf replicated over ``model`` counts once), and ``apply`` runs
the fused AdamW kernel on each rank's local shards.  A leaf whose int8
moments are stored in another layout than the param
(``plans.update_spec``: a shard of the last dim that would cut a
quantization block) has its param and grad moved to that layout for the
update and the param moved back.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.train import quantized_state as qs


@dataclasses.dataclass(frozen=True)
class OptConfig:
    """The reference's fields, so configs move across unchanged.

    ``fused`` picks ``kernels.ops.fused_adamw``'s impl ("auto", "kernel",
    "torch"); "off", the reference's composed ``_adam_leaf``, runs the
    same plain version as "torch" (``kernels.fused_adamw.fused_adamw_torch``,
    the one copy of the update's arithmetic).  ``scan_stacked`` and ``scan_min_ndim``
    are accepted and ignored: the reference's ``lax.map`` over the layer
    stack bounds the optimizer's temporaries to one layer slice, and the
    in-place kernel makes no temporaries to bound.
    """
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_bits: Optional[int] = None     # None = fp32 moments; 8 = int8
    scan_stacked: bool = True            # ignored (class docstring)
    scan_min_ndim: int = 3               # ignored (class docstring)
    fused: str = "auto"


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def _tree_map(fn, tree):
    return {k: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def init(params, cfg: Optional[OptConfig] = None,
         layouts=None) -> Dict[str, Any]:
    """Fresh moments for ``params``.  ``layouts``: the moments'
    ``plans.Layout`` tree (``{"m", "v"}`` of ``plans.moment_specs``) when
    the params are DTensors; each rank then holds its shards."""
    cfg = cfg or OptConfig()
    if cfg.state_bits == 8:
        zeros = qs.zeros_like_quantized
    else:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = _local(next(iter(_leaves(params)))).device
    if layouts is None:
        m, v = _tree_map(zeros, params), _tree_map(zeros, params)
    else:
        m = _sharded_zeros(zeros, params, layouts["m"], device)
        v = _sharded_zeros(zeros, params, layouts["v"], device)
    return {"m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _sharded_zeros(zeros, params, layouts, device):
    """Each param's fresh moment as DTensors in ``layouts``: the local
    shards of ``zeros`` of the whole leaf (ones for the int8 scales)."""
    def one(p, lay):
        whole = zeros(torch.empty(p.shape, dtype=p.dtype, device="meta"))
        if isinstance(whole, dict):
            return {k: _local_fill(whole[k], lay[k], device,
                                   1.0 if k == "s" else 0.0)
                    for k in whole}
        return _local_fill(whole, lay, device, 0.0)
    return {k: (_sharded_zeros(zeros, v, layouts[k], device)
                if isinstance(v, dict) else one(v, layouts[k]))
            for k, v in params.items()}


def _local_fill(meta, lay, device, value):
    return lay.wrap(torch.full(lay.local_shape(meta.shape), value,
                               dtype=meta.dtype, device=device))


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _leaves(tree, is_leaf=lambda x: False):
    """Leaves in sorted-key order (``jax.tree`` flattening's order)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) and not is_leaf(v):
            yield from _leaves(v, is_leaf)
        else:
            yield v


#: elements of a leaf squared and summed at a time in ``global_norm``: its
#: fp32 temporaries stay at 512 MB where a whole leaf's would not fit (the
#: reference's XLA fuses them away; deepseek_v2_236b's expert leaves hold
#: 2.52e9 elements at 2 layers, two 10 GB copies)
NORM_CHUNK = 1 << 26


def _sq_sum(leaf: torch.Tensor) -> torch.Tensor:
    """sum(leaf ** 2) in fp32; a leaf of up to ``NORM_CHUNK`` elements in
    one sum, a larger one as the sum of its chunks' sums."""
    parts = [torch.sum(c.float() ** 2)
             for c in leaf.reshape(-1).split(NORM_CHUNK)]
    return parts[0] if len(parts) == 1 else torch.sum(torch.stack(parts))


def _sharded_dims(leaf):
    """The mesh dims (of size > 1) a DTensor leaf is sharded on."""
    if not isinstance(leaf, DTensor):
        return ()
    mesh = leaf.device_mesh
    return tuple(i for i, pl in enumerate(leaf.placements)
                 if isinstance(pl, Shard) and mesh.size(i) > 1)


def global_norm(tree) -> torch.Tensor:
    """The gradients' global L2 norm, each element counted once: a
    sharded leaf's local sum is added over the mesh dims it is sharded
    on, ``model`` among them for the leaves computed sharded there (item
    8d) and for those gathered whole, whose gradient comes back onto the
    same shards; over a dim a leaf is replicated on, its ranks hold the
    same elements and are not added."""
    leaves = list(_leaves(tree))
    sq = [_sq_sum(_local(leaf)) for leaf in leaves]
    # the local sums of the leaves sharded on the same mesh dims, added
    # over those dims in one collective; the leaves' order kept
    groups = defaultdict(list)
    for i, leaf in enumerate(leaves):
        dims = _sharded_dims(leaf)
        if dims:
            groups[dims].append(i)
    for dims, idx in groups.items():
        both = torch.stack([sq[i] for i in idx])
        mesh = leaves[idx[0]].device_mesh
        for d in dims:
            dist.all_reduce(both, group=mesh.get_group(d))
        for j, i in enumerate(idx):
            sq[i] = both[j]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _moved(t: DTensor, placements) -> DTensor:
    """``t`` in ``placements``: a mesh dim that shards another tensor dim
    is gathered first, then split (no all-to-all)."""
    via = [a if a == b else Replicate()
           for a, b in zip(t.placements, placements)]
    return t.redistribute(t.device_mesh, via).redistribute(t.device_mesh,
                                                           placements)


def _adamw_leaf(p, g, m, v, impl, **kw) -> None:
    """One leaf's update in place; sharded leaves on their local shards,
    in the moments' layout."""
    if not isinstance(p, DTensor):
        ops.fused_adamw(p, g, m, v, impl=impl, **kw)
        return
    first = m["q"] if isinstance(m, dict) else m
    loc = (lambda t: {k: x.to_local() for k, x in t.items()}
           if isinstance(t, dict) else t.to_local())
    if tuple(first.placements) == tuple(p.placements):
        ops.fused_adamw(p.to_local(), g.to_local(), loc(m), loc(v),
                        impl=impl, **kw)
        return
    pu = _moved(p.detach(), first.placements)
    gu = _moved(g, first.placements)
    pl = pu.to_local().contiguous()
    ops.fused_adamw(pl, gu.to_local(), loc(m), loc(v), impl=impl, **kw)
    back = _moved(DTensor.from_local(pl, p.device_mesh, first.placements,
                                     run_check=False), p.placements)
    p.to_local().copy_(back.to_local())


@torch.no_grad()
def apply(cfg: OptConfig, params, opt_state, grads
          ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step over the whole tree, in place; returns (params,
    opt_state, {"grad_norm", "lr"}) with the metrics as 0-d tensors."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    stepf = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, stepf)
    bc2 = 1.0 - torch.pow(cfg.b2, stepf)

    is_state_leaf = ((lambda x: "q" in x) if cfg.state_bits == 8
                     else (lambda x: False))
    flat = zip(_leaves(params), _leaves(grads),
               _leaves(opt_state["m"], is_state_leaf),
               _leaves(opt_state["v"], is_state_leaf))
    impl = "torch" if cfg.fused == "off" else cfg.fused
    for p, g, m, v in flat:
        _adamw_leaf(p, g, m, v, impl, lr=lr, scale=scale, bc1=bc1, bc2=bc2,
                    b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                    weight_decay=cfg.weight_decay)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
