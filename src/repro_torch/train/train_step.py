"""Train-step factory: serial microbatch accumulation + remat + AdamW (the
port of ``repro.train.train_step``).

``train_step(state, batch) -> (state, metrics)``: one optimizer update per
call; gradients average over ``shape.microbatch`` sequential microbatches.
The state's params and moments are updated in place.  The reference's
``overlap_comm`` (a compressed cross-pod all-reduce folded into the
accumulation) waits for the multi-GPU slices and raises here.  Every
ported family trains: the dense GQA decoder, the VLM (next-token loss on
the text after the patches), the encoder (masked-frame loss,
bidirectional attention), the hybrid (Mamba2 + shared attention, whose
SSD scan has its backward kernel), the moe family (the loss plus the
router's aux loss; MLA's flash backward at head dim 192; each
microbatch's capacity from its own token count, as the reference's
per-call capacity) and the xlstm family (its mLSTM chunked scan and
sLSTM recurrence in plain PyTorch under autograd, as the reference has
no kernel for them; its RMSNorms are the kernel's).

Under a block of several devices (a ``ShardCtx`` installed around the
step, the params DTensors) each rank runs the step on its rows of the
batch: each group's params are gathered for its use and the gradients
come back reduce-scattered onto the plan's shards, where the
microbatches accumulate and the optimizer updates them.  A leaf the
block's layout computes sharded over ``model`` (item 8d) is gathered
over the data axes only, and its gradient comes back as the rank's
shard of it, on the same DTensor placements.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.transformer import flatten, unflatten
from repro_torch.train import optimizer as opt_lib


def make_train_state(cfg: ModelConfig, seed: int, opt_cfg: opt_lib.OptConfig,
                     *, params: Optional[Dict[str, Any]] = None,
                     opt_state: Optional[Dict[str, Any]] = None,
                     device="cuda") -> Dict[str, Any]:
    """{"params": tree of leaves that require grad, "opt": optimizer
    state}.  Random weights from ``seed`` unless ``params`` is given (e.g.
    moved across from the JAX package with ``interop``, or restored from
    a checkpoint); fresh moments unless ``opt_state`` is given."""
    net = model_lib.Transformer(cfg, params, seed=seed, device=device,
                                requires_grad=True)
    params = net.params
    if opt_state is None:
        opt_state = opt_lib.init(params, opt_cfg)
    return {"params": params, "opt": opt_state}


def make_sharded_train_state(cfg: ModelConfig, seed: int,
                             opt_cfg: opt_lib.OptConfig, layouts, *,
                             params: Optional[Dict[str, Any]] = None,
                             opt_state: Optional[Dict[str, Any]] = None,
                             device="cuda") -> Dict[str, Any]:
    """``make_train_state`` on a mesh: every leaf a DTensor of this rank's
    shards in ``layouts`` (the runtime's ``state_layouts``).  Random
    weights are drawn as the unsharded init draws them (one group at a
    time) and sliced; given whole trees (``params``, ``opt_state``) are
    sliced."""
    params = model_lib.place_params(cfg, layouts["params"], seed=seed,
                                    params=params, device=device)
    if opt_state is None:
        opt_state = opt_lib.init(params, opt_cfg, layouts=layouts["opt"])
    else:
        lay_o = layouts["opt"]
        opt_state = {
            "m": _shard_tree(opt_state["m"], lay_o["m"], device),
            "v": _shard_tree(opt_state["v"], lay_o["v"], device),
            "step": opt_state["step"].to(device)}
    return sharded_train_state({"params": params, "opt": opt_state})


def _shard_tree(tree, layouts, device):
    return {k: (_shard_tree(v, layouts[k], device) if isinstance(v, dict)
                else layouts[k].shard(v.to(device)))
            for k, v in tree.items()}


def sharded_train_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """A sharded train state whose param leaves are DTensors requiring
    grad (the runtime's restore gives plain DTensors)."""
    params = unflatten((path, leaf.detach().requires_grad_(True))
                       for path, leaf in flatten(state["params"]))
    return {"params": params, "opt": state["opt"]}


def abstract_train_state(cfg: ModelConfig, opt_cfg: opt_lib.OptConfig):
    """The train state's restore target: its tree on the ``meta``
    device."""
    params = model_lib.abstract_params(cfg)
    return {"params": params, "opt": opt_lib.init(params, opt_cfg)}


#: leaves at least this large accumulate in bf16 under ``accum="mixed"``
#: (4M elements; everything smaller stays fp32)
MIXED_ACCUM_MIN_SIZE = 1 << 22


def accum_dtype(accum: str, p, threshold: int = MIXED_ACCUM_MIN_SIZE):
    """Accumulator dtype policy for one grad leaf (see ``make_train_step``)."""
    if accum == "mixed" and p.numel() >= threshold:
        return torch.bfloat16
    return torch.float32


def value_and_grad(params, cfg: ModelConfig, batch, *, impl: str = "auto"):
    """(loss, grads tree) of ``model.loss_fn``; grads in the params'
    dtypes, as ``jax.value_and_grad`` gives them."""
    paths, leaves = zip(*flatten(params))
    loss, _ = model_lib.loss_fn(params, cfg, batch, impl=impl)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), unflatten(zip(paths, grads))


def _split_micro(batch, n_micro: int, i: int):
    """Microbatch ``i`` of ``n_micro`` along the leading dim of every
    leaf."""
    out = {}
    for k, x in batch.items():
        g = x.shape[0]
        if g % n_micro:
            raise ValueError(f"batch leaf {k!r} of {g} rows does not split "
                             f"into {n_micro} microbatches")
        mb = g // n_micro
        out[k] = x[i * mb:(i + 1) * mb]
    return out


def make_train_step(cfg: ModelConfig, shape: ShapeConfig,
                    opt_cfg: opt_lib.OptConfig, *, accum: str = "f32",
                    accum_threshold: int = MIXED_ACCUM_MIN_SIZE,
                    overlap_comm: bool = False, impl: str = "auto"):
    """``accum``: gradient-accumulator dtype across microbatches, "f32"
    (default) or "mixed" (bf16 for leaves of >= 4M elements).  ``impl``
    selects the kernels or their plain versions for the whole step
    (``kernels.ops``)."""
    if overlap_comm:
        raise NotImplementedError(
            "overlap_comm (the compressed cross-pod gradient all-reduce) is "
            "not yet ported: it comes with the multi-GPU slices")
    n_micro = max(1, shape.microbatch)

    def train_step(state, batch):
        params = state["params"]
        if n_micro == 1:
            loss, grads = value_and_grad(params, cfg, batch, impl=impl)
        else:
            # on the local shards of sharded leaves (the accumulator
            # policy by the whole leaf's size)
            acc = {path: torch.zeros(_local(p).shape, device=_local(p).device,
                                     dtype=accum_dtype(accum, p,
                                                       accum_threshold))
                   for path, p in flatten(params)}
            loss = torch.zeros((), device=next(iter(acc.values())).device)
            for i in range(n_micro):
                l, g = value_and_grad(params, cfg,
                                      _split_micro(batch, n_micro, i),
                                      impl=impl)
                for path, gl in flatten(g):
                    acc[path].add_(_local(gl).to(acc[path].dtype))
                loss = loss + l
                del g
            # in place where the accumulator is already fp32
            grads = unflatten(
                (path, _like(p, acc[path].float().div_(n_micro)))
                for path, p in flatten(params))
            loss = loss / n_micro
        params, opt, opt_metrics = opt_lib.apply(opt_cfg, params,
                                                 state["opt"], grads)
        return {"params": params, "opt": opt}, {"loss": loss, **opt_metrics}

    return train_step


_local = opt_lib._local


def _like(p, local):
    """``local`` placed as ``p`` is (a DTensor shard for a DTensor)."""
    if not isinstance(p, DTensor):
        return local
    return DTensor.from_local(local, p.device_mesh, p.placements,
                              run_check=False)


def make_eval_step(cfg: ModelConfig, *, impl: str = "auto"):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model_lib.loss_fn(params, cfg, batch, impl=impl)
        return {"loss": loss, **metrics}
    return eval_step
