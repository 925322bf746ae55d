"""Train-step factory: serial microbatch accumulation + remat + AdamW (the
port of ``repro.train.train_step``).

``train_step(state, batch) -> (state, metrics)``: one optimizer update per
call; gradients average over ``shape.microbatch`` sequential microbatches.
The state's params and moments are updated in place.  ``overlap_comm``
folds the compressed cross-pod all-reduce into the accumulation
(``make_train_step``; ``train.grad_compression``).  Every
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
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.transformer import flatten, unflatten
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.train import grad_compression as gc
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
                    overlap_comm: bool = False, mesh=None,
                    pod_axis: str = "pod", impl: str = "auto"):
    """``accum``: gradient-accumulator dtype across microbatches, "f32"
    (default) or "mixed" (bf16 for leaves of >= 4M elements).  ``impl``
    selects the kernels or their plain versions for the whole step
    (``kernels.ops``).

    ``overlap_comm``: each microbatch's pod-local gradients (reduced over
    the data axes only) go through the int8 compressed pod reduce
    (``grad_compression.start_pod_reduce``), issued asynchronously and
    waited on before its result is accumulated, so it runs under the
    next microbatch's forward and backward.  Requires ``mesh`` (a
    DeviceMesh) holding ``pod_axis``, a pure replica axis: the params
    and moments replicated over it, the batch split over it
    (``data.pipeline.batch_shards``).  The step runs under the block's
    ``ShardCtx`` the caller installs (the serial step's: ``pod_axis``
    among its summed data axes), with ``pod_axis`` made pod-local
    (``ShardCtx.pod_local``).  The error feedback starts at zero each
    step and is carried from microbatch to microbatch; the last
    microbatch's residual is dropped, as the reference drops it, so
    every pod's gradient, and so its params, stay bitwise the same.  The
    loss is the mean over the pods.  ``n_micro == 1`` takes the
    compressed path too.  The step's ``pod_reduce`` dict holds the last
    step's readings: the pods, the last microbatch's scales, the error
    feedback's bytes."""
    n_micro = max(1, shape.microbatch)
    if overlap_comm:
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        if pod_axis not in names:
            raise AssertionError((pod_axis, None if mesh is None else names))
    pod_reduce: Dict[str, Any] = {}

    def zeros_like_local(params, dtype_of):
        return {path: torch.zeros(_local(p).shape, device=_local(p).device,
                                  dtype=dtype_of(p))
                for path, p in flatten(params)}

    def acc_dtype(p):
        # the accumulator policy by the whole leaf's size
        return accum_dtype(accum, p, accum_threshold)

    def accum_serial(params, batch):
        # on the local shards of sharded leaves
        acc = zeros_like_local(params, acc_dtype)
        loss = torch.zeros((), device=next(iter(acc.values())).device)
        for i in range(n_micro):
            l, g = value_and_grad(params, cfg,
                                  _split_micro(batch, n_micro, i), impl=impl)
            for path, gl in flatten(g):
                acc[path].add_(_local(gl).to(acc[path].dtype))
            loss = loss + l
            del g
        return acc, loss

    def accum_overlapped(params, batch):
        ctx = shard_ctx.current()
        if ctx is None:
            raise ValueError("overlap_comm runs under the block's ShardCtx "
                             "(shard_ctx.use) on its pod mesh")
        ctx = ctx.pod_local(pod_axis)
        acc = zeros_like_local(params, acc_dtype)
        paths = list(acc)
        errs = [torch.zeros_like(a, dtype=torch.float32)
                for a in acc.values()]
        losses, pending = [], None

        def add(i, reduced):
            acc[paths[i]].add_(reduced.to(acc[paths[i]].dtype))

        for i in range(n_micro):
            with shard_ctx.use(ctx):
                l, g = value_and_grad(params, cfg,
                                      _split_micro(batch, n_micro, i),
                                      impl=impl)
            local = [_local(gl) for _, gl in flatten(g)]
            del g
            if pending is not None:
                pending.wait(add)
            pending = gc.start_pod_reduce(local, errs, mesh, pod_axis)
            del local
            losses.append(l)
        pending.wait(add)
        pod_reduce.update(
            n_pods=pending.n_pods,
            scales=pending.scales, numels=[e.numel() for e in errs],
            ef_bytes=sum(e.numel() * e.element_size() for e in errs))
        del errs
        # each microbatch's loss the mean over the pods, added in order
        means = torch.stack(losses)
        dist.all_reduce(means, group=mesh.get_group(pod_axis))
        means = means / torch.tensor(float(pending.n_pods),
                                     device=means.device)
        loss = torch.zeros((), device=means.device)
        for m in means:
            loss = loss + m
        return acc, loss

    def train_step(state, batch):
        params = state["params"]
        if n_micro == 1 and not overlap_comm:
            loss, grads = value_and_grad(params, cfg, batch, impl=impl)
        else:
            acc, loss = (accum_overlapped if overlap_comm
                         else accum_serial)(params, batch)
            # in place where the accumulator is already fp32
            grads = unflatten(
                (path, _like(p, acc[path].float().div_(n_micro)))
                for path, p in flatten(params))
            loss = loss / n_micro
        params, opt, opt_metrics = opt_lib.apply(opt_cfg, params,
                                                 state["opt"], grads)
        return {"params": params, "opt": opt}, {"loss": loss, **opt_metrics}

    train_step.pod_reduce = pod_reduce
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
