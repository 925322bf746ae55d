"""Activation-sharding context (the port of ``repro.sharding.ctx``).

Model code is mesh-agnostic; the runtime installs a ``ShardCtx`` around a
step and the model asks it for the data-parallel size, gathers its
sharded params (``full``) and sums over the data shards (``data_sum``),
all of which do nothing when no context is installed (one device).

A serve step gathers forward only: ``full`` of a DTensor with no
gradient to place (grad off, or no context installed, as the paged
plane's rounds run) is a plain all-gather.  The dense serve plane's
context splits the batch's rows over ``data`` where they split
(``shards_batch``), and ``gather_rows`` puts the ranks' rows of a step's
output back together in order; its ``data_sum`` rules are the train
step's (the aux loss of a MoE layer summed over the data shards whose
ranks computed different rows, nothing where every rank holds the
whole batch).

The ``constrain_*`` helpers are the reference's layout hints for XLA's
partitioner.  Under the port's layout (item 8a) every rank computes its
data shard's rows whole, with each param group gathered for its use, so
they are identities here; tensor and expert parallelism over ``model``
(item 8d) gives them effect.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding.plans import axis_sizes

_STATE = threading.local()


class ShardCtx:
    """``mesh``: the block's DeviceMesh.  ``shards_batch``: each rank holds
    its own rows of every microbatch (``data.pipeline.BatchShards``); when
    False every rank holds the whole batch and computes it all, so the
    data axes carry no sum."""

    def __init__(self, mesh, dp_axes: Tuple[str, ...], model_axis: str,
                 shards_batch: bool = True):
        self.mesh = mesh
        self.dp = dp_axes
        self.model = model_axis
        self.shards_batch = shards_batch

    @property
    def sizes(self):
        return axis_sizes(self.mesh)

    def grad_placements(self):
        """How a gathered param's gradient lies over the mesh: a partial
        sum over the data axes whose ranks computed different rows, and
        the same on every rank of ``model`` (whose ranks computed the
        same rows under 8a)."""
        return tuple(Partial() if (a in self.dp and self.shards_batch)
                     else Replicate() for a in self.sizes)

    def summed_dims(self):
        """The mesh dims (of size > 1) that a sum over the data shards
        runs over."""
        if not self.shards_batch:
            return []
        return [i for i, (a, n) in enumerate(self.sizes.items())
                if a in self.dp and n > 1]


def current() -> Optional[ShardCtx]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use(ctx: Optional[ShardCtx]):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = prev


def full(x):
    """A param leaf whole for its use: a DTensor is all-gathered (under a
    context with gradients on, its gradient reduce-scattered back onto
    the shards, ``grad_placements``; else forward only); a plain tensor
    is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    ctx = current()
    if ctx is None or not torch.is_grad_enabled():
        return x.full_tensor()
    return x.full_tensor(grad_placements=ctx.grad_placements())


def full_tree(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    return full(tree)


class _DataSum(torch.autograd.Function):
    """All-reduce (sum) over the data axes, the gradient passed through
    unchanged: each rank's copy of the summed value gives that rank's own
    addend the gradient, and the data axes' sum of the param gradients
    counts every addend once."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        out = x.detach().clone()
        for d in dims:
            dist.all_reduce(out, group=mesh.get_group(d))
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gather_rows(x):
    """The rows of every data shard of a step's output ``x`` (this rank's
    rows of the batch first dim), in rank order: the whole batch's, on
    every rank.  ``x`` itself with no context or where every rank holds
    the whole batch.  A forward-only all-gather over the data axes."""
    ctx = current()
    if ctx is None or not ctx.shards_batch:
        return x
    placements = tuple(Shard(0) if a in ctx.dp else Replicate()
                       for a in ctx.sizes)
    return DTensor.from_local(x, ctx.mesh, placements,
                              run_check=False).full_tensor()


def data_sum(x):
    """``x`` summed over the data shards (``x`` itself with no context,
    no data axis of size > 1, or a batch every rank holds whole)."""
    ctx = current()
    dims = [] if ctx is None else ctx.summed_dims()
    if not dims:
        return x
    return _DataSum.apply(x, ctx.mesh, dims)


def constrain_tokens_3d(x):
    """(B, S, d) residual-stream activations: batch over dp."""
    return x


def constrain_experts(x):
    """(E, C, d) expert buffers: experts over the model axis (EP)."""
    return x


def constrain_logits(x):
    """(B, S, V) logits: batch over dp, vocab over model."""
    return x


def _dp_size(ctx: ShardCtx) -> int:
    sizes = ctx.sizes
    return math.prod(sizes[a] for a in ctx.dp)


def dp_size() -> int:
    """Data-parallel world size (1 when no sharding context installed)."""
    ctx = current()
    return _dp_size(ctx) if ctx is not None else 1


def constrain_moe_shards(x):
    """(DP, Tl, ...) per-shard routing tensors: leading dim over dp."""
    return x


def constrain_expert_buffers(x):
    """(DP, E, C, d) expert buffers: shards over dp, experts over model."""
    return x
