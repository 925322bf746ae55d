"""Activation-sharding context (the port of ``repro.sharding.ctx``).

Model code is mesh-agnostic; the runtime installs a ``ShardCtx`` around a
step and the model asks it for the data-parallel size, gathers its
sharded params (``full``), sums over the data shards (``data_sum``) and
joins the ranks of a ``model`` column (``copy_in``, ``reduce_out``,
``gather_out``), all of which do nothing when no context is installed
(one device).

Tensor and expert parallelism over ``model`` (item 8d): a context built
with the block's ``plans.TPLayout`` (``tp``) has ``full`` gather each
leaf the layout computes sharded over the data axes only, so every rank
of a model column holds and computes its 1/M of the heads, the MLP
widths, the vocabulary and the experts, and the ranks join their
results with explicit collectives over the column's group, as Megatron
does: ``copy_in`` at the entry of every sharded region (identity
forward, all-reduce backward), ``reduce_out`` after every row-parallel
product and the vocab-parallel lookup and cross-entropy sums
(all-reduce forward, identity backward), ``gather_out`` after the
experts and for serve logits (all-gather forward, the local slice
backward).  Outside those regions every rank of a model column holds
and computes the same activations.  Every leaf the layout keeps in 8a's
layout (``TPLayout.kept``), and every leaf under a context without a
layout, is gathered whole over both axes.  A leaf of which each rank
computes only its heads' columns, where the plan's contiguous chunks of
its columns do not line up with heads (``TPLayout.exchange``: Mamba2's
``w_in`` and ``conv_w``, the mLSTM's ``w_up``, the sLSTM's
``w_gates``), is gathered over the data axes and its columns exchanged
over the model column, each rank receiving only those it lacks.  With
M = 1 the three Functions return their input.  They are the
reference's ``constrain_*`` layout hints made explicit: GSPMD inserts
the same collectives there.

A serve step gathers forward only: ``full`` of a DTensor with no
gradient to place (grad off, or no context installed, as the paged
plane's rounds run) is a plain gather.  The dense serve plane's
context splits the batch's rows over ``data`` where they split
(``shards_batch``), and ``gather_rows`` puts the ranks' rows of a step's
output back together in order; its ``data_sum`` rules are the train
step's (the aux loss of a MoE layer summed over the data shards whose
ranks computed different rows, nothing where every rank holds the
whole batch).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding.plans import axis_sizes

_STATE = threading.local()


class ShardCtx:
    """``mesh``: the block's DeviceMesh.  ``dp_axes``: the axes the batch
    splits over whose gradients and loss terms are summed (on a
    ``("pod", "data", "model")`` mesh the serial step's ``("pod",
    "data")``: the reference's GSPMD psum over pods).  ``local``: axes
    the batch splits over whose ranks keep their own gradients and loss,
    unsummed (the overlapped step's ``pod``, reduced afterwards by the
    compressed pod reduce, ``train.grad_compression``).  Every mesh axis
    is one of ``dp_axes``, ``local`` or ``model_axis``.
    ``shards_batch``: each rank holds its own rows of every microbatch
    (``data.pipeline.BatchShards``); when False every rank holds the
    whole batch and computes it all, so the data axes carry no sum.
    ``tp``: the block's ``plans.TPLayout``, what the ranks of a model
    column compute sharded (None: nothing, 8a's layout).  ``seq_split``:
    a serve block whose batch every rank holds whole keeps a slice of its
    attention cache's positions (GQA's K/V, MLA's compressed cache) on
    each rank of the data axes, in the order of ``data_index``
    (``plans.cache_layouts``' ``seq``)."""

    def __init__(self, mesh, dp_axes: Tuple[str, ...], model_axis: str,
                 shards_batch: bool = True, tp=None,
                 local: Tuple[str, ...] = (), seq_split: bool = False):
        self.mesh = mesh
        self.dp = tuple(dp_axes)
        self.model = model_axis
        self.local = tuple(local)
        self.shards_batch = shards_batch
        self.tp = tp
        self.seq_split = seq_split and not shards_batch
        # read once: a DeviceMesh's shape is a tensor, and the model
        # code asks for it at every join and gather
        self._sizes = axis_sizes(mesh)
        other = [a for a in self._sizes
                 if a not in self.dp + self.local + (model_axis,)]
        if other:
            raise ValueError(
                f"mesh axes {other} are neither summed data axes "
                f"({self.dp}), pod-local axes ({self.local}) nor the model "
                f"axis {model_axis!r}: a gradient over them would be "
                f"left apart silently")

    def pod_local(self, pod_axis: str) -> "ShardCtx":
        """This context with ``pod_axis`` moved from the summed data axes
        to the pod-local ones (the overlapped train step's)."""
        if pod_axis in self.local:
            return self
        return ShardCtx(self.mesh, tuple(a for a in self.dp
                                         if a != pod_axis),
                        self.model, self.shards_batch, self.tp,
                        self.local + (pod_axis,), self.seq_split)

    @property
    def sizes(self):
        return self._sizes

    def grad_placements(self, placements=None, model_partial: bool = False):
        """How a gathered param's gradient lies over the mesh: a partial
        sum over the data axes whose ranks computed different rows; over
        a pod-local axis each rank's own (declared replicated, so no
        collective touches it: the values differ until the compressed
        pod reduce); over ``model`` the same on every rank, whose ranks
        compute the same activations outside the sharded regions, or,
        for a leaf computed sharded or exchanged (its DTensor
        ``placements`` given), the rank's own shard, or, for a leaf
        gathered whole of which each rank computes its share
        (``model_partial``: the paths of ``TPLayout.partial`` that are
        not exchanged), each rank's part of a sum."""
        out = []
        for i, a in enumerate(self.sizes):
            if a in self.dp:
                out.append(Partial() if self.shards_batch else Replicate())
            elif a in self.local:
                out.append(Replicate())
            elif model_partial:
                out.append(Partial())
            else:
                out.append(placements[i] if placements is not None
                           else Replicate())
        return tuple(out)

    def data_index(self) -> int:
        """This rank's place among the data ranks, the data axes taken
        in mesh order (the first outermost, as DTensor lays a dim sharded
        over them)."""
        coord = self.mesh.get_coordinate()
        i = 0
        for d, (a, n) in enumerate(self.sizes.items()):
            if a in self.dp:
                i = i * n + coord[d]
        return i

    def summed_dims(self):
        """The mesh dims (of size > 1) that a sum over the data shards
        runs over."""
        if not self.shards_batch:
            return []
        return [i for i, (a, n) in enumerate(self.sizes.items())
                if a in self.dp and n > 1]

    def model_group(self):
        """The process group of this rank's model column (None at
        M = 1)."""
        if self.sizes[self.model] == 1:
            return None
        return self.mesh.get_group(self.model)


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


#: ``model_bytes``: bytes ``full`` brought this rank over ``model``: of
#: each leaf gathered whole over a model axis of M > 1, the (M - 1) / M
#: other ranks hold; of each exchanged leaf (``TPLayout.exchange``), the
#: columns it needs that other ranks hold, and in the backward the
#: gradients of its own columns that other ranks computed with
#: (``plans.TPLayout.step_bytes`` counts the same; 0 at M = 1, where
#: there is nothing to bring); ``tp_leaves``: the leaves ``full`` handed
#: back as their ``model`` shard, at any M
GATHERED = {"model_bytes": 0, "tp_leaves": 0}
#: bytes the model column's joins brought to this rank: a ring
#: all-reduce of an n-byte tensor 2 (M - 1) / M n, an all-gather of
#: n-byte shards (M - 1) n (``launch.hlo_analysis.tp_traffic`` computes
#: the same)
JOINED = {"model_bytes": 0}


def _joined(x, M: int, gather: bool = False) -> None:
    n = x.numel() * x.element_size()
    JOINED["model_bytes"] += (M - 1) * n if gather else 2 * (M - 1) * n // M


def _model_dim(mesh) -> Optional[int]:
    names = mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def full(x, path: Optional[str] = None):
    """A param leaf for its use: a DTensor is gathered (under a context
    with gradients on, its gradient reduce-scattered back onto the
    shards, ``grad_placements``; else forward only); a plain tensor is
    returned as it is.  Where the context's layout computes the leaf at
    ``path`` sharded over a model axis of M > 1 (``TPLayout.leaves``),
    only the data axes are gathered and the rank's ``model`` shard comes
    back (at M = 1 the shard is the leaf); where it exchanges the leaf's
    columns (``TPLayout.exchange``), the data axes are gathered and the
    rank gets the columns its heads compute with (``_Exchange``); every
    other leaf comes back whole, its gradient a sum over the model
    column where the layout says each rank computes only its share of it
    (``TPLayout.partial``).
    """
    if not isinstance(x, DTensor):
        return x
    ctx = current()
    grad = ctx is not None and torch.is_grad_enabled()
    mesh, pl = x.device_mesh, x.placements
    m = _model_dim(mesh)
    tp = None if ctx is None else ctx.tp
    cols = None if tp is None else tp.exchange.get(path)
    if tp is not None and (path in tp.leaves or cols is not None):
        keep = tuple(p if i == m else Replicate() for i, p in enumerate(pl))
        y = x.redistribute(mesh, keep)
        local = (y.to_local(grad_placements=ctx.grad_placements(keep))
                 if grad else y.to_local())
        if cols is None:
            GATHERED["tp_leaves"] += 1
            return local
        assert pl[m] == Shard(x.ndim - 1), (path, pl)
        r = mesh.get_coordinate()[m]
        return _Exchange.apply(local, mesh.get_group(m),
                               _exchange_plan(cols, local.shape[-1], r))
    if m is not None and isinstance(pl[m], Shard) and mesh.size(m) > 1:
        n = mesh.size(m)
        GATHERED["model_bytes"] += x.numel() * x.element_size() * (n - 1) \
            // n
    if not grad:
        return x.full_tensor()
    return x.full_tensor(grad_placements=ctx.grad_placements(
        model_partial=tp is not None and path in tp.partial))


@dataclasses.dataclass(frozen=True)
class _Plan:
    """One rank's part in exchanging a leaf's columns over its model
    column: ``send``, for each rank, the columns of this rank's chunk
    that the rank wants (indices into the chunk, in the wanted order);
    ``recv_counts``, how many of this rank's wanted columns each rank
    holds.  Columns are wanted in ascending order, so the parts received
    in rank order are the wanted columns in order."""
    send: Tuple[Tuple[int, ...], ...]
    recv_counts: Tuple[int, ...]
    rank: int

    @property
    def send_counts(self) -> Tuple[int, ...]:
        return tuple(len(s) for s in self.send)


_PLANS = {}


def _exchange_plan(cols, chunk: int, r: int) -> _Plan:
    """Rank ``r``'s ``_Plan`` for columns ``cols`` (one ascending tuple a
    rank, ``TPLayout.exchange``) of a leaf cut into chunks of ``chunk``
    columns; made once a layout."""
    key = (id(cols), chunk, r)
    hit = _PLANS.get(key)
    if hit is not None and hit[0] is cols:
        return hit[1]
    lo = r * chunk
    recv = [0] * len(cols)
    for c in cols[r]:
        recv[c // chunk] += 1
    plan = _Plan(tuple(tuple(c - lo for c in want if lo <= c < lo + chunk)
                       for want in cols), tuple(recv), r)
    _PLANS[key] = (cols, plan)
    return plan


class _Exchange(torch.autograd.Function):
    """A leaf's wanted columns (its last dim) from the model column's
    chunks: forward, each rank sends every rank the columns of its chunk
    that the other wants, in one ``all_to_all_single`` over the column,
    and the parts received in rank order are the wanted columns;
    backward, the reverse exchange of the gradient columns, each rank
    adding those of its own chunk into its chunk's gradient rank by rank
    in rank order (the columns every rank wants, Mamba2's B and C or the
    mLSTM's ``xm``, are summed so)."""

    @staticmethod
    def forward(ctx, local, group, plan):
        ctx.group, ctx.plan, ctx.chunk = group, plan, local.shape[-1]
        x = local.movedim(-1, 0)
        index = torch.tensor(sum(plan.send, ()), dtype=torch.long,
                             device=x.device)
        out = x.new_empty((sum(plan.recv_counts),) + x.shape[1:])
        dist.all_to_all_single(out, x.index_select(0, index),
                               list(plan.recv_counts),
                               list(plan.send_counts), group=group)
        GATHERED["model_bytes"] += _others(out, plan.recv_counts,
                                           plan.rank)
        return out.movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        g = g.movedim(-1, 0).contiguous()
        back = g.new_empty((sum(plan.send_counts),) + g.shape[1:])
        dist.all_to_all_single(back, g, list(plan.send_counts),
                               list(plan.recv_counts), group=ctx.group)
        GATHERED["model_bytes"] += _others(back, plan.send_counts,
                                           plan.rank)
        grad = g.new_zeros((ctx.chunk,) + g.shape[1:])
        for idx, part in zip(plan.send, back.split(plan.send_counts)):
            grad.index_add_(0, torch.tensor(idx, dtype=torch.long,
                                            device=g.device), part)
        return grad.movedim(0, -1).contiguous(), None, None


def _others(t, counts, rank: int) -> int:
    """The bytes of ``t``'s rows, cut into ``counts``, that came from
    ranks other than ``rank``."""
    row = math.prod(t.shape[1:]) * t.element_size()
    return (sum(counts) - counts[rank]) * row


def full_tree(tree, prefix: str = ""):
    """``full`` of every leaf of a param tree, each known by its path
    under ``prefix`` (``transformer.flatten``'s, the stack dims
    dropped)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: full_tree(v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return full(tree, prefix)


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


def gather_data(x):
    """Every data rank's ``x`` stacked along a new first dim, in the
    order of ``ShardCtx.data_index``, forward only: the partial results
    of a decode attention over a sequence-split cache, for their merge
    (``kernels.ops.merge_attention``).  ``x[None]`` with no context or
    one data rank."""
    ctx = current()
    if ctx is None or _dp_size(ctx) == 1:
        return x[None]
    placements = tuple(Shard(0) if a in ctx.dp else Replicate()
                       for a in ctx.sizes)
    return DTensor.from_local(x[None].contiguous(), ctx.mesh, placements,
                              run_check=False).full_tensor()


def seq_offset(local_len: int) -> Optional[int]:
    """The first position of this rank's slice of a sequence-split cache
    of ``local_len`` positions a rank (``ShardCtx.seq_split``); None
    where the cache's sequence is whole."""
    ctx = current()
    if ctx is None or not ctx.seq_split:
        return None
    return ctx.data_index() * local_len


def data_sum(x):
    """``x`` summed over the data shards (``x`` itself with no context,
    no data axis of size > 1, or a batch every rank holds whole)."""
    ctx = current()
    dims = [] if ctx is None else ctx.summed_dims()
    if not dims:
        return x
    return _DataSum.apply(x, ctx.mesh, dims)


def _dp_size(ctx: ShardCtx) -> int:
    sizes = ctx.sizes
    return math.prod(sizes[a] for a in ctx.dp)


def dp_size() -> int:
    """Data-parallel world size (1 when no sharding context installed)."""
    ctx = current()
    return _dp_size(ctx) if ctx is not None else 1


# ------------------------------------------------ the model column's joins

def tp_on(kind: str) -> bool:
    """Whether the installed context's layout computes ``kind``
    (``plans._tp_kind``) sharded over ``model``."""
    ctx = current()
    return ctx is not None and ctx.tp is not None and ctx.tp.computes(kind)


def model_size() -> int:
    """M, the size of the context's model axis (1 without a context)."""
    ctx = current()
    return 1 if ctx is None else ctx.sizes[ctx.model]


def model_rank() -> int:
    """This rank's place along the model axis (0 without a context)."""
    ctx = current()
    if ctx is None:
        return 0
    return ctx.mesh.get_coordinate()[list(ctx.sizes).index(ctx.model)]


class _CopyIn(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the model column,
    where each rank's sharded region gave its own part of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        _joined(g, dist.get_world_size(ctx.group))
        return g, None


class _ReduceOut(torch.autograd.Function):
    """All-reduce (sum) over the model column forward, the gradient
    passed through: every rank's copy of the sum gives its own addend
    the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        _joined(out, dist.get_world_size(group))
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOut(torch.autograd.Function):
    """The column's shards concatenated along ``dim`` in rank order
    forward; backward, this rank's slice of the gradient (the same on
    every rank)."""

    @staticmethod
    def forward(ctx, x, group, dim, index):
        n = dist.get_world_size(group)
        ctx.dim, ctx.index, ctx.size = dim, index, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        _joined(x, n, gather=True)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, \
            None, None


class _GatherSum(torch.autograd.Function):
    """The column's shards concatenated along ``dim`` in rank order
    forward, for a computation each rank runs on the whole of which it
    keeps only its share; backward, the ranks' gradients of the whole
    summed, and this rank's slice of the sum."""

    @staticmethod
    def forward(ctx, x, group, dim, index):
        n = dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.index = group, dim, index
        ctx.size = x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        _joined(x, n, gather=True)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        _joined(g, dist.get_world_size(ctx.group))
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, \
            None, None


def _model_group():
    ctx = current()
    return None if ctx is None else ctx.model_group()


def copy_in(x):
    """The entry of a region computed sharded over ``model``."""
    group = _model_group()
    return x if group is None else _CopyIn.apply(x, group)


def reduce_out(x):
    """The model column's partial results summed (a row-parallel
    product's, the vocab-parallel lookup's and cross-entropy's)."""
    group = _model_group()
    return x if group is None else _ReduceOut.apply(x, group)


def gather_out(x, dim: int):
    """The model column's shards of ``x`` whole along ``dim`` (the
    experts' rows, the vocabulary of serve logits)."""
    group = _model_group()
    if group is None:
        return x
    return _GatherOut.apply(x, group, dim % x.ndim, model_rank())


def gather_sum(x, dim: int):
    """The model column's shards of ``x`` whole along ``dim``, where
    each rank then computes on the whole and keeps its share (a Mamba2
    sublayer's gated norm over all of ``d_inner``): all-gather forward,
    the gradient summed over the column backward."""
    group = _model_group()
    if group is None:
        return x
    return _GatherSum.apply(x, group, dim % x.ndim, model_rank())


def max_over_model(x):
    """``x``'s elementwise maximum over the model column, forward only
    (a softmax's shift)."""
    group = _model_group()
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    _joined(out, dist.get_world_size(group))
    return out
