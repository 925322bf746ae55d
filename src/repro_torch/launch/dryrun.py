"""Multi-pod dry run (the port of ``repro.launch.dryrun``): build every
(architecture x input shape x mesh) cell with the production layouts and
run the port's own step once on a fake process group, on fake tensors,
to prove the cell fits a card and to take its roofline terms.

Where the reference lowers and compiles with 512 forced host devices,
the port runs its step as it runs on the card, on the CPU and without
one: ``run_cell`` starts a process group of the ``fake`` backend
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once) of the mesh's 256 or 512 ranks, this process rank 0, and builds
and runs the cell under ``FakeTensorMode``, so nothing is allocated and
nothing launched.  A cell runs:

* ``train``: ``train_step.make_train_step`` with ``TRAIN_OVERRIDES`` on
  the sharded state (``plans.state_layouts``), one step on the rank's
  rows of the batch (``data.pipeline.input_specs``' shapes);
* ``prefill``: ``serve_step.make_prefill_step`` on the dense plane's
  cache of the rank's rows (the encoder's prefill is its encode: no
  cache);
* ``decode``: ``serve_step.make_decode_step`` on that cache, through
  ``serve_step.on_mesh``.

Each line records one rank: FLOPs (``FlopCounterMode``, plus the
kernels' own counts, ``kernels.ops.FAKE_COST``: a kernel's call on a
fake tensor is counted by its bound formula, never launched and never
replaced by its plain version); HBM bytes (each ATen op's operands and
results, views left out: eager PyTorch pays every op's traffic, plus
the kernels' counts); collective operand bytes and counts by kind (the
reference's convention), those on groups across pods apart; the rank's
state bytes and its peak bytes under ``MemTracker``, against one card's
80 GB (``fits``); and ``hlo_analysis.Roofline.to_dict()`` on the H100's
peaks.  ``gaps`` names what the port keeps whole where the reference
shards it (item 8g): the dry run reports what the port holds.  Since
item 8g (the hybrid, MLA and the xLSTM): heads and widths that do not
divide by M ("heads", "mla: heads", "mamba", "xlstm: heads", "mlp",
"slstm_ff", ...) and the paged plane ("paged").  A
serve batch that does not split over the data ranks holds its attention
cache's positions (GQA's K/V, MLA's compressed cache) split over them,
as the reference's ``cache_specs`` (``ShardCtx.seq_split``); a Mamba2
``conv`` state holds a rank's heads'
channels and the whole B and C, where the reference's spec cuts the
channels into contiguous chunks; the xLSTM's recurrent states hold a
rank's heads and its mLSTM ``conv`` tail is whole (its line's ``cache``
gives the bytes, ``_DEPARTS`` the reasons).  ``model_traffic``: a rank's
bytes over ``model`` a step under 8a's and 8d's layouts, and 8d's had
the exchanged leaves been gathered whole (``hlo_analysis.tp_traffic``,
computed beside the step, not counted from it).

Usage (on the CPU; nothing is set at import):
  python -m repro_torch.launch.dryrun --arch deepseek_7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out artifacts/dryrun_torch/sweep.jsonl
  python -m repro_torch.launch.dryrun --arch deepseek_7b --kind train --seq-len 2048 \\
      --global-batch 2 --microbatch 1 --state-bits 8 --mesh-shape 1,1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.configs as configs
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.launch import hlo_analysis
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.serve import serve_step as serve_lib
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding import plans
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as train_lib

# per-(arch, shape) training overrides, the reference's: the 100B+-scale
# MoE models take 8-bit Adam moments and mixed-precision accumulation
TRAIN_OVERRIDES: Dict[str, Dict[str, Any]] = {
    "llama4_maverick_400b": {"state_bits": 8, "accum": "mixed"},
    "deepseek_v2_236b": {"state_bits": 8, "accum": "mixed"},
    # sub-1B model: TP buys nothing and the sLSTM time scan would pay
    # per-step model-axis collectives — run pure 256-way DP (ZeRO-3)
    "xlstm_350m": {"no_tp": True, "microbatch": 1},
}

#: one card's memory (NVIDIA H100 80GB HBM3)
DEVICE_BYTES = 80e9

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def axis_names_for(shape) -> tuple:
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def fake_world(n: int) -> None:
    """This process as rank 0 of a ``fake`` process group of ``n`` ranks
    (another running group is ended first)."""
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


# ------------------------------------------------------------- counting

#: collective ops: (kind, operand argument, group argument); a c10d op's
#: group is a boxed ProcessGroup, a functional one's its name
_COLL = {
    "_c10d_functional::all_reduce": ("all-reduce", 0, 2),
    "_c10d_functional::all_reduce_": ("all-reduce", 0, 2),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", 0, 2),
    "_c10d_functional::all_gather_into_tensor_out": ("all-gather", 0, 2),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", 0, 3),
    "_c10d_functional::all_to_all_single": ("all-to-all", 0, 3),
    "_c10d_functional::broadcast": ("collective-broadcast", 0, 2),
    "_c10d_functional::broadcast_": ("collective-broadcast", 0, 2),
    "c10d::allreduce_": ("all-reduce", 0, 1),
    "c10d::allreduce_coalesced_": ("all-reduce", 0, 1),
    "c10d::allgather_": ("all-gather", 1, 2),
    "c10d::_allgather_base_": ("all-gather", 1, 2),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 1, 2),
    "c10d::reduce_scatter_": ("reduce-scatter", 1, 2),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1, 2),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 2),
    "c10d::broadcast_": ("collective-broadcast", 0, 1),
    "c10d::alltoall_base_": ("all-to-all", 1, 2),
    "c10d::alltoall_": ("all-to-all", 1, 2),
}

#: ops that move no data: uninitialised allocations and metadata
_NO_TRAFFIC = {"aten::empty", "aten::empty_strided", "aten::empty_like",
               "aten::new_empty", "aten::new_empty_strided",
               "aten::_unsafe_view", "aten::lift_fresh", "aten::set_",
               "aten::resize_", "aten::_local_scalar_dense"}


def _bytes_of(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _group_name(group) -> str:
    """A collective's group by name (a c10d op's is a boxed
    ProcessGroup, a functional one's already its name)."""
    if isinstance(group, str):
        return group
    return dist.ProcessGroup.unbox(group).group_name


def _group_ranks(name: str) -> List[int]:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_process_group_ranks(_resolve_process_group(name))


class StepCounter(TorchDispatchMode):
    """One rank's traffic while it is installed: ``bytes``, each ATen
    op's operands and results (views and allocations left out), and
    every collective's operand bytes and count by kind (``coll_bytes``,
    ``coll_counts``), with the bytes on groups whose ranks lie in more
    than one pod apart (``pod_bytes``; ``ranks_per_pod`` ranks a pod,
    pod-major, as ``launch.mesh.make_production_mesh`` lays them; None:
    one pod).  A DTensor op is left to DTensor, whose local ops and
    collectives are then counted (as ``CommDebugMode`` does).  Works on
    real tensors (gloo ranks) as on fake ones."""

    def __init__(self, ranks_per_pod: Optional[int] = None):
        super().__init__()
        self.ranks_per_pod = ranks_per_pod
        self.bytes = 0
        self.coll_bytes: Dict[str, int] = {}
        self.coll_counts: Dict[str, int] = {}
        self.pod_bytes = 0
        self._crosses: Dict[Any, bool] = {}

    def _across_pods(self, group) -> bool:
        if self.ranks_per_pod is None:
            return False
        key = _group_name(group)
        if key not in self._crosses:
            pods = {r // self.ranks_per_pod for r in _group_ranks(key)}
            self._crosses[key] = len(pods) > 1
        return self._crosses[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._schema.name
        coll = _COLL.get(name)
        if coll is not None:
            kind, arg, grp = coll
            n = _bytes_of(args[arg])
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + n
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            if self._across_pods(args[grp]):
                self.pod_bytes += n
        elif not func.is_view and name not in _NO_TRAFFIC \
                and not name.startswith(("c10d::", "_c10d_functional::")):
            self.bytes += _bytes_of((args, kwargs)) + _bytes_of(out)
        return out

    def counts(self) -> Dict[str, Any]:
        return {"bytes": self.bytes, "coll_bytes": dict(self.coll_bytes),
                "coll_counts": dict(self.coll_counts),
                "pod_bytes": self.pod_bytes}


def _local_tensors(tree) -> List[torch.Tensor]:
    out = []
    for t in pytree.tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            out.append(t)
    return out


def state_bytes(tree) -> int:
    """Bytes of this rank's tensors of a state tree (DTensors' local
    shards)."""
    return sum(t.numel() * t.element_size() for t in _local_tensors(tree))


# ----------------------------------------------------------------- cells

def block_mesh(mesh_shape: Optional[tuple], multi_pod: bool):
    """The cell's mesh over the running group's ranks: ``mesh_shape``
    (axes ``axis_names_for``) or the production mesh.  Built outside a
    fake mode: a mesh's layout is read as real numbers."""
    from repro_torch.launch.mesh import make_block_mesh
    shape, names = ((tuple(mesh_shape), axis_names_for(mesh_shape))
                    if mesh_shape else PRODUCTION[multi_pod])
    return make_block_mesh(list(range(math.prod(shape))), shape, names)


@dataclasses.dataclass
class Cell:
    """One cell built for its dry run: ``run`` is its step on this rank's
    fake inputs, ``state`` what the rank holds across steps.  Nothing is
    compiled: the port has no HLO text (``launch.attribute`` reads one
    given with ``--hlo-file``)."""
    run: Callable[[], Any]
    state: Any
    meta: Dict[str, Any]
    gaps: List[str]


def _model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    return hlo_analysis.model_step_flops(cfg, shape)


def _fake_inputs(shapes: Dict[str, Any], rows: int) -> Dict[str, Any]:
    """Tensors of ``shapes`` with ``rows`` rows: integer ones zero (any
    token id is valid), floating ones uninitialised."""
    out = {}
    for k, (s, dt) in shapes.items():
        s = (rows,) + tuple(s[1:])
        out[k] = (torch.empty(s, dtype=dt) if dt.is_floating_point
                  else torch.zeros(s, dtype=dt))
    return out


def cache_bytes(cfg: ModelConfig, cache, B: int, smax: int, mesh,
                axes) -> Optional[Dict[str, Any]]:
    """A serve cell's decode cache on this rank, leaf name by leaf name
    (``k``, ``v``, ``conv``, ``ssm``, ...; the stacks summed): the bytes
    the port holds (``bytes``) and the bytes the reference's
    ``cache_specs`` would put on a rank (``reference_bytes``, computed:
    its partition arithmetic on the whole leaf's shape), and each leaf
    whose two differ with the reason (``departs``).  None for a model
    without a cache (the encoder)."""
    if cache is None:
        return None
    whole = dict(transformer.flatten(model_lib.init_cache(cfg, B, smax,
                                                          "meta")))
    out: Dict[str, Dict[str, int]] = {"bytes": {}, "reference_bytes": {}}
    for path, leaf in transformer.flatten(cache):
        # the leaf's name, as the spec rules read it (a tuple's items
        # are named by the key above them)
        name = [k for k in path.split("/") if not k.isdigit()][-1]
        spec = plans.cache_specs({name: whole[path]}, cfg, mesh, axes,
                                 batch_size=B)[name]
        ref = math.prod(plans.local_shape(whole[path].shape, spec,
                                          mesh)) * leaf.element_size()
        for key, n in (("bytes", leaf.numel() * leaf.element_size()),
                       ("reference_bytes", ref)):
            out[key][name] = out[key].get(name, 0) + int(n)
    out["departs"] = {n: _DEPARTS.get((cfg.family, n),
                                      "kept whole (see gaps)")
                      for n, b in out["bytes"].items()
                      if b != out["reference_bytes"][n]}
    return out


#: why a cache leaf's bytes on a rank are not the reference spec's, by
#: (family, leaf name)
_DEPARTS = {
    ("hybrid", "conv"): "a rank holds its Mamba2 heads' x channels and "
                        "the whole B and C, where the reference's spec "
                        "cuts the channels into contiguous chunks",
    ("xlstm", "conv"): "every rank holds the mLSTM's conv tail whole: "
                       "each computes xm and the conv whole, as every "
                       "head reads all of it, where the reference's spec "
                       "cuts the channels over model",
    ("xlstm", "mlstm"): "a rank holds its heads' rows of the mLSTM's "
                        "(C, n, m), where the reference's spec holds "
                        "them by batch only",
    ("xlstm", "slstm"): "a rank holds its heads' rows of the sLSTM's "
                        "(h, c, n, m), where the reference's spec holds "
                        "them by batch only"}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               microbatch: Optional[int] = None,
               cfg: Optional[ModelConfig] = None,
               shape: Optional[ShapeConfig] = None,
               mesh=None, state_bits: Optional[int] = None) -> tuple:
    """Build one cell on ``mesh`` (``block_mesh``'s, built outside the
    fake mode; by default the production mesh), under the caller's
    ``FakeTensorMode``: (``Cell``, meta).  ``cfg`` and ``shape`` replace
    the config of ``arch`` and the shape named ``shape_name`` (a smoke
    config, a block's own job); ``state_bits`` the overrides'
    moments."""
    name = configs.canonical(arch)
    cfg = cfg or configs.get(name)
    shape = shape or configs.shape(shape_name)
    if microbatch:
        shape = dataclasses.replace(shape, microbatch=microbatch)
    if mesh is None:
        mesh = block_mesh(None, multi_pod)
    mshape = tuple(int(n) for n in mesh.mesh.shape)
    axis_names = tuple(mesh.mesh_dim_names)
    axes = plans.MeshAxes.from_mesh(mesh)
    gaps: List[str] = []
    no_tp = False
    if shape.kind == "train":
        over = TRAIN_OVERRIDES.get(name, {})
        if over.get("microbatch") and not microbatch:
            shape = dataclasses.replace(shape, microbatch=over["microbatch"])
        # no_tp folds the model axis into dp where the batch splits over
        # it, as the reference's (not on the 512-rank mesh at batch 256)
        no_tp = bool(over.get("no_tp")) and not multi_pod
        if no_tp:
            axes = plans.MeshAxes(dp=tuple(axis_names), model="model")
    tp = None if no_tp else plans.tp_layout(cfg, mesh)
    if tp is not None:
        gaps += [f"8g: {rule} kept in 8a's layout (every rank of a model "
                 f"column computes it whole)" for rule in tp.kept]
    n_micro = max(1, shape.microbatch) if shape.kind == "train" else 1
    shards = pipeline.batch_shards(mesh, axes.dp, n_micro)
    B = shape.global_batch
    split = shards.split(B)
    rows = len(shards.rows(B))
    # a serve batch that does not split: the cache's positions do where
    # the reference's cache spec shards them (an attention cache)
    seq = (shape.kind != "train" and not split
           and plans.seq_splits(cfg, B, shape.seq_len, shards.dp))
    if not split and shards.dp > 1 and shape.kind == "train":
        gaps.append(f"8g: a batch of {B} rows does not split over "
                    f"{shards.dp} data ranks: every rank holds the "
                    f"whole batch")
    ctx = shard_ctx.ShardCtx(mesh, axes.dp, "model", shards_batch=split,
                             tp=tp, seq_split=seq)
    params_abs = model_lib.abstract_params(cfg)
    if shape.kind == "train":
        bits = state_bits if state_bits is not None else over.get(
            "state_bits")
        opt_cfg = opt_lib.OptConfig(state_bits=bits)
        lay = plans.state_layouts(params_abs, mesh, axes,
                                  state_bits=bits, no_tp=no_tp)
        state = train_lib.make_sharded_train_state(cfg, 0, opt_cfg, lay,
                                                   device="cpu")
        step = train_lib.make_train_step(cfg, shape, opt_cfg,
                                         accum=over.get("accum", "f32"))
        batch = _fake_inputs(pipeline.batch_shapes(cfg, shape), rows)

        def run():
            with shard_ctx.use(ctx):
                return step(state, batch)
        entry = "train_step"
    else:
        lay = plans.state_layouts(params_abs, mesh, axes, train=False)
        params = model_lib.place_params(cfg, lay["params"], seed=0,
                                        device="cpu")
        smax = shape.seq_len
        cache = model_lib.init_cache(
            cfg, rows, smax, "cpu",
            kv_split=tp.model if tp and tp.computes("attn") else 1,
            mamba_split=tp.model if tp and tp.computes("mamba") else 1,
            xlstm_split=tp.model if tp and tp.computes("mlstm") else 1,
            seq_split=shards.dp if seq else 1)
        state = {"params": params, "cache": cache}
        cache_meta = cache_bytes(cfg, cache, B, smax, mesh, axes)
        if shape.kind == "prefill":
            pf = serve_lib.make_prefill_step(cfg)
            batch = _fake_inputs(pipeline.prefill_shapes(cfg, shape), rows)

            def run():
                with torch.no_grad(), shard_ctx.use(ctx):
                    return pf(params, batch, cache)
            entry = "prefill_step"
        else:
            lo = int(shards.rows(B)[0]) if split else 0
            dec = serve_lib.on_mesh(serve_lib.make_decode_step(cfg), ctx,
                                    (lo, lo + rows, B))
            token = torch.zeros((B, 1), dtype=torch.int32)
            cache_len = torch.tensor(smax - 1, dtype=torch.int32)

            def run():
                with torch.no_grad():
                    return dec(params, token, cache, cache_len)
            entry = "decode_step"
    meta = {
        "arch": arch, "shape": shape_name, "entry": entry,
        "mesh_layout": "x".join(map(str, mshape)) + "(" + ",".join(axis_names)
        + ")",
        "n_chips": math.prod(mshape),
        "model_flops": _model_flops(cfg, shape),
        "microbatch": shape.microbatch if shape.kind == "train" else None,
        "rows_per_rank": rows,
    }
    if tp is not None:
        sizes = plans.axis_sizes(mesh)
        meta["model_traffic"] = hlo_analysis.tp_traffic(cfg, shape, sizes)
        meta["model_traffic"]["8d_whole"] = hlo_analysis.tp_traffic(
            cfg, shape, sizes, exchange=False)["8d"]
    if shape.kind != "train":
        meta["cache"] = cache_meta
    return Cell(run, state, meta, gaps), meta


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             microbatch: Optional[int] = None, smoke: bool = False,
             shape: Optional[ShapeConfig] = None,
             mesh_shape: Optional[tuple] = None,
             state_bits: Optional[int] = None,
             n_layers: Optional[int] = None) -> Dict[str, Any]:
    """One cell's dry run on a fake process group of its mesh's ranks:
    its line (module docstring).  ``n_layers``: the arch cut to that many
    layers, as a block's own job may cut it."""
    cfg = configs.get_smoke(arch) if smoke else None
    if n_layers:
        cfg = (cfg or configs.get(arch)).replace(n_layers=n_layers)
    if shape is None:
        status = configs.cell_status(arch, shape_name)
    elif shape.kind == "decode" and (cfg or configs.get(arch)).is_encoder:
        status = "skip: encoder-only arch has no autoregressive decode"
    else:
        status = "run"
    base = {"arch": arch, "shape": shape_name,
            "mesh": "multi" if multi_pod else "single", "status": status}
    if status != "run":
        return base
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    mshape = tuple(mesh_shape) if mesh_shape else PRODUCTION[multi_pod][0]
    fake_world(math.prod(mshape))
    t0 = time.time()
    mesh = block_mesh(mesh_shape, multi_pod)
    # the mesh's own tensors are real: the fake mode takes them as inputs
    with FakeTensorMode(allow_non_fake_inputs=True):
        cell, meta = lower_cell(arch, shape_name, multi_pod=multi_pod,
                                microbatch=microbatch, cfg=cfg, shape=shape,
                                mesh=mesh, state_bits=state_bits)
        t_build = time.time() - t0
        held = state_bytes(cell.state)
        per_pod = (math.prod(mshape[1:])
                   if len(mshape) == 3 and mshape[0] > 1 else None)
        counter = StepCounter(ranks_per_pod=per_pod)
        flops = FlopCounterMode(display=False)
        mem = MemTracker()
        mem.track_external(*_local_tensors(cell.state))
        ops.reset_fake_cost()
        t0 = time.time()
        with mem, flops, counter:
            cell.run()
        t_run = time.time() - t0
        peak = max(v["Total"] for v in
                   mem.get_tracker_snapshot("peak").values())
    counts = counter.counts()
    counts["flops"] = float(flops.get_total_flops()) + ops.FAKE_COST["flops"]
    counts["bytes"] += ops.FAKE_COST["bytes"]
    counts["peak_bytes"] = int(peak)
    roof = hlo_analysis.analyze(counts, n_chips=meta["n_chips"],
                                model_flops=meta["model_flops"])
    base.update(meta)
    base.update({
        "status": "ok",
        "build_s": round(t_build, 2), "run_s": round(t_run, 2),
        "kernels": dict(ops.FAKE_COST["calls"]),
        "memory": {"state_bytes": held, "peak_bytes_per_device": int(peak),
                   "device_bytes": DEVICE_BYTES,
                   "fits": bool(peak <= DEVICE_BYTES)},
        "gaps": cell.gaps,
        "roofline": roof.to_dict(),
    })
    return base


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--out", default=None, help="append JSONL here")
    # a block's own job in place of a cell of the table (the port's)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config")
    ap.add_argument("--kind", choices=["train", "prefill", "decode"],
                    default=None, help="with --seq-len and --global-batch: "
                    "a shape of one's own, named by --shape or 'custom'")
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--state-bits", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="the arch cut to this many layers")
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 1,1 or 2,2,1: a mesh of that many fake ranks "
                    "(axes (data, model) or (pod, data, model))")
    args = ap.parse_args(argv)
    # DTensor warns at every redistribution over two mesh dims
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    shape = None
    if args.kind:
        shape = ShapeConfig(args.shape or "custom", args.kind,
                            seq_len=args.seq_len,
                            global_batch=args.global_batch,
                            microbatch=args.microbatch or 1)
    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split(","))
                  if args.mesh_shape else None)
    cells = []
    if args.all:
        for a, s, _ in configs.all_cells():
            cells.append((a, s))
    else:
        assert args.arch and (args.shape or shape), \
            "--arch/--shape or --all required"
        cells.append((configs.canonical(args.arch),
                      args.shape or shape.name))

    rc = 0
    for arch, shape_name in cells:
        for mp in meshes:
            try:
                res = run_cell(arch, shape_name, multi_pod=mp,
                               microbatch=args.microbatch, smoke=args.smoke,
                               shape=shape, mesh_shape=mesh_shape,
                               state_bits=args.state_bits,
                               n_layers=args.n_layers)
            except Exception as e:
                res = {"arch": arch, "shape": shape_name,
                       "mesh": "multi" if mp else "single",
                       "status": f"FAIL: {type(e).__name__}: {e}"}
                rc = 1
            line = json.dumps(res)
            print(line, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    if dist.is_initialized():
        dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    sys.exit(main())
