"""BlockRuntime — the per-tenant execution engine (the port of
``repro.core.runtime``).

A train block (``kind="train"``) runs ``train_step`` on its device: each
``step()`` takes the synthetic batch for its step count, runs the forward,
the backward and the AdamW update, and returns the step's metrics.

A serve block runs one of two data planes on its device:

* **dense** — batched ``prefill`` then one ``decode_step`` per ``step()``
  against a dense KV cache (``repro_torch.launch.serve``);
* **paged** (``JobSpec(paged=True)``) — a ``DecodeScheduler`` multiplexing
  many generate sessions over one page pool, driven through
  ``start_session``/``feed``/``harvest`` or the in-flight window.

The dense family runs every kind and plane.  The hybrid family (zamba2)
trains, and serves on the dense plane only: its recurrent state does not
page, so a paged job raises the reference's ``ValueError``.  The VLM
(pixtral) trains and serves; its dense-plane prefill takes the batch's
``patches`` in front of its tokens.  The encoder (hubert) trains; it has
no decode path (the launcher refuses to serve it, as the reference's
does).  The moe family trains (MLA's flash backward at head dim 192) and
serves on the dense plane (its decode captured as the dense family's),
and llama4 (GQA) on the paged plane too; MLA's compressed cache does not
page (the reference's ``ValueError``).  The xlstm family trains, and
serves on the dense plane only (its recurrent state does not page, the
reference's ``ValueError``): its cache is the mLSTM and sLSTM states
(tuples, as the reference's), updated in place by the captured decode
step and carried through a suspend and resume like any cache.

One departure from the reference: after a prefill the reference sets
``cache_len`` to ``tokens.shape[1]`` (``repro/core/runtime.py``'s
``prefill``), although the prefill filled ``n_patches + T`` cache rows
when the batch has patches, so each of its VLM decode steps writes and
reads K/V ``n_patches`` positions too early.  Here ``cache_len`` is the
embedded length, ``n_patches + T``, where the reference's own model test
decodes too.

A block may span several devices (item 8a for a train block, 8c for a
serve block), and several blocks run at once on disjoint subsets of the
ranks (item 8b).  The process
runs as one rank of a ``torch.distributed`` process group, and every
rank runs the same control plane with the same calls, so every rank
reaches the same grants (``core.controller``).  A block's chips name
its ranks (``device.block_ranks``: at most one chip of each rank), and
``_attach`` builds the block's DeviceMesh ``("data", "model")`` of
``grant.mesh_shape`` over those ranks only, with groups of its own
(``launch.mesh.make_block_mesh``, which every rank enters for every
block); a ``BlockRuntime`` is built only on the block's ranks, and every
other rank follows the block's lifecycle with an ``OffRankRuntime``,
which holds nothing of it.  Every rank records each step as the block's
first rank measured it (``first_ranks_record``), so the quota and
deadline decisions that read step times agree.  A train block's state
lies on its mesh as the reference's plan shards it (``sharding.plans``):
each rank holds its shards of the params, the moments and the grads;
each group's params are gathered for its use (ZeRO-3); the batch is
split over ``data``
(each rank its rows of every microbatch, ``pipeline.BatchShards``), and
the ranks of a ``model`` column split the heads, the MLP widths, the
vocabulary and the experts between them (item 8d: the block's
``plans.tp_layout``, built into its ``ShardCtx``; where the layout keeps
a part in 8a's layout, every rank of the column computes it whole).
``init_state``
draws every leaf as the unsharded init does, one group at a time, and
keeps the rank's slices.  Checkpoints hold whole leaves, written by the
block's first rank, so a resume or a migration may come with another
mesh shape and other ranks.  A serve block's params lie and are
gathered as a train block's, forward only.  On the dense plane each
rank holds its rows of the prompt batch and the cache (``data``;
every rank the whole batch where the rows do not split, and then, for
an attention cache whose positions split over the data ranks, GQA's or
MLA's compressed one, its slice of the positions,
``ShardCtx.seq_split``, as the reference's cache spec shards them) and,
where the attention or Mamba2 computes sharded over
``model``, the cache of its kv heads and Mamba2 heads only
(``plans.cache_layouts``, ``init_cache``'s ``kv_split``,
``mamba_split`` and ``seq_split``; a rank's ``conv`` state holds its
heads' channels, joined whole for a checkpoint, ``_conv``), the MoE
layers routing each data shard's rows as one group, as the reference's
do, and the decode step
(``serve_step.on_mesh``) takes and gives the whole batch's tokens, so
``token`` is the whole batch's on every rank.  On the paged plane every
rank holds the whole page pool and runs every slot with no sharding
context (one routing group a round, as the reference's scheduler), the
block's first rank's tokens broadcast each round.  The decode context
checkpoints as whole leaves too, and restores as each rank's rows and
heads of them on any mesh.  Under a process group a block takes this
path even at (1, 1), where every collective of the model column is
skipped.  A block of several devices in a process with no process
group raises: nothing runs a sharded block on one rank.

Steps are built through ``compile_cache.GLOBAL`` under the reference's
keys (``_cache_key``), the mesh's fingerprint replaced by the device's.
A dense serve block's decode step runs as a ``CapturedStep``: the first
step on the card captures it as a CUDA graph with the block's params,
cache and a device ``cache_len`` scalar bound (and a sampling job's
generator registered; on a mesh, the gathers inside it), and every
later step refills the scalar and replays the graph (on the CPU the step
runs eagerly).  The train step
and prefill run eagerly.

Preemption: ``suspend()`` drains the in-flight window, writes a
synchronous checkpoint (``repro_torch.checkpoint.manager``, the
reference's format) and drops every device reference, then hands the
freed memory back to the card, so another block can have it;
``resume(grant, devices)`` rebuilds the runtime on the given device and
restores the suspended state into restore targets on the ``meta`` device
(no random init).  ``rebuild`` starts a new runtime from an old block's
checkpoints; under a process group the controller resumes a block that
way, since the block may come back on other ranks.  ``suspend()`` also
releases the block's captured graphs and their memory pools; a resumed
block gets its steps from the compile cache (a hit) and captures again
at its first step.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.block import BlockGrant
from repro_torch.core.inflight import InflightWindow
from repro_torch.data import pipeline
from repro_torch.device import (block_ranks, device_of, from_rank, rank,
                                rank_device, world_size)
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.serve import serve_step as serve_lib
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding import plans
from repro_torch.train import compile_cache
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as train_lib

@dataclasses.dataclass
class JobSpec:
    cfg: ModelConfig
    shape: ShapeConfig
    kind: str = "train"              # train | serve
    opt: opt_lib.OptConfig = dataclasses.field(
        default_factory=opt_lib.OptConfig)
    seed: int = 0
    decode_sample: bool = False      # serve: sample instead of greedy argmax
    collect_metrics: bool = False    # carry step metrics (loss, grad_norm)
                                     # through the async window into each
                                     # completion record (extra host
                                     # transfers per step; callers that
                                     # log every step opt in)
    ckpt_namespace: Optional[str] = None  # stable checkpoint namespace so a
                                          # relaunched launcher can
                                          # --resume; default: the (random)
                                          # block id
    ckpt_every: int = 0              # periodic checkpoint interval (read by
                                     # the reference's autostep engine;
                                     # client-driven launchers call save()
                                     # between batches themselves)
    # ---- serve: continuous batching over a paged KV cache ----
    paged: bool = False              # serve: slot-batched generate sessions
                                     # over a shared page pool instead of the
                                     # single dense prefill/decode context
    page_size: int = 16              # rows per KV page
    n_pages: int = 0                 # pool size; 0 derives full residency
                                     # (max_slots * pages_per_seq + trash)
    max_slots: int = 8               # concurrent decode batch width
    max_seq_len: int = 0             # per-session context cap; 0 -> shape.seq_len


@dataclasses.dataclass
class SimJobSpec:
    """Device-free stand-in for a JobSpec: activating a block with one
    boots a ``scheduler.SimRuntime`` (wall-clock step model with the full
    suspend/resume preemption surface) instead of building a real
    runtime, so admission, dispatch, preemption and expiry run without a
    device."""
    step_s: float = 0.001
    ckpt_every: int = 0


class BlockRuntime(InflightWindow):
    """``ckpt_root``: where the block's checkpoints go, under the job's
    ``ckpt_namespace`` (default: the block id); without one, the
    checkpoint calls raise."""

    def __init__(self, grant: BlockGrant, job: JobSpec,
                 devices: Optional[Sequence] = None,
                 ckpt_root: Optional[str] = None):
        if job.kind not in ("train", "serve"):
            raise ValueError(f"kind must be 'train' or 'serve', got "
                             f"{job.kind!r}")
        if job.kind == "serve" and job.paged:
            model_lib.check_paged_support(job.cfg)
        self.job = job
        self.ckpt = (CheckpointManager(
            ckpt_root, namespace=job.ckpt_namespace or grant.block_id)
            if ckpt_root is not None else None)
        self.model: Optional[model_lib.Transformer] = None
        self.state: Any = None
        self.cache: Any = None
        self.sessions = None         # paged serve: the DecodeScheduler
        self._emissions: list = []   # paged serve: buffered generate events
        self.step_count = 0
        self.paged_rounds = {"decoded": 0, "empty": 0}   # paged serve:
                                     # rounds that ran a decode call, and
                                     # rounds that found no active slot
                                     # (the engine can dispatch one after
                                     # the last session ended); kept across
                                     # suspend/resume
        self.last_saved_step = 0     # step_count at the last checkpoint
        self.suspended = False
        self._init_window()
        self._attach(grant, devices)

    def _attach(self, grant: BlockGrant,
                devices: Optional[Sequence]) -> None:
        """Bind to the block's devices (``cuda`` per chip by default): one
        device, or under a process group the block's mesh over its
        ranks."""
        if devices is None:
            devices = ["cuda"] * grant.n_chips
        job = self.job
        devs = [device_of(d) for d in devices]
        self.mesh = self.ctx = self.batch_shards = self.tp = None
        self.ranks = check_block(grant, devices)
        if self.ranks is not None:
            self._attach_mesh(grant, devs)
        elif len(set(devs)) > 1:
            n = len(devs)
            raise RuntimeError(
                f"a block of {n} devices needs a process group of {n} "
                f"ranks (torch.distributed, one rank a device), and this "
                f"process has none")
        else:
            self.device = devs[0]
        self.grant = grant
        self.devices = devs
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(job.seed + 1)
        self._prefill_fn = None      # built at the first prefill()
        if job.kind == "train":
            step = self._cached(
                self._cache_key("train_step", compile_cache.freeze(job.opt),
                                ("donate", 0)),
                lambda: train_lib.make_train_step(job.cfg, job.shape,
                                                  job.opt), "train_step")
            self._step = step if self.ctx is None else self._in_ctx(step)
            self.data = pipeline.DataIterator(
                job.cfg, job.shape, seed=job.seed, device=self.device,
                shardings=self.batch_shards)
        elif job.paged:
            # the DecodeScheduler owns its prefill/decode; built in
            # init_state (it needs the params)
            self._step = None
        else:
            decode = self._cached(
                self._cache_key("decode_step", job.decode_sample,
                                ("donate", 2)),
                lambda: serve_lib.make_decode_step(
                    job.cfg, sample=job.decode_sample), "decode_step")
            if self.ctx is not None:
                decode = serve_lib.on_mesh(decode, self.ctx, self.rows)
            # the graph binds this block's params (0), cache (2) and
            # position scalar (3) (and a sampling job's generator), so it
            # is the block's own
            self._step = compile_cache.CapturedStep(
                decode, static=(0, 2, 3), donate=(2,),
                warm_inplace=self._appended)
            self._cache_len_dev = torch.zeros((), dtype=torch.int32,
                                              device=self.device)

    def _attach_mesh(self, grant: BlockGrant, devs) -> None:
        """The block's DeviceMesh over its ranks, this rank's device and,
        for a train block or the dense serve plane, its rows of the batch
        and the sharding context of its steps (the paged plane's rounds
        run with none: every rank runs every slot, the MoE layers routing
        a round's tokens as one group, as the reference's context-free
        scheduler does)."""
        from repro_torch.launch.mesh import make_block_mesh
        self.mesh = make_block_mesh(self.ranks, grant.mesh_shape)
        self.groups_released = False
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise RuntimeError(
                f"rank {rank()} is outside the block on ranks "
                f"{self.ranks}: a rank outside a block follows it with an "
                f"OffRankRuntime")
        self.device = rank_device(devs[0].type)
        self.axes = plans.MeshAxes(dp=("data",), model="model")
        self.tp = plans.tp_layout(self.job.cfg, self.mesh,
                                  paged=self.job.paged)
        if self.job.paged:
            return
        shape = self.job.shape
        self.batch_shards = pipeline.BatchShards(
            grant.mesh_shape[0], coord[0], max(1, shape.microbatch))
        B = shape.global_batch
        split = self.batch_shards.split(B)
        # a serve batch that does not split over data: its cache's
        # positions do, where the reference's cache spec shards them
        seq = (self.job.kind == "serve" and not split and plans.seq_splits(
            self.job.cfg, B, shape.seq_len, grant.mesh_shape[0]))
        self.ctx = shard_ctx.ShardCtx(self.mesh, ("data",), "model",
                                      shards_batch=split, tp=self.tp,
                                      seq_split=seq)
        if self.job.kind == "serve":
            rows = self.batch_shards.rows(B)
            self.rows = (int(rows[0]), int(rows[-1]) + 1, B)

    def _appended(self, t) -> bool:
        """Whether ``t`` is one of the dense decode cache's attention
        leaves (GQA ``k``/``v``, MLA ``c_kv``/``k_rope``), which a decode
        step writes only at row ``cache_len``, from its other inputs: the
        captured step's warm-up writes them in place
        (``CapturedStep.warm_inplace``)."""
        return any(t is leaf for path, leaf in transformer.flatten(
            self.cache or {}) if path.split("/")[-1] in (
                "k", "v", "c_kv", "k_rope"))

    def _in_ctx(self, step):
        ctx = self.ctx

        def fn(state, batch):
            with shard_ctx.use(ctx):
                return step(state, batch)
        return fn

    def state_layouts(self):
        """The sharded state's ``plans.Layout`` tree: the params as the
        plan shards them and, for a train block, the moments as
        ``plans.moment_specs``."""
        job = self.job
        return plans.state_layouts(
            model_lib.abstract_params(job.cfg), self.mesh, self.axes,
            train=job.kind == "train",
            state_bits=job.opt.state_bits if job.kind == "train" else None)

    def cache_layouts(self):
        """The dense serve plane's cache on the mesh: this rank's rows of
        the batch, or of a batch that does not split its slice of the
        positions; where the attention or Mamba2 computes sharded over
        ``model``, its kv heads and ``ssm`` heads
        (``plans.cache_layouts``; the ``conv`` state's layout is its
        whole leaf, ``_conv``)."""
        shape = self.job.shape
        return plans.cache_layouts(
            serve_lib.abstract_cache(self.job.cfg, shape.global_batch,
                                     shape.seq_len),
            self.mesh, self.axes, split=self.ctx.shards_batch, tp=self.tp,
            seq=self.ctx.seq_split)

    def _conv(self, cache, fn):
        """``cache`` with its Mamba2 ``conv`` state passed through ``fn``
        (``transformer.conv_whole`` for a save, ``conv_of_rank`` after a
        restore) where the block computes Mamba2's heads sharded: a rank
        holds its heads' channels, the checkpoint the whole leaf."""
        if not (self.tp is not None and self.tp.computes("mamba")):
            return cache
        with shard_ctx.use(self.ctx):
            conv = fn(cache["mamba"]["conv"], self.job.cfg)
        return {**cache, "mamba": {**cache["mamba"], "conv": conv}}


    # ------------------------------------------------------------ compile
    def _cache_key(self, family: str, *extra) -> tuple:
        """Logical build signature: everything the built step can depend
        on.  ``seed``/checkpoint fields deliberately excluded."""
        job = self.job
        where = compile_cache.device_fingerprint(self.device)
        if self.mesh is not None:
            where += (("mesh",) + tuple(self.grant.mesh_shape),)
        return (family, compile_cache.freeze(job.cfg),
                compile_cache.freeze(job.shape), where) + extra

    def _cached(self, key, builder, label: str):
        return compile_cache.GLOBAL.get(
            key, builder, label=label, block_id=self.grant.block_id)

    @property
    def decode_graph(self) -> Optional[compile_cache.CapturedStep]:
        """The block's captured decode step (the dense plane's, or the
        paged plane's round), None for a train block."""
        if self.sessions is not None:
            return self.sessions.decode_graph
        if isinstance(self._step, compile_cache.CapturedStep):
            return self._step
        return None

    def _release_graphs(self) -> None:
        graph = self.decode_graph
        if graph is not None:
            graph.release()

    # --------------------------------------------------------------- state
    def init_state(self, params: Optional[Dict[str, Any]] = None,
                   opt_state: Optional[Dict[str, Any]] = None) -> None:
        """Install the model (random weights from ``job.seed``, or the given
        param tree, e.g. weights moved across with ``interop``) and, for a
        train block, the optimizer state (fresh, or the given one), for a
        serve block the empty decode context."""
        job = self.job
        if job.kind == "train":
            if self.ctx is not None:
                self.state = train_lib.make_sharded_train_state(
                    job.cfg, job.seed, job.opt, self.state_layouts(),
                    params=params, opt_state=opt_state, device=self.device)
                return
            self.state = train_lib.make_train_state(
                job.cfg, job.seed, job.opt, params=params,
                opt_state=opt_state, device=self.device)
            return
        self._install_params(params)
        if job.paged:
            self.sessions = self._make_scheduler(self.state["params"])
            self.token = self.sessions.last_tokens_dev
            return
        B = job.shape.global_batch
        lo, hi, _ = self.rows if self.ctx is not None else (0, B, B)
        # the kv heads, Mamba2 and xLSTM heads split over ``model``
        # where they compute sharded, the positions over ``data`` where
        # they split
        tp = self.tp
        self.cache = model_lib.init_cache(
            job.cfg, hi - lo, job.shape.seq_len, self.device,
            kv_split=tp.model if tp and tp.computes("attn") else 1,
            mamba_split=tp.model if tp and tp.computes("mamba") else 1,
            xlstm_split=tp.model if tp and tp.computes("mlstm") else 1,
            seq_split=(self.batch_shards.dp
                       if self.ctx is not None and self.ctx.seq_split
                       else 1))
        self.cache_len = 0
        self.token = torch.zeros((B, 1), dtype=torch.int32,
                                 device=self.device)

    def _install_params(self, params: Optional[Dict[str, Any]]) -> None:
        """A serve block's model around ``params`` (random from
        ``job.seed`` when None); on a mesh, every leaf a DTensor of this
        rank's shards (``model.place_params``: the unsharded init's
        draws, or the given tree, sliced)."""
        job = self.job
        if self.mesh is not None:
            params = model_lib.place_params(
                job.cfg, self.state_layouts()["params"], seed=job.seed,
                params=params, device=self.device)
        self.model = model_lib.Transformer(job.cfg, params, seed=job.seed,
                                           device=self.device)
        self.state = {"params": self.model.params}

    def _paged_geometry(self) -> Dict[str, int]:
        job = self.job
        return dict(page_size=job.page_size, n_pages=job.n_pages,
                    max_slots=job.max_slots, max_seq_len=_max_seq_len(job))

    def _make_scheduler(self, params, init_pool: bool = True):
        """The paged plane's scheduler; on a mesh of several ranks each
        round's tokens are the block's first rank's, broadcast over the
        block's group."""
        from repro_torch.serve.decode_scheduler import DecodeScheduler
        job = self.job
        group = None
        if self.mesh is not None and len(self.ranks) > 1:
            from repro_torch.launch.mesh import block_group
            group = block_group(self.mesh)
        return DecodeScheduler(job.cfg, params, sample=job.decode_sample,
                               seed=job.seed, init_pool=init_pool,
                               device=self.device, group=group,
                               src=self.ranks[0] if group else 0,
                               **self._paged_geometry())

    def prefill(self, batch: Dict[str, Any]) -> None:
        """Dense serve blocks: process a prompt batch into the KV cache and
        seed the decode loop with the first generated token."""
        if self.job.paged:
            raise ValueError("a paged serve block prefills each session at "
                             "admission: use start_session()")
        if self._prefill_fn is None:
            self._prefill_fn = self._cached(
                self._cache_key("prefill_step"),
                lambda: serve_lib.make_prefill_step(self.job.cfg),
                "prefill_step")
        batch = {k: torch.as_tensor(v) for k, v in batch.items()
                 if k in ("tokens", "patches")}
        if self.batch_shards is not None:       # this rank's rows
            batch = pipeline.make_global_batch(batch, self.batch_shards,
                                               self.device)
        else:
            batch = {k: v.to(self.device) for k, v in batch.items()}
        with shard_ctx.use(self.ctx):
            logits, self.cache = self._prefill_fn(self.state["params"],
                                                  batch, self.cache)
            self.token = shard_ctx.gather_rows(
                torch.argmax(logits, -1)[:, None].to(torch.int32))
        # patches + tokens: the module docstring's one departure
        self.cache_len = model_lib.embedded_len(self.job.cfg, batch)

    # ------------------------------------------------- generate sessions
    # (paged serve only: the continuous-batching session surface)
    def start_session(self, prompt: Sequence[int], max_new_tokens: int = 16,
                      eos_id: Optional[int] = None) -> str:
        """Queue a generate session; tokens are emitted by subsequent decode
        steps and drained with ``harvest()`` (window-driven) or returned
        directly by ``feed()`` (client-driven)."""
        if self.sessions is None:
            raise ValueError("block has no generate surface "
                             "(needs a paged serve job)")
        return self.sessions.submit(prompt, max_new_tokens=max_new_tokens,
                                    eos_id=eos_id)

    def feed(self, rounds: int = 1) -> list:
        """Client-driven decode: run ``rounds`` continuous-batching steps
        synchronously and return their emissions (buffered ones first)."""
        if self.sessions is None:
            raise ValueError("feed() needs a paged serve job")
        # client-driven: the block's own ranks' emissions (``harvest``'s
        # broadcast to every rank is the engine's, round by round)
        out, self._emissions = self._emissions, []
        for _ in range(rounds):
            out.extend(self._round())
            self.step_count += 1
        return out

    def _round(self) -> list:
        """One continuous-batching round, counted in ``paged_rounds``."""
        out = self.sessions.step()
        self.paged_rounds["decoded" if self.sessions.round_decoded
                          else "empty"] += 1
        return out

    def harvest(self) -> list:
        """Drain emissions buffered by window-dispatched decode steps.
        Under a process group of several ranks a paged block's emissions
        are its first rank's, on every rank (``emissions_from``, a
        broadcast every rank enters as it harvests), so every rank's bus
        publishes the same tokens and session edges."""
        out, self._emissions = self._emissions, []
        if self.job.paged and on_several_ranks(self):
            from repro_torch.serve.decode_scheduler import emissions_from
            out = emissions_from(self.ranks[0], out)
        return out

    @property
    def idle_serve(self) -> bool:
        """True when dispatched steps would be no-ops (paged serve with no
        active or queued session)."""
        return self.sessions is not None and not self.sessions.has_work

    # ---------------------------------------------------------------- step
    def _decode_once(self):
        if self.job.paged:
            self._emissions.extend(self._round())
            self.token = self.sessions.last_tokens_dev
            return
        # a launch, not a sync: the replay reads the scalar on the device
        self._cache_len_dev.fill_(self.cache_len)
        self.token, self.cache = self._step(
            self.state["params"], self.token, self.cache,
            self._cache_len_dev,
            self._gen if self.job.decode_sample else None)
        self.cache_len += 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _train_once(self) -> Dict[str, torch.Tensor]:
        batch = self.data.batch(self.step_count)
        self.state, metrics = self._step(self.state, batch)
        return metrics

    def step(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        if self.job.kind == "train":
            metrics = {k: float(v) for k, v in self._train_once().items()}
        else:
            self._decode_once()
            metrics = {}
        self._sync()
        self.step_count += 1
        metrics["step_s"] = time.perf_counter() - t0
        return metrics

    def step_async(self):
        """Dispatch one step without waiting for the device; a train step
        returns its metrics as device tensors."""
        if self.job.kind == "train":
            metrics = self._train_once()
        else:
            self._decode_once()
            metrics = {}
        self.step_count += 1
        return metrics

    # ------------------------------------------------- in-flight dispatch
    # window bookkeeping lives in InflightWindow; a step's completion token
    # is a CUDA event recorded after it (None on the CPU, where eager ops
    # have finished when they return), paired with the step's metric
    # tensors when the job collects metrics
    def _launch(self):
        metrics = self.step_async()
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        if self.job.collect_metrics:
            return (ev, metrics)
        return ev

    @staticmethod
    def _event(token):
        return token[0] if isinstance(token, tuple) else token

    def _token_ready(self, token) -> bool:
        ev = self._event(token)
        if ev is not None and on_several_ranks(self):
            ev.synchronize()         # every rank harvests alike
            return True
        return ev is None or ev.query()

    def _token_wait(self, token) -> None:
        ev = self._event(token)
        if ev is not None:
            ev.synchronize()

    def _completion_record(self, dispatch_t: float, token) -> Dict[str, float]:
        rec = super()._completion_record(dispatch_t, token)
        if isinstance(token, tuple):
            rec.update({k: float(v) for k, v in token[1].items()})
        return first_ranks_record(self, rec)

    # ----------------------------------------------------------- persist
    def _manager(self) -> CheckpointManager:
        if self.ckpt is None:
            raise ValueError("this block has no checkpoint root: build it "
                             "with BlockRuntime(..., ckpt_root=...)")
        return self.ckpt

    def _decode_ctx(self) -> Dict[str, Any]:
        """A serve block's generation context: without it a restored
        decoder would restart from an empty cache at position 0.  Paged
        serve saves the whole continuous-batching plane (page pool, page
        tables, per-slot lengths, session metadata).  ``cache_len`` is an
        int32 0-d leaf, as the reference's."""
        if self.job.paged:
            return {"paged": self.sessions.state_tree()}
        cache = self.cache
        if self.ctx is not None:        # this rank's rows of each leaf
            cache = pytree.tree_map(
                lambda lay, t: lay.wrap(t), self.cache_layouts(),
                self._conv(cache, transformer.conv_whole))
        return {"cache": cache, "token": self.token,
                "cache_len": torch.tensor(self.cache_len,
                                          dtype=torch.int32)}

    def _abstract_like(self) -> Dict[str, Any]:
        """Restore targets on the ``meta`` device: a resume allocates no
        state just to overwrite it."""
        job = self.job
        if job.kind == "train":
            return train_lib.abstract_train_state(job.cfg, job.opt)
        return {"params": model_lib.abstract_params(job.cfg)}

    def _abstract_decode(self) -> Dict[str, Any]:
        if self.job.paged:
            from repro_torch.serve.decode_scheduler import DecodeScheduler
            return {"paged": DecodeScheduler.abstract_state(
                self.job.cfg, **self._paged_geometry())}
        shape = self.job.shape
        B = shape.global_batch
        return {"cache": serve_lib.abstract_cache(self.job.cfg, B,
                                                  shape.seq_len),
                "token": torch.empty((B, 1), dtype=torch.int32,
                                     device="meta"),
                "cache_len": torch.empty((), dtype=torch.int32,
                                         device="meta")}

    def _payload(self) -> Dict[str, Any]:
        payload = {"state": self.state, "step_count": self.step_count}
        if self.job.kind == "serve":
            payload["decode"] = self._decode_ctx()
        return payload

    def save(self, async_: bool = True) -> None:
        """Checkpoint the block at its step count.  ``async_``: the copy
        to the host happens now, the files are written in the
        background."""
        ckpt = self._manager()
        if self.state is None:
            raise ValueError("nothing to save: the block has no state")
        payload = self._payload()
        if async_:
            ckpt.save_async(self.step_count, payload)
        else:
            ckpt.save(self.step_count, payload)
        self.last_saved_step = self.step_count

    @property
    def progress_lost(self) -> int:
        """Steps of work beyond the last checkpoint: what an eviction
        without ``suspend()`` would throw away."""
        return max(0, self.step_count - self.last_saved_step)

    def suspend(self) -> Dict[str, float]:
        """Preemption: drain in-flight dispatches, checkpoint synchronously,
        drop every device reference and hand the freed memory back to the
        card.  The runtime object survives (job spec and checkpoint
        namespace) and is rebuilt on a device with ``resume``."""
        ckpt = self._manager()
        drained = self.drain()
        ckpt.wait()                      # an async save may still be landing
        self.save(async_=False)
        self.release()
        return {"step": self.step_count, "drained_steps": len(drained)}

    def release(self) -> None:
        """Drop every device reference of the block (its state, cache,
        decode graphs and batches) and hand the freed memory back to the
        card, after the in-flight steps and an async save have landed;
        the step count and the checkpoints stay.  What a suspend does
        after its save, and what a migration does to the old runtime
        before the new one restores: a failed chip's memory is gone
        anyway, and the block's state is not held twice."""
        self.drain()
        if self.ckpt is not None:
            self.ckpt.wait()
        self._release_graphs()
        self.state = None
        self.cache = None
        self.model = None
        self.token = None
        self.cache_len = None
        self.sessions = None         # device pool dropped; host session
                                     # state lives in the checkpoint
        self._step = self._prefill_fn = None
        self._cache_len_dev = None
        self.data = None
        self._gen = None
        device, self.devices = self.device, []
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        self.release_groups()
        self.suspended = True

    def release_groups(self) -> None:
        """The block's mesh back to the pool (``launch.mesh``), as every
        rank does for the block when it moves or ends."""
        release_groups(self)

    def resume(self, grant: BlockGrant, devices: Sequence) -> int:
        """Rebuild after preemption on ``devices`` and restore the
        suspended state from the checkpoint.  Returns the step the block
        resumed at."""
        if not self.suspended:
            raise ValueError("resume() is only legal after suspend()")
        self._attach(grant, devices)
        at = self.restore()
        self.suspended = False
        return at

    def restore(self, step: Optional[int] = None) -> int:
        """Load a checkpoint (the latest unless ``step``) into the block:
        the live state's shapes are the targets, or, with no state, the
        abstract ones.  Returns the restored step."""
        ckpt = self._manager()
        job = self.job
        like = {"state": (self.state if self.state is not None
                          else self._abstract_like()),
                "step_count": self.step_count}
        if job.kind == "serve":
            have_ctx = (self.sessions is not None if job.paged
                        else self.cache is not None)
            like["decode"] = (self._decode_ctx() if have_ctx
                              else self._abstract_decode())
        shardings = None
        if self.mesh is not None:
            like["state"] = self._abstract_like()
            shardings = {"state": self.state_layouts()}
            if job.kind == "serve":
                like["decode"] = self._abstract_decode()
                if not job.paged:
                    shardings["decode"] = {"cache": self.cache_layouts()}
        restored, at = ckpt.restore(like, step=step, device=self.device,
                                    shardings=shardings)
        self._release_graphs()       # they bind the tensors replaced here
        state = restored["state"]
        if self.mesh is not None and job.kind == "train":
            self.state = train_lib.sharded_train_state(state)
        elif job.kind == "train":
            self.state = train_lib.make_train_state(
                job.cfg, job.seed, job.opt, params=state["params"],
                opt_state=state["opt"], device=self.device)
        else:
            self._install_params(state["params"])
            dec = restored["decode"]
            if job.paged:
                if self.sessions is None:   # resume: no throwaway pool
                    self.sessions = self._make_scheduler(
                        self.state["params"], init_pool=False)
                self.sessions.params = self.state["params"]
                self.sessions.load_state(dec["paged"])
                self.token = self.sessions.last_tokens_dev
            else:
                self.cache = pytree.tree_map(lambda t: (
                    t.to_local() if isinstance(t, DTensor) else t),
                    dec["cache"])
                if self.ctx is not None:
                    self.cache = self._conv(self.cache,
                                            transformer.conv_of_rank)
                self.token = dec["token"]
                self.cache_len = int(dec["cache_len"])
        self.step_count = int(restored["step_count"])
        self.last_saved_step = self.step_count   # state == checkpoint now
        if job.paged and on_several_ranks(self):
            # the restored sessions, for the ranks outside the block
            from_rank(self.ranks[0], SessionTable.of(self.sessions))
        return at

    @classmethod
    def rebuild(cls, old, grant: BlockGrant, devices: Sequence,
                ckpt_root: str) -> "BlockRuntime":
        """Failure migration, resize and, under a process group, the
        controller's resume: the old runtime's device state released
        first (a failed chip's memory is gone anyway, and the block's
        state is not held twice), then a new runtime on ``devices`` with
        the block's latest checkpoint restored (the same namespace, its
        manager adopted), or a fresh init when it has none.  Under a
        process group the old block's first rank names the checkpoint for
        every rank, after its last save has landed, so a rank that joins
        the block reads a finished one; ``old`` is then an
        ``OffRankRuntime`` on a rank that was outside the block."""
        old.release()
        old_ckpt = old._manager()
        step = old_ckpt.latest_step()
        if old.ranks is not None:
            step = from_rank(old.ranks[0], step)
        rt = cls(grant, old.job, devices, ckpt_root)
        if step is not None and isinstance(old_ckpt, type(rt.ckpt)):
            rt.ckpt = old_ckpt      # same namespace: adopt its history
        if hasattr(rt, "paged_rounds") and hasattr(old, "paged_rounds"):
            rt.paged_rounds = dict(old.paged_rounds)   # kept, as a resume's
        rt.adopt(step)
        return rt

    def adopt(self, step: Optional[int]) -> None:
        """Take up the block at checkpoint ``step`` (fresh at None)."""
        if step is None:
            self.init_state()
        else:
            self.restore(step)


def release_groups(rt) -> None:
    """``rt``'s block mesh, if it has one, back to the pool, once for each
    time the runtime took one up (a suspended block that then ends gives
    back nothing a second time: another block may hold the mesh by
    then)."""
    if rt.mesh is not None and not rt.groups_released:
        from repro_torch.launch.mesh import release_block_mesh
        release_block_mesh(rt.mesh)
        rt.groups_released = True


def on_several_ranks(rt) -> bool:
    """Whether ``rt``'s block runs under a process group of several ranks,
    where every rank's control plane must see the same completions: its
    scheduler harvests each step in the same order on every rank (a
    completion is waited for, never polled), and every rank records the
    step as the block's first rank measured it."""
    return rt.ranks is not None and world_size() > 1


def first_ranks_record(rt, rec: Dict[str, float]) -> Dict[str, float]:
    """A step's completion record (``step_s`` and the metrics) as the
    block's first rank has it, on every rank: the monitor turns it into
    chip-seconds and the step-time EWMA, which the scheduler's quota
    check and deadline order read, so a rank outside the block (whose
    steps finish as they are dispatched) and the block's other ranks
    (whose clocks differ) decide as the first rank does.  A broadcast
    over the world, which every rank enters as it harvests the step."""
    return from_rank(rt.ranks[0], rec) if on_several_ranks(rt) else rec


def check_block(grant: BlockGrant, devices: Sequence) -> Optional[list]:
    """What every rank checks of a block before it builds or follows it,
    the same on each: a device for each chip of its mesh, and at most one
    chip of each rank.  Returns the block's ranks under a process group,
    else None."""
    n = math.prod(grant.mesh_shape)
    if len(devices) != n:
        raise ValueError(f"a block of mesh {tuple(grant.mesh_shape)} needs "
                         f"{n} devices, got {len(devices)}")
    return block_ranks(devices) if dist.is_initialized() else None


class OffRankRuntime(InflightWindow):
    """A block as a rank outside it follows it (under a process group).

    Every rank runs the same control plane, so every rank's scheduler
    dispatches, harvests, saves, suspends and migrates every block; on a
    rank outside a block those calls reach this stand-in, which holds
    nothing of the block (no state, no device, no group) and runs no
    collective of it, and only keeps what the registry, the scheduler's
    loop and the event stream read: the step count, the saved steps and
    the in-flight window.  It enters the block's mesh creation with the
    block's ranks (``make_block_mesh``), as every rank must.  Its window's
    steps finish as they are dispatched, and each completion records the
    step time and metrics the block's first rank measured
    (``first_ranks_record``).  A paged serve block's sessions are
    followed here too (``SessionTable``: ids, and which sessions are
    queued or running, with no state and no device), so the daemon's
    generate command takes the same session id on every rank, the
    engine's ``idle_serve`` reads as on the block's ranks, and
    ``harvest`` returns the block's emissions (its first rank's,
    broadcast each round), which every rank's bus publishes.  A dense
    serve block's prefill, and a client-driven ``feed``, run on the
    block's own ranks only: here they raise."""

    device = None
    state = None

    def __init__(self, grant: BlockGrant, job: JobSpec,
                 devices: Optional[Sequence] = None,
                 ckpt_root: Optional[str] = None):
        from repro_torch.launch.mesh import make_block_mesh
        self.job = job
        self.ranks = check_block(grant, devices)
        if self.ranks is None or rank() in self.ranks:
            raise RuntimeError(
                f"an OffRankRuntime follows a block from a rank outside "
                f"it, under a process group (rank {rank()}, block ranks "
                f"{self.ranks})")
        self.mesh = make_block_mesh(self.ranks, grant.mesh_shape)
        self.groups_released = False
        self.grant = grant
        self.ckpt = (_SavedSteps(ckpt_root, job.ckpt_namespace
                                 or grant.block_id)
                     if ckpt_root is not None else None)
        self.step_count = 0
        self.last_saved_step = 0
        self.suspended = False
        self.table = (SessionTable(_max_seq_len(job))
                      if job.kind == "serve" and job.paged else None)
        self._init_window()

    # the in-flight window: a step "finishes" as it is dispatched
    def _launch(self):
        self.step_count += 1

    def _token_ready(self, token) -> bool:
        return True

    def _token_wait(self, token) -> None:
        pass

    def _completion_record(self, dispatch_t: float, token) -> Dict[str, float]:
        return first_ranks_record(
            self, super()._completion_record(dispatch_t, token))

    def init_state(self, *args, **kwargs) -> None:
        pass

    def _manager(self) -> "_SavedSteps":
        if self.ckpt is None:
            raise ValueError("this block has no checkpoint root: build it "
                             "with BlockRuntime(..., ckpt_root=...)")
        return self.ckpt

    def save(self, async_: bool = True) -> None:
        self._manager().saved(self.step_count)
        self.last_saved_step = self.step_count

    @property
    def progress_lost(self) -> int:
        return max(0, self.step_count - self.last_saved_step)

    def suspend(self) -> Dict[str, float]:
        drained = self.drain()
        self.save(async_=False)
        self.release()
        return {"step": self.step_count, "drained_steps": len(drained)}

    def release(self) -> None:
        self.drain()
        self.release_groups()
        self.suspended = True

    def release_groups(self) -> None:
        release_groups(self)

    def restore(self, step: Optional[int] = None) -> int:
        at = self._manager().latest_step() if step is None else step
        if at is None:
            raise FileNotFoundError(f"no checkpoints under "
                                    f"{self._manager().dir}")
        self.adopt(at)
        return at

    def adopt(self, step: Optional[int]) -> None:
        if step is not None:
            self._manager().saved(step)
        self.step_count = self.last_saved_step = step or 0
        if self.table is not None:
            # the sessions the block's ranks restored (``restore``), or
            # none for a fresh block
            self.table = (from_rank(self.ranks[0], None)
                          if step is not None
                          else SessionTable(_max_seq_len(self.job)))

    rebuild = classmethod(BlockRuntime.rebuild.__func__)

    # ------------------------------------------------ generate sessions
    @property
    def sessions(self):
        """A paged serve block's session table (what the daemon's
        generate command and ``has_work`` read), else None as on the
        block's ranks."""
        return self.table

    @property
    def idle_serve(self) -> bool:
        """As on the block's ranks: a paged block with no queued or
        running session (so the engine dispatches no round there)."""
        return self.table is not None and not self.table.has_work

    def start_session(self, prompt: Sequence[int], max_new_tokens: int = 16,
                      eos_id: Optional[int] = None) -> str:
        if self.table is None:
            raise ValueError("block has no generate surface "
                             "(needs a paged serve job)")
        return self.table.submit(prompt, max_new_tokens=max_new_tokens,
                                 eos_id=eos_id)

    def harvest(self) -> list:
        """The block's emissions since the last harvest, its first rank's
        (the broadcast its ranks enter in ``BlockRuntime.harvest``)."""
        if self.table is None:
            return []
        from repro_torch.serve.decode_scheduler import emissions_from
        out = emissions_from(self.ranks[0], None)
        self.table.follow(out)
        return out

    def _elsewhere(self, what: str):
        return NotImplementedError(
            f"{what}: a serve block runs it on its own ranks "
            f"{self.ranks}, and this rank ({rank()}) is outside them; "
            f"only a paged block's sessions are followed on every rank")

    def feed(self, *args, **kwargs):
        raise self._elsewhere("feed")

    def prefill(self, *args, **kwargs):
        raise self._elsewhere("prefill")


def _max_seq_len(job: JobSpec) -> int:
    """A paged job's per-session context cap."""
    return job.max_seq_len or job.shape.seq_len


class SessionTable:
    """A paged serve block's sessions as a rank outside the block follows
    them: the next session id, and which sessions are queued and running,
    kept from the submissions (``submit``, the ``DecodeScheduler``'s
    checks and ids) and the block's emissions (``follow``: admitted,
    evicted, finished).  After each harvest ``has_work`` is the
    scheduler's."""

    def __init__(self, max_seq_len: int, next_id: int = 0,
                 queued: Sequence[str] = (), running: Sequence[str] = ()):
        self.max_seq_len = max_seq_len
        self.next_id = next_id
        self.queued = list(queued)
        self.running = set(running)

    @classmethod
    def of(cls, sched) -> "SessionTable":
        """A ``DecodeScheduler``'s sessions as a table."""
        return cls(sched.max_seq_len, sched._next_id,
                   [s.sid for s in sched.queued],
                   [s.sid for s in sched.slots if s is not None])

    @property
    def has_work(self) -> bool:
        return bool(self.queued or self.running)

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> str:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if len(prompt) >= self.max_seq_len:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_seq_len "
                f"{self.max_seq_len}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        sid = f"g{self.next_id:06d}"
        self.next_id += 1
        self.queued.append(sid)
        return sid

    def follow(self, emissions: Sequence[Dict[str, Any]]) -> None:
        for em in emissions:
            event, sid = em["event"], em["session"]
            if event == "admitted":
                self.queued.remove(sid)
                self.running.add(sid)
            elif event == "evicted":
                self.running.discard(sid)
                self.queued.insert(0, sid)
            elif event == "finished":
                self.running.discard(sid)


class _SavedSteps:
    """An ``OffRankRuntime``'s view of its block's checkpoints: the steps
    saved through the control plane, which every rank sees in the same
    order (the files are the block's first rank's, and a rank outside
    the block does not wait for them)."""

    def __init__(self, root: str, namespace: str):
        self.dir = os.path.join(root, namespace)
        self._steps: list = []

    def saved(self, step: int) -> None:
        if step not in self._steps:
            self._steps = sorted(self._steps + [step])

    def steps(self) -> list:
        return list(self._steps)

    def latest_step(self) -> Optional[int]:
        return self._steps[-1] if self._steps else None

    def wait(self) -> None:
        pass
