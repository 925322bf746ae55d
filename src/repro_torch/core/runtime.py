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
page, so a paged job raises the reference's ``ValueError``.

One device per block: the sharding plans of the reference have no
counterpart until the multi-GPU slice.

Steps are built through ``compile_cache.GLOBAL`` under the reference's
keys (``_cache_key``), the mesh's fingerprint replaced by the device's.
A dense serve block's decode step runs as a ``CapturedStep``: the first
step on the card captures it as a CUDA graph with the block's params,
cache and a device ``cache_len`` scalar bound (and a sampling job's
generator registered), and every later step refills the scalar and
replays the graph (on the CPU the step runs eagerly).  The train step
and prefill run eagerly.

Preemption: ``suspend()`` drains the in-flight window, writes a
synchronous checkpoint (``repro_torch.checkpoint.manager``, the
reference's format) and drops every device reference, then hands the
freed memory back to the card, so another block can have it;
``resume(grant, devices)`` rebuilds the runtime on the given device and
restores the suspended state into restore targets on the ``meta`` device
(no random init).  ``rebuild`` starts a new runtime from an old block's
checkpoints.  ``suspend()`` also releases the block's captured graphs and
their memory pools; a resumed block gets its steps from the compile cache
(a hit) and captures again at its first step.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.block import BlockGrant
from repro_torch.core.inflight import InflightWindow
from repro_torch.data import pipeline
from repro_torch.device import resolve
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.serve import serve_step as serve_lib
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
        self.last_saved_step = 0     # step_count at the last checkpoint
        self.suspended = False
        self._init_window()
        self._attach(grant, devices)

    def _attach(self, grant: BlockGrant,
                devices: Optional[Sequence]) -> None:
        """Bind to the block's device (``cuda`` per chip by default)."""
        if devices is None:
            devices = ["cuda"] * grant.n_chips
        assert len(devices) == math.prod(grant.mesh_shape), (
            len(devices), grant.mesh_shape)
        devs = [resolve(d) for d in devices]
        if len(set(devs)) != 1:
            raise NotImplementedError(
                "a block spans one device until the multi-GPU slice ports "
                "the sharding plans")
        self.grant = grant
        self.devices = devs
        self.device = devs[0]
        job = self.job
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(job.seed + 1)
        self._prefill_fn = None      # built at the first prefill()
        if job.kind == "train":
            self._step = self._cached(
                self._cache_key("train_step", compile_cache.freeze(job.opt),
                                ("donate", 0)),
                lambda: train_lib.make_train_step(job.cfg, job.shape,
                                                  job.opt), "train_step")
            self.data = pipeline.DataIterator(job.cfg, job.shape,
                                              seed=job.seed,
                                              device=self.device)
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
            # the graph binds this block's params (0), cache (2) and
            # position scalar (3) (and a sampling job's generator), so it
            # is the block's own
            self._step = compile_cache.CapturedStep(
                decode, static=(0, 2, 3), donate=(2,))
            self._cache_len_dev = torch.zeros((), dtype=torch.int32,
                                              device=self.device)

    # ------------------------------------------------------------ compile
    def _cache_key(self, family: str, *extra) -> tuple:
        """Logical build signature: everything the built step can depend
        on.  ``seed``/checkpoint fields deliberately excluded."""
        job = self.job
        return (family, compile_cache.freeze(job.cfg),
                compile_cache.freeze(job.shape),
                compile_cache.device_fingerprint(self.device)) + extra

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
            self.state = train_lib.make_train_state(
                job.cfg, job.seed, job.opt, params=params,
                opt_state=opt_state, device=self.device)
            return
        self._install_params(params)
        if job.paged:
            self.sessions = self._make_scheduler(self.state["params"])
            self.token = self.sessions.last_tokens_dev
            return
        self.cache = model_lib.init_cache(job.cfg, job.shape.global_batch,
                                          job.shape.seq_len, self.device)
        self.cache_len = 0
        self.token = torch.zeros((job.shape.global_batch, 1),
                                 dtype=torch.int32, device=self.device)

    def _install_params(self, params: Optional[Dict[str, Any]]) -> None:
        """A serve block's model around ``params`` (random from
        ``job.seed`` when None)."""
        self.model = model_lib.Transformer(self.job.cfg, params,
                                           seed=self.job.seed,
                                           device=self.device)
        self.state = {"params": self.model.params}

    def _paged_geometry(self) -> Dict[str, int]:
        job = self.job
        return dict(page_size=job.page_size, n_pages=job.n_pages,
                    max_slots=job.max_slots,
                    max_seq_len=job.max_seq_len or job.shape.seq_len)

    def _make_scheduler(self, params, init_pool: bool = True):
        from repro_torch.serve.decode_scheduler import DecodeScheduler
        job = self.job
        return DecodeScheduler(job.cfg, params, sample=job.decode_sample,
                               seed=job.seed, init_pool=init_pool,
                               device=self.device, **self._paged_geometry())

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
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        logits, self.cache = self._prefill_fn(self.state["params"],
                                              {"tokens": tokens}, self.cache)
        self.token = torch.argmax(logits, -1)[:, None].to(torch.int32)
        self.cache_len = int(tokens.shape[1])

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
        out = self.harvest()
        for _ in range(rounds):
            out.extend(self.sessions.step())
            self.step_count += 1
        return out

    def harvest(self) -> list:
        """Drain emissions buffered by window-dispatched decode steps."""
        out, self._emissions = self._emissions, []
        return out

    @property
    def idle_serve(self) -> bool:
        """True when dispatched steps would be no-ops (paged serve with no
        active or queued session)."""
        return self.sessions is not None and not self.sessions.has_work

    # ---------------------------------------------------------------- step
    def _decode_once(self):
        if self.job.paged:
            self._emissions.extend(self.sessions.step())
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
        return ev is None or ev.query()

    def _token_wait(self, token) -> None:
        ev = self._event(token)
        if ev is not None:
            ev.synchronize()

    def _completion_record(self, dispatch_t: float, token) -> Dict[str, float]:
        rec = super()._completion_record(dispatch_t, token)
        if isinstance(token, tuple):
            rec.update({k: float(v) for k, v in token[1].items()})
        return rec

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
        return {"cache": self.cache, "token": self.token,
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
        self.suspended = True
        return {"step": self.step_count, "drained_steps": len(drained)}

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
        restored, at = ckpt.restore(like, step=step, device=self.device)
        self._release_graphs()       # they bind the tensors replaced here
        state = restored["state"]
        if job.kind == "train":
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
                self.cache = dec["cache"]
                self.token = dec["token"]
                self.cache_len = int(dec["cache_len"])
        self.step_count = int(restored["step_count"])
        self.last_saved_step = self.step_count   # state == checkpoint now
        return at

    @classmethod
    def rebuild(cls, old: "BlockRuntime", grant: BlockGrant,
                devices: Sequence, ckpt_root: str) -> "BlockRuntime":
        """Failure migration: a new runtime on ``devices`` with the old
        block's state restored from its checkpoints (adopting its
        namespace), or a fresh init when it has none."""
        rt = cls(grant, old.job, devices, ckpt_root)
        old_ckpt = old._manager()
        old_ckpt.wait()
        if old_ckpt.latest_step() is None:
            rt.init_state()
        else:
            rt.ckpt = old_ckpt      # same namespace: adopt checkpoint history
            rt.restore()
        return rt
