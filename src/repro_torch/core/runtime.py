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
counterpart until the multi-GPU slice.  Checkpointing (``save``/
``suspend``/``resume``/``restore``) raises ``NotImplementedError`` until
its slice lands.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.core.block import BlockGrant
from repro_torch.core.inflight import InflightWindow
from repro_torch.data import pipeline
from repro_torch.device import resolve
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.serve import serve_step as serve_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as train_lib

_CKPT_LATER = ("checkpointing and preempt/resume are not yet ported: they "
               "come with the checkpoint slice (checkpoint/manager.py)")


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
    # ---- serve: continuous batching over a paged KV cache ----
    paged: bool = False              # serve: slot-batched generate sessions
                                     # over a shared page pool instead of the
                                     # single dense prefill/decode context
    page_size: int = 16              # rows per KV page
    n_pages: int = 0                 # pool size; 0 derives full residency
                                     # (max_slots * pages_per_seq + trash)
    max_slots: int = 8               # concurrent decode batch width
    max_seq_len: int = 0             # per-session context cap; 0 -> shape.seq_len


class BlockRuntime(InflightWindow):
    def __init__(self, grant: BlockGrant, job: JobSpec,
                 devices: Optional[Sequence] = None):
        if job.kind not in ("train", "serve"):
            raise ValueError(f"kind must be 'train' or 'serve', got "
                             f"{job.kind!r}")
        if job.kind == "serve" and job.paged:
            model_lib.check_paged_support(job.cfg)
        self.job = job
        self.model: Optional[model_lib.Transformer] = None
        self.state: Any = None
        self.cache: Any = None
        self.sessions = None         # paged serve: the DecodeScheduler
        self._emissions: list = []   # paged serve: buffered generate events
        self.step_count = 0
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
        if job.kind == "train":
            self._step = train_lib.make_train_step(job.cfg, job.shape,
                                                   job.opt)
            self.data = pipeline.DataIterator(job.cfg, job.shape,
                                              seed=job.seed,
                                              device=self.device)
        elif job.paged:
            # the DecodeScheduler owns its prefill/decode; built in
            # init_state (it needs the params)
            self._step = self._prefill_fn = None
        else:
            self._step = serve_lib.make_decode_step(
                job.cfg, sample=job.decode_sample)
            self._prefill_fn = serve_lib.make_prefill_step(job.cfg)

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
                job.cfg, job.seed, job.opt, params=params, device=self.device)
            if opt_state is not None:
                self.state["opt"] = opt_state
            return
        self.model = model_lib.Transformer(job.cfg, params, seed=job.seed,
                                           device=self.device)
        params = self.model.params
        self.state = {"params": params}
        if job.paged:
            self.sessions = self._make_scheduler(params)
            self.token = self.sessions.last_tokens_dev
            return
        self.cache = model_lib.init_cache(job.cfg, job.shape.global_batch,
                                          job.shape.seq_len, self.device)
        self.cache_len = 0
        self.token = torch.zeros((job.shape.global_batch, 1),
                                 dtype=torch.int32, device=self.device)

    def _paged_geometry(self) -> Dict[str, int]:
        job = self.job
        return dict(page_size=job.page_size, n_pages=job.n_pages,
                    max_slots=job.max_slots,
                    max_seq_len=job.max_seq_len or job.shape.seq_len)

    def _make_scheduler(self, params):
        from repro_torch.serve.decode_scheduler import DecodeScheduler
        job = self.job
        return DecodeScheduler(job.cfg, params, sample=job.decode_sample,
                               seed=job.seed, device=self.device,
                               **self._paged_geometry())

    def prefill(self, batch: Dict[str, Any]) -> None:
        """Dense serve blocks: process a prompt batch into the KV cache and
        seed the decode loop with the first generated token."""
        if self.job.paged:
            raise ValueError("a paged serve block prefills each session at "
                             "admission: use start_session()")
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
        self.token, self.cache = self._step(
            self.state["params"], self.token, self.cache, self.cache_len,
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
    def save(self, async_: bool = True) -> None:
        raise NotImplementedError(_CKPT_LATER)

    def suspend(self) -> Dict[str, float]:
        raise NotImplementedError(_CKPT_LATER)

    def resume(self, grant: BlockGrant, devices: Sequence) -> int:
        raise NotImplementedError(_CKPT_LATER)

    def restore(self, step: Optional[int] = None) -> int:
        raise NotImplementedError(_CKPT_LATER)
