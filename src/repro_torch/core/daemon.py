"""ClusterDaemon — the event-driven service layer over the controller.

The paper runs per-user engine daemons under one always-on control plane;
its companion papers (*Web-based Interface in Public Cluster*,
arXiv:0711.0528; *openPC*, arXiv:1012.2499) put a web front-end on top.
This module is that split's server half: a ``ClusterDaemon`` owns the
``ClusterController`` (and through it the partitioner, registry, monitor,
scheduler and event bus) and is the only thing callers talk to — the web
gateway, the launch drivers and the examples all go through it; nothing
outside ``repro_torch.core`` constructs a controller directly.

Two execution modes, one API:

* **Background (service) mode** — ``background=True`` starts a pump
  thread.  Every mutating call from any thread is wrapped in a typed
  ``Command`` and enqueued; the pump executes commands strictly one at a
  time and, between commands, drives the periodic ``tick()`` (auto-expiry,
  waitlist admission, auto-resume, heartbeat health decay, utilization
  sampling) that callers had to drive by hand before.  Engine rounds run
  on one worker thread per live federation pod (``run_round(pod=...)``),
  so a slow pod's harvest never stalls another pod's pump — but every
  round still takes the same daemon lock, so federation adds threads
  without adding interleavings.  Serializing all mutations through one
  lock is what makes a multi-user HTTP gateway safe to point at the
  controller without sprinkling locks through the scheduler.

* **Deterministic single-thread mode** — the default.  Calls execute
  inline on the caller's thread (still serialized by a reentrant lock) and
  ``tick()`` only runs when invoked, so tests and benchmarks see the exact
  pre-daemon semantics, model-time ``now=`` plumbing included.

Reads (status, reports, event history) bypass the command queue — they
touch thread-safe structures (registry lock, monitor lock, event bus) and
must not queue behind a long-running step command.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import runtime_check
from repro_torch.core.controller import ClusterController
from repro_torch.core.events import BlockEvent, EventBus
from repro_torch.core.topology import Topology
from repro_torch.engine import AutostepEngine, PacingPolicy
from repro_torch.federation.pods import POD_DEAD
from repro_torch.obs.bridge import wire_bus
from repro_torch.obs.flight import RECORDER
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import TRACER


@dataclasses.dataclass
class Command:
    """One serialized mutation: a named controller operation plus its
    arguments, with a completion event the submitting thread waits on."""
    name: str
    args: Tuple = ()
    kwargs: Dict = dataclasses.field(default_factory=dict)
    result: Any = None
    error: Optional[BaseException] = None
    claimed: bool = False     # pump took it (or the submitter gave up)
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    # trace context captured at enqueue: the pump parents the queue-wait
    # and exec spans back to the submitting request (None = tracing off)
    ctx: Optional[Tuple[str, str]] = None
    t_enq: float = 0.0        # perf_counter at enqueue (tracing on only)
    # request correlation id captured at enqueue: the pump stamps it on
    # the exec span so events published there carry it too (the id would
    # otherwise be stranded on the submitting thread's span stack)
    rid: Optional[str] = None


class ClusterDaemon:
    #: names accepted by ``call`` — the typed command surface.  Everything
    #: the gateway or a driver may mutate goes through exactly these.
    COMMANDS = (
        "register", "submit", "submit_gang", "review", "confirm",
        "activate", "run", "run_steps", "step_all", "download", "expire",
        "preempt", "resume", "resize", "tick", "inject_chip_failure",
        "save", "restore", "set_quota",
        "autostep_enable", "autostep_disable", "autostep_pace",
        "autostep_round", "generate",
        "attach_pod", "drain_pod", "detach_pod", "fail_pod",
        "pod_heartbeat",
    )

    def __init__(self, topo: Topology, devices: Optional[Sequence] = None,
                 ckpt_root: str = "artifacts/ckpt",
                 state_path: Optional[str] = None,
                 background: bool = False,
                 tick_interval_s: float = 0.05,
                 autostep_interval_s: float = 0.001,
                 pacing: Optional[PacingPolicy] = None,
                 placer=None, trace: bool = False):
        self.ctl = ClusterController(topo, devices=devices,
                                     ckpt_root=ckpt_root,
                                     state_path=state_path,
                                     placer=placer)
        # observability: the metrics bridge and flight recorder are
        # passive bus subscribers (always on — they mutate nothing in the
        # control plane); tracing stays opt-in so deterministic inline
        # mode is bit-identical by default
        if trace:
            TRACER.enable()
        wire_bus(self.ctl.bus)
        RECORDER.configure(
            dir=os.path.join(ckpt_root, "postmortems")).install(self.ctl.bus)
        # the autostep engine drives RUNNING blocks from the pump thread
        # (or inline via autostep_round); the controller drains a victim's
        # in-flight window through it before a preemption suspend
        self.engine = AutostepEngine(self.ctl, policy=pacing)
        self.ctl.engine = self.engine
        self.autostep_interval_s = autostep_interval_s
        self._engine_error_logged = False   # first engine error traceback
        self._serial = threading.RLock()      # inline-mode serialization
        self._cmds: "queue.Queue[Command]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.tick_interval_s = tick_interval_s
        ctl = self.ctl
        self._table: Dict[str, Callable] = {
            "register": ctl.register,
            "submit": ctl.submit,
            "submit_gang": ctl.submit_gang,
            "review": ctl.review,
            "confirm": ctl.confirm,
            "activate": ctl.activate,
            "run": ctl.run,
            "run_steps": self._run_steps,
            "step_all": ctl.step_all,
            "download": ctl.download,
            "expire": ctl.expire,
            "preempt": ctl.preempt,
            "resume": ctl.resume,
            "resize": ctl.resize_block,
            "tick": ctl.tick,
            "inject_chip_failure": ctl.inject_chip_failure,
            "save": self._save,
            "restore": self._restore,
            "set_quota": ctl.scheduler.policy.set_quota,
            "autostep_enable": self.engine.enable,
            "autostep_disable": self.engine.disable,
            "autostep_pace": self.engine.set_pace,
            "autostep_round": self.engine.run_round,
            "generate": self._generate,
            "attach_pod": ctl.attach_pod,
            "drain_pod": ctl.drain_pod,
            "detach_pod": ctl.detach_pod,
            "fail_pod": ctl.fail_pod,
            "pod_heartbeat": ctl.pod_heartbeat,
        }
        #: per-pod engine worker threads (background mode): pod_id ->
        #: thread.  Only the pump thread mutates this dict.
        self._pod_workers: Dict[int, threading.Thread] = {}
        if background:
            self.start()

    # ------------------------------------------------------------ lifecycle
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "ClusterDaemon":
        """Enter background (service) mode: start the pump thread."""
        if self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._pump_loop,
                                        name="cluster-daemon", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout)
        self._thread = None
        for th in list(self._pod_workers.values()):
            th.join(timeout)
        self._pod_workers.clear()
        # fail queued commands instead of leaving their submitters hanging
        while True:
            try:
                cmd = self._cmds.get_nowait()
            except queue.Empty:
                break
            cmd.error = RuntimeError("daemon stopped")
            cmd.done.set()

    def __enter__(self) -> "ClusterDaemon":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _pump_loop(self) -> None:
        last_tick = time.monotonic()
        while not self._stop.is_set():
            # federation: one engine worker per live pod drives that pod's
            # residents at the autostep cadence; the pump itself only
            # serves commands and the periodic tick, so a slow pod's
            # rounds never stall another pod (or command latency)
            self._sync_pod_workers()
            try:
                cmd = self._cmds.get(timeout=self.tick_interval_s)
            except queue.Empty:
                cmd = None
            if cmd is not None:
                with self._serial:
                    if cmd.claimed or cmd.done.is_set():
                        continue     # submitter already gave up on it
                    cmd.claimed = True
                    t_claim = time.perf_counter()
                    if TRACER.enabled and cmd.t_enq:
                        # queue-wait and exec tile the caller's call span:
                        # the exec span starts at the exact instant the
                        # queue span ends
                        TRACER.record(f"daemon.queue:{cmd.name}",
                                      cmd.t_enq, t_claim, cat="daemon",
                                      ctx=cmd.ctx)
                    rid_arg = ({"request_id": cmd.rid} if cmd.rid else {})
                    try:
                        with TRACER.span(f"daemon.exec:{cmd.name}",
                                         cat="daemon", ctx=cmd.ctx,
                                         t0=t_claim, **rid_arg):
                            with runtime_check.serialized("control-plane"):
                                cmd.result = self._table[cmd.name](
                                    *cmd.args, **cmd.kwargs)
                    except BaseException as e:   # delivered to the caller
                        cmd.error = e
                    dt = time.perf_counter() - t_claim
                    REGISTRY.observe("repro_daemon_command_seconds", dt,
                                     labels={"name": cmd.name})
                cmd.done.set()
            if time.monotonic() - last_tick >= self.tick_interval_s:
                with self._serial:
                    t0 = time.perf_counter()
                    try:
                        self.ctl.tick()
                    except Exception:
                        # a tick must never kill the service loop — but a
                        # crashing control plane is exactly what the
                        # flight recorder exists to explain
                        RECORDER.dump("daemon_crash",
                                      detail={"where": "tick",
                                              "error":
                                              traceback.format_exc()})
                    dt = time.perf_counter() - t0
                    REGISTRY.observe("repro_pump_tick_seconds", dt)
                    REGISTRY.sample("pump_tick_ms", dt * 1e3)
                last_tick = time.monotonic()

    def _sync_pod_workers(self) -> None:
        """Keep one engine worker thread alive per live pod (pump thread
        only — the dict has a single writer by construction).  Workers
        exit on their own when their pod dies or detaches; dead threads
        are reaped here so a re-attached pod id gets a fresh worker."""
        for pid in list(self._pod_workers):
            if not self._pod_workers[pid].is_alive():
                del self._pod_workers[pid]
        for p in self.ctl.pods.live():
            if p.pod_id not in self._pod_workers:
                th = threading.Thread(target=self._pod_worker,
                                      args=(p.pod_id,),
                                      name=f"pod-worker-{p.pod_id}",
                                      daemon=True)
                self._pod_workers[p.pod_id] = th
                th.start()

    def _pod_worker(self, pod_id: int) -> None:
        """Per-pod engine pump: drives ``run_round(pod=pod_id)`` for this
        pod's residents while the pod is alive.  Rounds are serialized
        with every other mutation via the daemon lock, so federation adds
        threads without adding interleavings — it changes *who* pumps,
        not what can overlap."""
        while not self._stop.is_set():
            pod = self.ctl.pods.get(pod_id)
            if pod is None or pod.phase == POD_DEAD:
                return               # detached/dead: the worker retires
            busy = False
            if self.engine.armed:
                with self._serial:
                    try:
                        self.engine.run_round(pod=pod_id)
                        busy = self.engine.last_round_busy
                    except Exception:
                        # an engine bug must not kill the worker — but it
                        # must not busy-spin or fail silently either
                        self.engine.last_round_busy = False
                        if not self._engine_error_logged:
                            self._engine_error_logged = True
                            traceback.print_exc()
            self._stop.wait(self.autostep_interval_s if busy
                            else self.tick_interval_s)

    # -------------------------------------------------------------- command
    def call(self, name: str, *args, **kwargs):
        """Execute one typed command.  Background mode enqueues and waits
        (mutations run strictly serialized on the pump thread);
        deterministic mode runs inline on the caller's thread.  Calls
        *from* the pump thread itself (an event subscriber reacting to a
        command) run inline too — enqueueing would deadlock."""
        if name not in self._table:
            raise ValueError(f"unknown daemon command {name!r}")
        if not self.running or threading.current_thread() is self._thread:
            with TRACER.span(f"daemon.call:{name}", cat="daemon"):
                with self._serial:
                    with runtime_check.serialized("control-plane"):
                        return self._table[name](*args, **kwargs)
        with TRACER.span(f"daemon.call:{name}", cat="daemon"):
            cmd = Command(name=name, args=args, kwargs=kwargs)
            if TRACER.enabled:
                cmd.ctx = TRACER.context()
                cmd.rid = TRACER.current_request_id()
                cmd.t_enq = time.perf_counter()
            self._cmds.put(cmd)
            # bounded waits: a stop() racing this enqueue (queue drained
            # just before our put) would otherwise leave the caller parked
            # forever on a command no thread will ever serve
            while not cmd.done.wait(0.2):
                if not self.running:
                    with self._serial:
                        if not cmd.claimed and not cmd.done.is_set():
                            # orphaned by the race: run it inline (a later
                            # start() skips claimed commands)
                            cmd.claimed = True
                            return self._table[name](*args, **kwargs)
            if cmd.error is not None:
                raise cmd.error
            return cmd.result

    # ----------------------------------------------------- command bodies
    def _run_steps(self, targets, max_inflight: Optional[int] = None):
        return self.ctl.scheduler.run_dispatch(
            targets, max_inflight=max_inflight)

    def _save(self, app_id: str, async_: bool = False) -> None:
        self.ctl.runtimes[app_id].save(async_=async_)

    def _restore(self, app_id: str,
                 step: Optional[int] = None) -> Optional[int]:
        rt = self.ctl.runtimes[app_id]
        if rt.ckpt.latest_step() is None:
            return None
        return rt.restore(step=step)

    def _generate(self, app_id: str, prompt: Sequence[int],
                  max_new_tokens: int = 16,
                  eos_id: Optional[int] = None,
                  now: Optional[float] = None) -> str:
        """Queue a generate session on a paged serve block.  Tokens flow
        back as ``generate``/``session`` events published by the autostep
        engine's decode rounds (the gateway's generate endpoint streams
        them; deterministic-mode callers drive ``autostep_round``)."""
        blk = self.ctl.registry.get(app_id)       # KeyError -> caller 404
        rt = self.ctl.runtimes.get(app_id)
        start = getattr(rt, "start_session", None)
        if rt is None or start is None or getattr(rt, "sessions", None) is None:
            raise ValueError(
                f"{app_id} has no generate surface: needs an active paged "
                f"serve job (activate with kind=serve, paged=true)")
        # bind the block to the submitting request's trace (if any): the
        # engine's later decode rounds for this block join it, giving one
        # connected gateway -> queue -> admit -> decode trace per request
        TRACER.bind(app_id)
        with TRACER.span("serve.submit", cat="serve", app_id=app_id,
                         user=blk.request.user):
            sid = start(list(prompt), max_new_tokens=max_new_tokens,
                        eos_id=eos_id)
        self.ctl.bus.publish("session", app_id=app_id,
                             block_id=blk.block_id, user=blk.request.user,
                             now=now, action="submitted", session=sid,
                             prompt_tokens=len(prompt),
                             max_new_tokens=int(max_new_tokens))
        return sid

    # ------------------------------------------------------ typed wrappers
    def register(self, *a, **kw) -> str:
        return self.call("register", *a, **kw)

    def submit(self, *a, **kw):
        return self.call("submit", *a, **kw)

    def submit_gang(self, *a, **kw):
        return self.call("submit_gang", *a, **kw)

    def review(self, *a, **kw):
        return self.call("review", *a, **kw)

    def confirm(self, app_id: str, token: str) -> None:
        return self.call("confirm", app_id, token)

    def activate(self, app_id: str, job):
        return self.call("activate", app_id, job)

    def run(self, app_id: str) -> None:
        return self.call("run", app_id)

    def run_steps(self, targets, max_inflight: Optional[int] = None):
        """Step RUNNING blocks (``targets``: rounds-per-app mapping or a
        single int for every running block), event-driven."""
        return self.call("run_steps", targets, max_inflight=max_inflight)

    def step_all(self, rounds: int = 1, sync_every: int = 1):
        return self.call("step_all", rounds, sync_every)

    def download(self, app_id: str) -> Dict:
        return self.call("download", app_id)

    def expire(self, app_id: str, now: Optional[float] = None) -> None:
        return self.call("expire", app_id, now=now)

    def preempt(self, app_id: str, reason: str = "admin preempt",
                now: Optional[float] = None) -> None:
        return self.call("preempt", app_id, reason=reason, now=now)

    def resume(self, app_id: str, n_chips: Optional[int] = None):
        return self.call("resume", app_id, n_chips=n_chips)

    def resize(self, app_id: str, new_n_chips: int):
        return self.call("resize", app_id, new_n_chips)

    def tick(self, now: Optional[float] = None) -> List[str]:
        return self.call("tick", now=now)

    def inject_chip_failure(self, coord, now: Optional[float] = None):
        return self.call("inject_chip_failure", coord, now=now)

    def save(self, app_id: str, async_: bool = False) -> None:
        return self.call("save", app_id, async_=async_)

    def restore(self, app_id: str,
                step: Optional[int] = None) -> Optional[int]:
        return self.call("restore", app_id, step=step)

    def set_quota(self, user: str, max_chips: Optional[int] = None,
                  max_chip_seconds: Optional[float] = None):
        return self.call("set_quota", user, max_chips=max_chips,
                         max_chip_seconds=max_chip_seconds)

    def autostep_enable(self, app_id: str, **cfg) -> Dict:
        """Arm the autostep engine for one block (daemon-side stepping:
        the pump drives the block's dispatch window; no client ``steps``
        traffic needed).  ``cfg``: max_rate_hz, until_steps, until_t,
        stop_at_deadline, ckpt_every."""
        return self.call("autostep_enable", app_id, **cfg)

    def autostep_disable(self, app_id: str, reason: str = "disabled"):
        return self.call("autostep_disable", app_id, reason=reason)

    def autostep_pace(self, app_id: str, max_rate_hz: Optional[float]):
        return self.call("autostep_pace", app_id, max_rate_hz)

    def generate(self, app_id: str, prompt: Sequence[int],
                 max_new_tokens: int = 16, eos_id: Optional[int] = None,
                 now: Optional[float] = None) -> str:
        """Submit a generate session to a paged serve block; returns the
        session id whose tokens stream back as ``generate`` events."""
        return self.call("generate", app_id, prompt,
                         max_new_tokens=max_new_tokens, eos_id=eos_id,
                         now=now)

    def autostep_round(self, now: Optional[float] = None,
                       budget: Optional[int] = None,
                       pod: Optional[int] = None) -> int:
        """Drive one engine round inline (deterministic mode / tests;
        background mode runs rounds from the per-pod workers
        automatically).  ``pod`` restricts the round to that pod's
        residents."""
        return self.call("autostep_round", now=now, budget=budget, pod=pod)

    # ------------------------------------------------------- federation
    def attach_pod(self, pod_x: int, pod_y: int, name: Optional[str] = None,
                   devices: Optional[Sequence] = None,
                   power_budget_chips: Optional[float] = None,
                   now: Optional[float] = None) -> Dict:
        """Attach a new pod at runtime: its chips join the federated free
        pool immediately and the next pump admits queued/preempted blocks
        onto it (no daemon restart)."""
        # the pod name rides positionally: call()'s own first parameter
        # is also ``name`` (the command), so the kwarg would collide
        return self.call("attach_pod", pod_x, pod_y, name, devices,
                         power_budget_chips=power_budget_chips, now=now)

    def drain_pod(self, pod_id: int, now: Optional[float] = None) -> Dict:
        """Stop placing new blocks on a pod (residents keep running)."""
        return self.call("drain_pod", pod_id, now=now)

    def detach_pod(self, pod_id: int, force: bool = False,
                   now: Optional[float] = None) -> Dict:
        """Remove a pod.  Refuses while residents hold chips unless
        ``force`` (which evicts/migrates them first)."""
        return self.call("detach_pod", pod_id, force=force, now=now)

    def fail_pod(self, pod_id: int, reason: str = "pod died",
                 now: Optional[float] = None) -> List[str]:
        """Declare a pod dead (fault injection / admin): every resident
        is preempted or migrated; returns the victim app ids."""
        return self.call("fail_pod", pod_id, reason=reason, now=now)

    def pod_heartbeat(self, pod_id: int,
                      now: Optional[float] = None) -> Dict:
        return self.call("pod_heartbeat", pod_id, now=now)

    # ------------------------------------------------------------ reads
    # (thread-safe structures; never queued behind commands)
    @property
    def bus(self) -> EventBus:
        return self.ctl.bus

    @property
    def registry(self):
        return self.ctl.registry

    @property
    def partitioner(self):
        return self.ctl.partitioner

    @property
    def monitor(self):
        return self.ctl.monitor

    @property
    def scheduler(self):
        return self.ctl.scheduler

    @property
    def runtimes(self):
        return self.ctl.runtimes

    @property
    def topo(self) -> Topology:
        return self.ctl.topo

    @property
    def pods(self):
        return self.ctl.pods

    def list_pods(self) -> List[Dict]:
        """Public federation view: every pod's directory entry."""
        return self.ctl.pods.describe_all()

    def runtime(self, app_id: str):
        return self.ctl.runtimes.get(app_id)

    def interference_report(self):
        return self.ctl.interference_report()

    def status(self, app_id: str,
               _stragglers: Optional[List[str]] = None) -> Dict:
        """One block's public lifecycle view (what the gateway serves).
        ``_stragglers`` lets ``list_apps`` compute the straggler set once
        for the whole table instead of once per row."""
        blk = self.ctl.registry.get(app_id)
        rt = self.ctl.runtimes.get(app_id)
        stragglers = (_stragglers if _stragglers is not None
                      else self.ctl.monitor.stragglers())
        return {
            "app_id": app_id,
            "user": blk.request.user,
            "job": blk.request.job_description,
            "state": blk.state.value,
            "n_chips": blk.request.n_chips,
            "priority": blk.request.priority,
            "deadline_at": blk.deadline_at,
            "est_steps": blk.request.est_steps,
            "gang_id": blk.request.gang_id,
            "block_id": blk.block_id,
            "pod": (blk.grant.coords[0][0]
                    if blk.grant and blk.grant.coords
                    else blk.request.pod),
            "coords": list(blk.grant.coords) if blk.grant else None,
            "mesh_shape": list(blk.grant.mesh_shape) if blk.grant else None,
            "expires_at": blk.grant.expires_at if blk.grant else None,
            "queued_at": blk.queued_at,
            "preempt_count": blk.preempt_count,
            "failure": blk.failure_reason,
            "steps": getattr(rt, "step_count", 0) if rt else 0,
            "mfu": self.ctl.monitor.mfu(blk.block_id),
            "straggler": blk.block_id in stragglers,
            "autostep": self.engine.describe(app_id),
        }

    def list_apps(self, user: Optional[str] = None) -> List[Dict]:
        reg = self.ctl.registry
        with reg._lock:
            ids = [a for a, b in reg.apps.items()
                   if user is None or b.request.user == user]
        stragglers = self.ctl.monitor.stragglers()
        return [self.status(a, _stragglers=stragglers) for a in ids]

    def cluster_report(self) -> Dict:
        topo = self.ctl.topo
        return {
            "n_pods": topo.n_pods, "pod_x": topo.pod_x, "pod_y": topo.pod_y,
            # federation totals: chips across every *live* pod (boot +
            # runtime-attached), not just the boot topology
            "n_chips": self.ctl.total_chips(),
            "free_chips": self.ctl.partitioner.free_capacity(),
            "pods": self.ctl.pods.describe_all(),
            "federation": self.ctl.monitor.federation_report(),
            # raw waitlist length, not queue_depth(): that would prune —
            # a mutation — outside the command serialization
            "queue_depth": len(self.ctl.scheduler.waitlist),
            "queue": self.ctl.monitor.queue_report(),
            "deadlines": self.ctl.monitor.deadline_report(),
            "preemption": self.ctl.monitor.preemption_report(),
            "compile": self.ctl.monitor.compile_report(),
            "roofline": self.ctl.monitor.roofline_report(),
            "obs": self.obs_report(),
        }

    def obs_report(self) -> Dict:
        """Observability summary for the dashboard tiles: key latency
        histograms, abuse counters, straggler set, recent postmortems and
        the sparkline series rings."""
        stragglers = self.ctl.monitor.stragglers()
        REGISTRY.set_gauge("repro_stragglers", len(stragglers))
        return {
            "trace_enabled": TRACER.enabled,
            "pump_tick": REGISTRY.hist_summary("repro_pump_tick_seconds"),
            "admission_wait": REGISTRY.hist_summary(
                "repro_admission_wait_seconds"),
            "http_429": REGISTRY.counter_total("repro_http_429_total"),
            "http_413": REGISTRY.counter_total("repro_http_413_total"),
            "sse_streams": REGISTRY.gauge_value("repro_sse_streams"),
            "stragglers": sorted(stragglers),
            "postmortems": RECORDER.dumps(),
            "series": REGISTRY.series(),
        }

    def events_since(self, after_seq: int = 0,
                     app_id: Optional[str] = None,
                     kinds=None, limit: int = 1000) -> List[BlockEvent]:
        return self.ctl.bus.events_since(after_seq, app_id=app_id,
                                         kinds=kinds, limit=limit)

    def wait_events(self, after_seq: int = 0,
                    app_id: Optional[str] = None, kinds=None,
                    timeout: float = 10.0,
                    limit: int = 1000) -> List[BlockEvent]:
        return self.ctl.bus.wait(after_seq, app_id=app_id, kinds=kinds,
                                 timeout=timeout, limit=limit)
