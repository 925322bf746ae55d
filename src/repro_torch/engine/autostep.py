"""AutostepEngine — the daemon-owned autostep loop.

One engine instance hangs off the ``ClusterDaemon``'s controller.  A block
opts in with ``enable()`` (directly, via the daemon's ``autostep_*``
commands, or over the gateway's ``POST /v1/blocks/<id>/autostep``); from
then on the engine keeps the block's in-flight dispatch window fed from
every ``run_round()`` — the daemon pump calls it between commands, so
RUNNING blocks make progress with **zero** client ``POST /steps`` traffic.

Each round:

1. harvest completed steps from every enabled RUNNING block (non-blocking
   ``poll``) and publish them as ``step`` events — identical payloads to
   client-driven dispatch, so the Monitor's accounting cannot tell the
   difference;
2. write periodic checkpoints (``ckpt_every``) and apply run-until
   termination: a block that reaches ``until_steps`` drains its window and
   transitions to DONE; one that reaches ``until_t`` (or its own SLO
   deadline with ``stop_at_deadline``) stops dispatching and disarms;
3. plan new dispatches with the ``PacingPolicy`` (weighted fair
   interleave + per-block token-bucket rate caps) under the existing
   in-flight-window backpressure (``scheduler.max_inflight``).

Preemption interplay: the controller calls ``drain_block()`` before
suspending an engine-driven victim, so in-flight completions are harvested
and *published* rather than silently discarded; the drive config survives
the eviction and the engine re-arms automatically when the block resumes
to RUNNING.

Determinism: the engine mutates nothing unless a block is enabled, and
``run_round(now=...)`` keeps every published event on the model clock —
the daemon's deterministic inline mode (tests, ``benchmarks/
policy_admission.py``) is bit-for-bit unchanged unless a test drives
rounds itself.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from repro_torch.analysis import runtime_check
from repro_torch.core.block import BlockState
from repro_torch.engine.pacing import BlockView, PacingPolicy
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import TRACER

#: lifecycle states from which a block can never run again — the engine
#: drops its drive (an EXPIRED/DONE block re-enabled later starts fresh)
_TERMINAL = (BlockState.DONE, BlockState.EXPIRED, BlockState.FAILED,
             BlockState.DENIED)


@dataclasses.dataclass
class AutostepConfig:
    max_rate_hz: Optional[float] = None   # per-block step-rate cap
    until_steps: Optional[int] = None     # stop + DONE at this step_count
    until_t: Optional[float] = None       # stop dispatching at this time
    stop_at_deadline: bool = False        # treat the block's SLO deadline
                                          # as an until_t
    ckpt_every: int = 0                   # periodic checkpoint interval
                                          # (0 = the job spec's, if any)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Drive:
    """Per-block engine state: the opt-in config plus pacing bookkeeping
    and a cached identity snapshot so publishing a step event costs no
    registry work."""
    config: AutostepConfig
    user: str = ""
    block_id: Optional[str] = None
    n_chips: int = 0
    priority: int = 0
    pod: Optional[int] = None             # grant's federation pod
    deficit: float = 0.0                  # PacingPolicy credit
    allowance: float = 1.0                # token bucket (rate cap)
    last_refill: Optional[float] = None
    steps_driven: int = 0
    derived_rate_hz: Optional[float] = None  # adaptive (budget-derived) cap


class AutostepEngine:
    def __init__(self, ctl, policy: Optional[PacingPolicy] = None):
        self.ctl = ctl
        self.policy = policy or PacingPolicy()
        self._drives: Dict[str, _Drive] = {}
        self.steps_driven = 0            # completions harvested, lifetime
        #: True when the last round dispatched/harvested or left work in
        #: flight — the pump uses it to pick its idle timeout
        self.last_round_busy = False

    # ------------------------------------------------------------- opt-in
    @property
    def armed(self) -> bool:
        return bool(self._drives)

    def enabled(self, app_id: str) -> bool:
        return app_id in self._drives

    def enable(self, app_id: str, max_rate_hz: Optional[float] = None,
               until_steps: Optional[int] = None,
               until_t: Optional[float] = None,
               stop_at_deadline: bool = False,
               ckpt_every: int = 0,
               now: Optional[float] = None) -> Dict:
        """Arm (or re-configure) autostep for one block.  Legal in any
        non-terminal state — a queued or preempted block starts stepping
        the moment it is RUNNING."""
        blk = self.ctl.registry.get(app_id)          # KeyError -> caller 404
        if blk.state in _TERMINAL:
            raise ValueError(
                f"cannot autostep {app_id}: block is {blk.state.value}")
        cfg = AutostepConfig(max_rate_hz=max_rate_hz,
                             until_steps=until_steps, until_t=until_t,
                             stop_at_deadline=stop_at_deadline,
                             ckpt_every=int(ckpt_every or 0))
        drive = self._drives.get(app_id)
        if drive is None:
            drive = self._drives[app_id] = _Drive(config=cfg)
        else:
            drive.config = cfg
        drive.user = blk.request.user
        drive.priority = blk.request.priority
        self._refresh_grant(drive, blk)
        self.ctl.bus.publish("autostep", app_id=app_id,
                             block_id=drive.block_id, user=drive.user,
                             now=now, action="enabled", **cfg.to_dict())
        return self.describe(app_id)

    def disable(self, app_id: str, reason: str = "disabled",
                now: Optional[float] = None) -> bool:
        drive = self._drives.pop(app_id, None)
        if drive is None:
            return False
        self.ctl.bus.publish("autostep", app_id=app_id,
                             block_id=drive.block_id, user=drive.user,
                             now=now, action="disabled", reason=reason,
                             steps_driven=drive.steps_driven)
        return True

    def set_pace(self, app_id: str, max_rate_hz: Optional[float],
                 now: Optional[float] = None) -> Dict:
        drive = self._drives.get(app_id)
        if drive is None:
            raise KeyError(app_id)
        drive.config.max_rate_hz = (None if max_rate_hz is None
                                    else float(max_rate_hz))
        drive.allowance = min(drive.allowance, 1.0)
        self.ctl.bus.publish("autostep", app_id=app_id,
                             block_id=drive.block_id, user=drive.user,
                             now=now, action="paced",
                             max_rate_hz=drive.config.max_rate_hz)
        return self.describe(app_id)

    def describe(self, app_id: str) -> Optional[Dict]:
        """Public autostep view for one block (``None`` = not enabled) —
        what the daemon's ``status()`` and the dashboard serve."""
        drive = self._drives.get(app_id)
        if drive is None:
            return None
        return {"enabled": True, "steps_driven": drive.steps_driven,
                "derived_rate_hz": drive.derived_rate_hz,
                **drive.config.to_dict()}

    # ------------------------------------------------------------- driving
    def _refresh_grant(self, drive: _Drive, blk) -> None:
        if blk.grant is not None:
            drive.block_id = blk.grant.block_id
            drive.n_chips = blk.grant.n_chips
            if blk.grant.coords:
                drive.pod = blk.grant.coords[0][0]
        drive.priority = blk.request.priority

    def _publish_step(self, app_id: str, drive: _Drive, rec: Dict,
                      now: Optional[float]) -> None:
        # identical payload to scheduler.run_dispatch's on_step: the
        # Monitor (and any feed consumer) sees the same stream whether the
        # client or the engine drove the step
        metrics = {k: v for k, v in rec.items() if k != "step_s"}
        self.ctl.bus.publish("step", app_id=app_id,
                             block_id=drive.block_id, user=drive.user,
                             now=now, step_s=rec["step_s"],
                             n_chips=drive.n_chips, metrics=metrics or None)
        drive.steps_driven += 1
        self.steps_driven += 1

    def _harvest_generate(self, app_id: str, drive: _Drive, rt,
                          now: Optional[float]) -> int:
        """Publish a paged serve block's buffered continuous-batching
        emissions: one ``generate`` event per token, one ``session`` event
        per lifecycle edge (admitted/evicted/finished).  The gateway's
        generate endpoint streams exactly these off the bus."""
        harvest = getattr(rt, "harvest", None)
        if harvest is None:
            return 0
        ems = harvest()
        for em in ems:
            detail = {k: v for k, v in em.items()
                      if k not in ("event", "session")}
            if em["event"] == "token":
                self.ctl.bus.publish("generate", app_id=app_id,
                                     block_id=drive.block_id,
                                     user=drive.user, now=now,
                                     session=em["session"], **detail)
            else:
                self.ctl.bus.publish("session", app_id=app_id,
                                     block_id=drive.block_id,
                                     user=drive.user, now=now,
                                     action=em["event"],
                                     session=em["session"], **detail)
        return len(ems)

    def _maybe_checkpoint(self, drive: _Drive, rt) -> None:
        """Periodic checkpoint under autostep (client-driven drivers used
        to call ``daemon.save`` themselves between step batches).  Only
        runtimes with a checkpoint surface participate — SimRuntime keeps
        its own ``ckpt_every`` accounting."""
        every = drive.config.ckpt_every or getattr(
            getattr(rt, "job", None), "ckpt_every", 0)
        if not every:
            return
        save = getattr(rt, "save", None)
        if save is None:
            return
        if rt.step_count - getattr(rt, "last_saved_step", 0) >= every:
            save(async_=True)

    def _until_t(self, drive: _Drive, blk) -> Optional[float]:
        t = drive.config.until_t
        if drive.config.stop_at_deadline and blk.deadline_at is not None:
            t = blk.deadline_at if t is None else min(t, blk.deadline_at)
        return t

    def _slack_s(self, blk, now: float) -> Optional[float]:
        """Effective deadline slack (time-to-deadline minus estimated
        remaining service time) — same notion the scheduler's waitlist
        ordering uses, feeding the policy's deadline boost."""
        if blk.deadline_at is None:
            return None
        slack = blk.deadline_at - now
        est = blk.request.est_steps
        if est:
            mon = self.ctl.monitor
            step_s = mon.step_time_estimate(blk.block_id)
            if step_s:
                slack -= max(0, est - mon.steps_done(blk.block_id)) * step_s
        return slack

    def drain_block(self, app_id: str, now: Optional[float] = None) -> int:
        """Harvest (and publish) every in-flight completion of an
        engine-driven block.  The controller calls this before suspending
        a victim so the eviction hides no finished work; the drive stays
        armed and re-arms automatically on resume."""
        drive = self._drives.get(app_id)
        rt = self.ctl.runtimes.get(app_id)
        if drive is None or rt is None:
            return 0
        recs = rt.drain()
        for rec in recs:
            self._publish_step(app_id, drive, rec, now)
        self._harvest_generate(app_id, drive, rt, now)
        return len(recs)

    def _pod_budget_shares(self) -> Dict[int, float]:
        """Per-pod power budget split evenly across that pod's runnable
        engine-driven blocks: pod_id -> chips-per-block share.  Pods
        without a declared ``power_budget_chips`` are absent (uncapped)."""
        reg = self.ctl.registry
        counts: Dict[int, int] = {}
        for app_id in self._drives:
            blk = reg.apps.get(app_id)
            if blk is None or blk.state is not BlockState.RUNNING or \
                    blk.grant is None or not blk.grant.coords:
                continue
            rt = self.ctl.runtimes.get(app_id)
            if rt is None or getattr(rt, "suspended", False):
                continue
            pid = blk.grant.coords[0][0]
            counts[pid] = counts.get(pid, 0) + 1
        shares: Dict[int, float] = {}
        pods = getattr(self.ctl, "pods", None)
        if pods is None:
            return shares
        for pid, n in counts.items():
            p = pods.get(pid)
            if p is not None and p.power_budget_chips is not None:
                shares[pid] = p.power_budget_chips / n
        return shares

    @runtime_check.guard_serialized("control-plane")
    def run_round(self, now: Optional[float] = None,
                  budget: Optional[int] = None,
                  pod: Optional[int] = None) -> int:
        """One engine round: harvest, checkpoint, terminate, dispatch.
        Returns the number of completions harvested plus dispatches made
        (0 = nothing to do).  Callers serialize rounds with every other
        mutation (the daemon runs them on the pump thread / under its
        inline lock).

        ``pod`` restricts harvesting/dispatch to blocks granted on that
        federation pod — each per-pod daemon worker drives only its own
        residents, so one slow pod cannot stall another's pump.  Drive
        cleanup (vanished/terminal blocks) always runs unfiltered."""
        if not self._drives:
            self.last_round_busy = False
            return 0
        round_t0 = time.perf_counter()
        t = now if now is not None else time.time()
        reg = self.ctl.registry
        shares = self._pod_budget_shares()
        work = 0
        pending = 0
        views: List[BlockView] = []
        runnable: Dict[str, object] = {}
        rated: set = set()       # blocks whose dispatches burn allowance
        for app_id in list(self._drives):
            drive = self._drives[app_id]
            blk = reg.apps.get(app_id)
            if blk is None:
                del self._drives[app_id]
                continue
            if blk.state in _TERMINAL:
                self.disable(app_id, reason=f"block {blk.state.value}",
                             now=now)
                continue
            if blk.state is not BlockState.RUNNING:
                continue             # queued/preempted: stay armed, idle
            rt = self.ctl.runtimes.get(app_id)
            if rt is None or getattr(rt, "suspended", False):
                continue
            self._refresh_grant(drive, blk)
            if pod is not None and drive.pod != pod:
                continue             # another pod's worker drives this one
            # harvest under a per-app span that joins the block's *bound*
            # trace (the request that bound it), not the worker thread's
            # incidental stack — see Tracer.span(parent="binding")
            with TRACER.span("engine.harvest", cat="engine", app_id=app_id,
                             parent="binding"):
                for rec in rt.poll(block=False):
                    self._publish_step(app_id, drive, rec, now)
                    work += 1
                work += self._harvest_generate(app_id, drive, rt, now)
            self._maybe_checkpoint(drive, rt)
            cfg = drive.config
            if cfg.until_steps is not None and \
                    rt.step_count >= cfg.until_steps:
                if rt.inflight_depth:
                    pending += rt.inflight_depth
                    continue         # harvest the stragglers next round
                reg.set_state(app_id, BlockState.DONE,
                              f"autostep ran to {rt.step_count} steps")
                self.ctl.bus.publish("autostep", app_id=app_id,
                                     block_id=drive.block_id,
                                     user=drive.user, now=now,
                                     action="done", steps=rt.step_count)
                del self._drives[app_id]
                continue
            until_t = self._until_t(drive, blk)
            if until_t is not None and t >= until_t:
                if rt.inflight_depth:
                    pending += rt.inflight_depth
                    continue
                self.disable(app_id, reason="run-until time reached",
                             now=now)
                continue
            if getattr(rt, "idle_serve", False):
                pending += rt.inflight_depth
                continue             # paged serve with no sessions: stay
                                     # armed, dispatch nothing (the next
                                     # generate command wakes it)
            room = self.ctl.scheduler.max_inflight - rt.inflight_depth
            if cfg.until_steps is not None:
                room = min(room, cfg.until_steps - rt.step_count
                           - rt.inflight_depth)
            # `is not None`, not truthiness: max_rate_hz=0.0 is a *pause*
            # (same falsy-zero class as the model-time fixes in PR 3)
            rate = cfg.max_rate_hz
            drive.derived_rate_hz = None
            if rate is None and drive.pod in shares:
                # adaptive pacing: the pod's power budget (chip-seconds
                # per second) split across its runnable blocks, converted
                # to a step rate with the online-learned step cost.  No
                # estimate yet -> uncapped warm-up until steps land.
                step_s = self.ctl.monitor.step_time_estimate(drive.block_id)
                if step_s:
                    rate = shares[drive.pod] / (step_s
                                                * max(1, drive.n_chips))
                    drive.derived_rate_hz = rate
            if rate is None:
                rate = self.policy.default_rate_hz
            if rate is not None:
                rated.add(app_id)
                if rate <= 0:
                    room = 0                 # paused, stays armed
                else:
                    if drive.last_refill is not None:
                        drive.allowance = min(
                            max(1.0, rate * 0.25),  # burst: a 1/4 second
                            drive.allowance
                            + (t - drive.last_refill) * rate)
                    drive.last_refill = t
                    room = min(room, int(drive.allowance))
            pending += rt.inflight_depth
            if room <= 0:
                continue
            view = BlockView(app_id=app_id, priority=drive.priority,
                             n_chips=drive.n_chips,
                             slack_s=self._slack_s(blk, t), room=room,
                             deficit=drive.deficit)
            views.append(view)
            runnable[app_id] = rt
        plan = self.policy.allocate(views, budget)
        for view in views:
            self._drives[view.app_id].deficit = view.deficit
        for app_id in plan:
            # paged serve decode rounds run synchronously inside
            # dispatch(), so their spans nest under this one
            with TRACER.span("engine.dispatch", cat="engine",
                             app_id=app_id, parent="binding"):
                runnable[app_id].dispatch()
            drive = self._drives[app_id]
            if app_id in rated:
                drive.allowance -= 1.0
            work += 1
            pending += 1
        self.last_round_busy = work > 0 or pending > 0
        REGISTRY.observe("repro_engine_round_seconds",
                         time.perf_counter() - round_t0)
        return work
