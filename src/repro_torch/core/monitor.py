"""Monitoring: per-block heartbeats, step-time EWMA, straggler detection,
usage accounting.  The paper's step (6): "the administrator and automated
system will monitor the usage of all running users".

The Monitor is one observability consumer among several: it aggregates
in-process roll-ups (EWMAs, straggler sets, usage totals) that feed the
scheduler and dashboards, while ``repro_torch.obs`` carries the rest of the
story — the metrics bridge turns the same bus events into Prometheus
series, the tracer records request-scoped spans, and the flight recorder
keeps the raw event tail for postmortems.  ``stragglers()`` is surfaced
both per-block (``daemon.status``) and as the ``repro_stragglers``
gauge.
"""
from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class BlockStats:
    block_id: str
    steps: int = 0
    last_heartbeat: float = 0.0
    ewma_step_s: Optional[float] = None
    step_times: List[float] = dataclasses.field(default_factory=list)
    chip_seconds: float = 0.0
    last_metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    # roofline model (set once at runtime attach): model_flops, n_chips,
    # peak_flops, step_time_s (modeled floor), bottleneck, source
    roofline: Optional[Dict] = None


class Monitor:
    EWMA_ALPHA = 0.2
    STRAGGLER_FACTOR = 1.5
    HEARTBEAT_TIMEOUT_S = 60.0

    def __init__(self):
        self._lock = threading.RLock()
        self.stats: Dict[str, BlockStats] = {}
        # admission-queue accounting (BlockScheduler feeds these)
        self.queue_depth = 0
        self.enqueued_total = 0
        self.admitted_total = 0
        self.queue_waits: List[float] = []       # seconds queued per admission
        # admission waits keyed by the actual priority value (not a binary
        # high/normal bin — with >= 3 priority levels binning corrupts the
        # per-class p50s); preemption_report aggregates classes
        self.queue_waits_by_class: Dict[int, List[float]] = {}
        self.util_samples: List[float] = []      # fraction of chips in use
        # deadline/SLO accounting (scheduler feeds admission-time slack)
        self.deadline_hits = 0
        self.deadline_misses = 0
        self.admission_slacks: List[float] = []  # deadline - admission time
        # preemption accounting (controller.preempt / scheduler feed these)
        self.preempted_total = 0
        self.resumed_total = 0
        self.progress_lost_steps: List[int] = []  # per eviction, pre-save
        self.resume_waits: List[float] = []       # seconds evicted->resumed
        # compile-cache accounting (CompileCache publishes kind="compile")
        self.compile_hits_total = 0
        self.compile_misses_total = 0
        # federation accounting (pod lifecycle + cross-pod migration)
        self.pods_joined_total = 0
        self.pods_lost_total = 0                  # left or died
        self.pods_degraded_total = 0
        self.migrated_total = 0
        self.migrations: List[Dict] = []          # {app_id, from_pod, to_pod}

    def _get(self, block_id: str) -> BlockStats:
        with self._lock:
            if block_id not in self.stats:
                self.stats[block_id] = BlockStats(block_id)
            return self.stats[block_id]

    # -------------------------------------------------- event subscription
    def on_event(self, ev) -> None:
        """EventBus subscriber: translate semantic lifecycle events into
        the accounting the ``record_*`` API keeps.  The scheduler and
        controller publish events instead of calling the Monitor directly;
        this mapping preserves the old call-for-call behavior (e.g. an
        ``immediate`` admission only records its SLO outcome, exactly like
        the old bare ``record_deadline`` call did)."""
        p = ev.payload
        if ev.kind == "step":
            self.record_step(ev.block_id, p["step_s"], p["n_chips"],
                             metrics=p.get("metrics"))
        elif ev.kind == "enqueued":
            self.record_enqueue(ev.app_id)
        elif ev.kind == "dequeued":
            self.record_dequeue(ev.app_id)
        elif ev.kind == "admitted":
            if p.get("immediate"):
                if p.get("slack_s") is not None:
                    self.record_deadline(p["slack_s"])
            else:
                self.record_admission(ev.app_id, p["wait_s"],
                                      priority=p.get("priority", 0),
                                      slack_s=p.get("slack_s"))
                if p.get("resumed"):
                    self.record_resume(ev.app_id, p["wait_s"])
        elif ev.kind == "preempted":
            self.record_preemption(ev.block_id,
                                   p.get("progress_lost_steps", 0))
        elif ev.kind == "utilization":
            self.sample_utilization(p["used_chips"], p["total_chips"])
        elif ev.kind == "pod":
            self.record_pod_event(p.get("action", ""))
        elif ev.kind == "migrated":
            self.record_migration(ev.app_id, p.get("from_pod"),
                                  p.get("to_pod"))
        elif ev.kind == "compile":
            self.record_compile(p.get("action", ""))

    def subscribe_to(self, bus) -> None:
        bus.subscribe(self.on_event,
                      kinds={"step", "enqueued", "dequeued", "admitted",
                             "preempted", "utilization", "pod", "migrated",
                             "compile"})

    def record_step(self, block_id: str, step_s: float, n_chips: int,
                    metrics: Optional[Dict[str, float]] = None) -> None:
        with self._lock:
            s = self._get(block_id)
            s.steps += 1
            s.last_heartbeat = time.time()
            s.step_times.append(step_s)
            if len(s.step_times) > 512:
                s.step_times = s.step_times[-256:]
            s.ewma_step_s = (step_s if s.ewma_step_s is None else
                             (1 - self.EWMA_ALPHA) * s.ewma_step_s
                             + self.EWMA_ALPHA * step_s)
            s.chip_seconds += step_s * n_chips
            if metrics:
                s.last_metrics = dict(metrics)

    def heartbeat(self, block_id: str) -> None:
        # the store must happen under the same lock _get uses: the helper
        # releases it on return, and an unguarded store can race dead_blocks
        with self._lock:
            self._get(block_id).last_heartbeat = time.time()

    # ------------------------------------------------------ admission queue
    def record_enqueue(self, app_id: str) -> None:
        with self._lock:
            self.queue_depth += 1
            self.enqueued_total += 1

    def record_dequeue(self, app_id: str) -> None:
        """Left the queue without admission (denied / force-expired)."""
        with self._lock:
            self.queue_depth = max(0, self.queue_depth - 1)

    def record_admission(self, app_id: str, wait_s: float,
                         priority: int = 0,
                         slack_s: Optional[float] = None) -> None:
        """``slack_s`` is the entry's deadline slack at admission time
        (deadline - now); negative means the request was admitted already
        past its SLO — a deadline miss."""
        with self._lock:
            self.queue_depth = max(0, self.queue_depth - 1)
            self.admitted_total += 1
            self.queue_waits.append(wait_s)
            if len(self.queue_waits) > 2048:
                self.queue_waits = self.queue_waits[-1024:]
            waits = self.queue_waits_by_class.setdefault(int(priority), [])
            waits.append(wait_s)
            if len(waits) > 2048:
                self.queue_waits_by_class[int(priority)] = waits[-1024:]
            if slack_s is not None:
                self.record_deadline(slack_s)

    def record_deadline(self, slack_s: float) -> None:
        """SLO outcome at admission: non-negative slack is a hit.  Also fed
        directly for immediate admissions that never entered the queue —
        otherwise only queued requests would count and the miss rate would
        be overstated."""
        with self._lock:
            self.admission_slacks.append(float(slack_s))
            if len(self.admission_slacks) > 2048:
                self.admission_slacks = self.admission_slacks[-1024:]
            if slack_s >= 0.0:
                self.deadline_hits += 1
            else:
                self.deadline_misses += 1

    def deadline_report(self) -> Dict[str, float]:
        """SLO outcome: admissions that happened with non-negative deadline
        slack (hits) vs. past-deadline (misses), plus the slack spread."""
        with self._lock:
            total = self.deadline_hits + self.deadline_misses
            slacks = self.admission_slacks
            return {
                "deadline_hits": self.deadline_hits,
                "deadline_misses": self.deadline_misses,
                "deadline_miss_rate": (self.deadline_misses / total
                                       if total else 0.0),
                "mean_admission_slack_s": (statistics.mean(slacks)
                                           if slacks else 0.0),
                "min_admission_slack_s": min(slacks) if slacks else 0.0,
            }

    # ------------------------------------------------------------ preemption
    def record_preemption(self, block_id: str,
                          progress_lost_steps: int) -> None:
        with self._lock:
            self.preempted_total += 1
            self.progress_lost_steps.append(int(progress_lost_steps))
            if len(self.progress_lost_steps) > 2048:
                self.progress_lost_steps = self.progress_lost_steps[-1024:]

    def record_resume(self, app_id: str, wait_s: float) -> None:
        with self._lock:
            self.resumed_total += 1
            self.resume_waits.append(wait_s)
            if len(self.resume_waits) > 2048:
                self.resume_waits = self.resume_waits[-1024:]

    def preemption_report(self) -> Dict[str, float]:
        """Eviction counts, victim progress-lost bounds, and the
        high-priority admission-wait delta preemption buys."""
        with self._lock:
            lost = self.progress_lost_steps
            # aggregate the per-priority-value classes: "high" is any
            # positive priority, "normal" is <= 0
            hi = [w for p, ws in self.queue_waits_by_class.items()
                  if p > 0 for w in ws]
            lo = [w for p, ws in self.queue_waits_by_class.items()
                  if p <= 0 for w in ws]
            p50_hi = statistics.median(hi) if hi else 0.0
            p50_lo = statistics.median(lo) if lo else 0.0
            rep = {
                "preempted_total": self.preempted_total,
                "resumed_total": self.resumed_total,
                "mean_progress_lost_steps": (statistics.mean(lost)
                                             if lost else 0.0),
                "max_progress_lost_steps": max(lost) if lost else 0,
                "mean_resume_wait_s": (statistics.mean(self.resume_waits)
                                       if self.resume_waits else 0.0),
                "p50_wait_high_s": p50_hi,
                "p50_wait_normal_s": p50_lo,
                "wait_delta_s": p50_lo - p50_hi,
            }
            for p, ws in sorted(self.queue_waits_by_class.items()):
                rep[f"p50_wait_p{p}_s"] = statistics.median(ws) if ws else 0.0
            return rep

    # --------------------------------------------------------- compile cache
    def record_compile(self, action: str) -> None:
        """A step executable was requested from the compile cache: ``hit``
        reused a prior build (preemption resume / scheduler rebuild on an
        identical signature), ``miss`` paid for a fresh XLA compile."""
        with self._lock:
            if action == "hit":
                self.compile_hits_total += 1
            elif action == "miss":
                self.compile_misses_total += 1

    def compile_report(self) -> Dict[str, float]:
        with self._lock:
            total = self.compile_hits_total + self.compile_misses_total
            return {
                "compile_hits_total": self.compile_hits_total,
                "compile_misses_total": self.compile_misses_total,
                "compile_hit_rate": (self.compile_hits_total / total
                                     if total else 0.0),
            }

    # -------------------------------------------------------------- roofline
    def set_roofline(self, block_id: str, roofline: Dict) -> None:
        """Attach the block's roofline model (``launch.hlo_analysis.
        block_roofline``): useful FLOPs per step, chips, per-chip peak and
        the modeled step-time floor.  The step-time EWMA then yields
        achieved-vs-peak utilization without touching the hot path."""
        with self._lock:
            self._get(block_id).roofline = dict(roofline)

    def mfu(self, block_id: Optional[str]) -> Optional[float]:
        """Model FLOPs utilization: useful FLOPs per step / (EWMA step time
        x chips x per-chip peak).  None until the block has both a roofline
        model and at least one measured step."""
        with self._lock:
            s = self.stats.get(block_id) if block_id else None
            if s is None or s.roofline is None or not s.ewma_step_s:
                return None
            r = s.roofline
            denom = (s.ewma_step_s * max(1, r.get("n_chips", 1))
                     * r.get("peak_flops", 0.0))
            return r.get("model_flops", 0.0) / denom if denom else None

    def roofline_report(self) -> Dict[str, Dict]:
        """Per-block achieved-vs-modeled performance + the cluster mean.

        ``of_roofline`` compares the measured EWMA to the *modeled* step-
        time floor (1.0 = running at the roofline); ``mfu`` compares to the
        raw compute peak.  A block far under its roofline with a healthy
        queue is the migration/straggler signal with units attached."""
        with self._lock:
            blocks: Dict[str, Dict] = {}
            mfus = []
            for bid, s in self.stats.items():
                if s.roofline is None:
                    continue
                r = s.roofline
                ew = s.ewma_step_s
                peak = r.get("peak_flops", 0.0)
                chips = max(1, r.get("n_chips", 1))
                mfu = (r.get("model_flops", 0.0) / (ew * chips * peak)
                       if ew and peak else None)
                if mfu is not None:
                    mfus.append(mfu)
                blocks[bid] = {
                    "mfu": mfu,
                    "ewma_step_s": ew,
                    "modeled_step_s": r.get("step_time_s"),
                    "of_roofline": (r["step_time_s"] / ew
                                    if ew and r.get("step_time_s") else None),
                    "achieved_flops_s": (r.get("model_flops", 0.0) / ew
                                         if ew else None),
                    "bottleneck": r.get("bottleneck"),
                    "source": r.get("source"),
                }
            return {"blocks": blocks,
                    "mean_mfu": (statistics.mean(mfus) if mfus else 0.0),
                    "n_modeled": len(blocks)}

    # ------------------------------------------------------------ federation
    def record_pod_event(self, action: str) -> None:
        with self._lock:
            if action == "joined":
                self.pods_joined_total += 1
            elif action in ("left", "dead"):
                self.pods_lost_total += 1
            elif action == "degraded":
                self.pods_degraded_total += 1

    def record_migration(self, app_id: Optional[str], from_pod,
                         to_pod) -> None:
        with self._lock:
            self.migrated_total += 1
            self.migrations.append({"app_id": app_id, "from_pod": from_pod,
                                    "to_pod": to_pod})
            if len(self.migrations) > 2048:
                self.migrations = self.migrations[-1024:]

    def federation_report(self) -> Dict[str, float]:
        """Pod lifecycle + migration counters for the cluster report."""
        with self._lock:
            return {
                "pods_joined_total": self.pods_joined_total,
                "pods_lost_total": self.pods_lost_total,
                "pods_degraded_total": self.pods_degraded_total,
                "migrated_total": self.migrated_total,
            }

    def sample_utilization(self, used_chips: int, total_chips: int) -> None:
        with self._lock:
            self.util_samples.append(used_chips / max(1, total_chips))
            if len(self.util_samples) > 2048:
                self.util_samples = self.util_samples[-1024:]

    def queue_report(self) -> Dict[str, float]:
        """Queue depth / wait-time / utilization summary for operators."""
        with self._lock:
            waits = self.queue_waits
            return {
                "depth": self.queue_depth,
                "enqueued_total": self.enqueued_total,
                "admitted_total": self.admitted_total,
                "mean_wait_s": statistics.mean(waits) if waits else 0.0,
                "max_wait_s": max(waits) if waits else 0.0,
                "utilization": (statistics.mean(self.util_samples)
                                if self.util_samples else 0.0),
                "utilization_now": (self.util_samples[-1]
                                    if self.util_samples else 0.0),
            }

    # -------------------------------------------- completion estimation
    def step_time_estimate(self, block_id: Optional[str]) -> Optional[float]:
        """Best per-step service-time estimate for a block: its own EWMA
        when it has run (e.g. a preempted victim awaiting resume), else the
        cluster-wide mean EWMA as a prior, else None (nothing has run — the
        scheduler then falls back to deadline-only slack)."""
        with self._lock:
            s = self.stats.get(block_id) if block_id else None
            if s is not None and s.ewma_step_s:
                return s.ewma_step_s
            vals = [st.ewma_step_s for st in self.stats.values()
                    if st.ewma_step_s]
            return statistics.mean(vals) if vals else None

    def steps_done(self, block_id: Optional[str]) -> int:
        with self._lock:
            s = self.stats.get(block_id) if block_id else None
            return s.steps if s is not None else 0

    # ----------------------------------------------------------- stragglers
    def stragglers(self) -> List[str]:
        """Blocks whose EWMA step time exceeds STRAGGLER_FACTOR x their own
        median — the signal the controller uses to trigger migration."""
        out = []
        with self._lock:
            for s in self.stats.values():
                if s.ewma_step_s is None or len(s.step_times) < 8:
                    continue
                med = statistics.median(s.step_times)
                if med > 0 and s.ewma_step_s > self.STRAGGLER_FACTOR * med:
                    out.append(s.block_id)
        return out

    def dead_blocks(self, now: Optional[float] = None) -> List[str]:
        # `now or time.time()` would silently substitute wall clock for a
        # model-time 0.0 and corrupt heartbeat accounting under a
        # simulated clock
        now = now if now is not None else time.time()
        with self._lock:
            return [s.block_id for s in self.stats.values()
                    if s.steps > 0 and
                    now - s.last_heartbeat > self.HEARTBEAT_TIMEOUT_S]

    def report(self) -> Dict[str, Dict]:
        with self._lock:
            return {
                bid: {
                    "steps": s.steps,
                    "ewma_step_s": s.ewma_step_s,
                    "chip_seconds": round(s.chip_seconds, 3),
                    "last_metrics": s.last_metrics,
                    "mfu": (s.roofline.get("model_flops", 0.0)
                            / (s.ewma_step_s
                               * max(1, s.roofline.get("n_chips", 1))
                               * s.roofline["peak_flops"])
                            if s.roofline and s.ewma_step_s
                            and s.roofline.get("peak_flops") else None),
                }
                for bid, s in self.stats.items()
            }
