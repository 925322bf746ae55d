"""BlockScheduler — admission queue + event-driven multi-block dispatch.

The paper's public-cluster property (and its follow-ups: "Multi and
Independent Block Approach", arXiv:0708.3446; openPC, arXiv:1012.2499) is
that one shared master absorbs *competing* block requests automatically.
The seed controller had neither piece: ``Partitioner.allocate`` raised
``AllocationError`` when the pod was full, and ``step_all`` round-robined
with a fixed-order ``block_until_ready`` so one slow block gated every
other block's next dispatch on the host thread.

Two subsystems fix that:

* **Admission queue** — ``submit()`` tries to allocate immediately; when
  the pod cannot fit the request the application is parked on a waitlist
  (registry state QUEUED) instead of raising.  ``pump()`` re-examines the
  waitlist whenever capacity frees (block expiry via ``tick()``, explicit
  ``expire()``, elastic shrink) and admits entries in fair-share order:
  priority first, then fewest currently-held chips per user, then FIFO.
  Entries that fit are backfilled past ones that don't, so a large stuck
  request doesn't idle chips a small request could use.

* **Event-driven dispatch** — ``drive()`` keeps up to ``max_inflight``
  async steps outstanding per block (dispatch-depth backpressure) and
  harvests completions in whatever order the devices finish, blocking only
  when every window is full and nothing is ready.  A slow block therefore
  never stalls a fast block's next dispatch on the host thread.

* **Checkpoint-backed preemption** — when a waitlisted entry outranks a
  running block (strictly higher priority) and no free rectangle fits it,
  ``pump()`` picks a victim by (priority asc, progress-lost = steps since
  its last checkpoint asc, held chips asc), suspends it (drain in-flight →
  synchronous checkpoint → release chips) and admits the waiter.  The
  victim re-enters the waitlist *ahead of its fair-share class* and is
  auto-resumed by ``tick()`` — on a possibly different chip set / mesh
  geometry — as capacity frees.  The strict-priority requirement is the
  no-churn guard: two equal-priority blocks can never evict each other in
  a loop.

* **Tenancy policy** — a ``SchedulingPolicy`` (``repro_torch.core.policy``) is
  consulted at three points: at *submit* and *pump* time,
  ``admission_blocked`` enforces per-user quotas (held-chip caps and
  chip-second budgets fed from ``Monitor.chip_seconds``) — over-quota
  requests are *waitlisted*, never denied, and become admissible again as
  the user's blocks retire; at *pump* time, ``waitlist_key`` orders each
  fair-share class by least deadline slack instead of FIFO (queue entries
  carry an absolute ``deadline_at`` computed at submission), with the
  Monitor recording admission-time slack as deadline hits/misses; at
  *preempt* time, ``victim_key`` promotes quota-busting running blocks to
  preferred victims ahead of the (priority, progress-lost, chips) key.

* **Gang admission** — ``submit_gang([...])`` admits a *set* of blocks
  atomically (multi-block jobs that must co-start, e.g. trainer + eval
  server): ``Partitioner.allocate_many`` finds every rectangle under one
  lock hold and rolls back on partial failure, the waitlist treats the
  gang as one all-or-nothing unit, and victim selection frees room for
  the whole gang or evicts nothing.  Evicted members re-enter the
  waitlist as a gang unit too, so co-start also holds across evictions.

* **Completion-aware slack** — within a fair-share class, ordering uses
  *effective* slack: time-to-deadline minus the estimated remaining
  service time (the request's declared ``est_steps`` x the Monitor's
  EWMA step time), so ordering reflects time-to-complete, not just
  time-to-deadline.  Victim selection likewise weighs each candidate's
  own deadline headroom and never evicts a block into a miss it would
  not otherwise have had (``SchedulingPolicy.victim_deadline_exempt``).

Scheduling decisions are published on the controller's ``EventBus``
(``admitted``/``enqueued``/``preempted``/``step``/...); the ``Monitor``
subscribes instead of being called directly.

``SimRuntime`` is a wall-clock model of a block's serial step chain used
by the scheduler benchmarks and tests (no devices required).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

from repro_torch.analysis import runtime_check
from repro_torch.core.block import BlockGrant, BlockState
from repro_torch.core.inflight import InflightWindow
from repro_torch.core.partition import AllocationError
from repro_torch.core.policy import SchedulingPolicy
from repro_torch.obs.trace import TRACER


@dataclasses.dataclass
class QueueEntry:
    app_id: str
    user: str
    n_chips: int
    priority: int
    enqueued_at: float
    seq: int                          # registry FIFO sequence number
    pod: Optional[int] = None
    job: Optional[object] = None      # JobSpec -> auto activate+run on admit
    preempted: bool = False           # evicted victim awaiting auto-resume
    deadline_at: Optional[float] = None  # absolute SLO deadline (slack order)
    gang_id: Optional[str] = None     # all-or-nothing co-admission set


# ----------------------------------------------------------------- dispatch
def drive(runtimes: Mapping[str, object], targets: Mapping[str, int],
          max_inflight: int = 2,
          on_step: Optional[Callable[[str, Dict[str, float]], None]] = None,
          ) -> Dict[str, List[Dict[str, float]]]:
    """Run each runtime for ``targets[app_id]`` steps, event-driven.

    Runtimes need the in-flight window protocol: ``dispatch()``,
    ``poll(block=False)``, ``inflight_depth``, ``oldest_dispatch_t()``.
    Steps are dispatched while a
    block's window has room and harvested as they finish; when every window
    is full and nothing is ready, we block on the runtime with the oldest
    outstanding dispatch rather than spinning.
    """
    remaining = {a: int(n) for a, n in targets.items()
                 if a in runtimes and n > 0}
    out: Dict[str, List[Dict[str, float]]] = {a: [] for a in remaining}

    def harvest(app_id: str, block: bool = False) -> int:
        n = 0
        for rec in runtimes[app_id].poll(block=block):
            out[app_id].append(rec)
            if on_step is not None:
                on_step(app_id, rec)
            n += 1
        return n

    while True:
        dispatched = 0
        for app_id in list(remaining):
            rt = runtimes[app_id]
            while remaining[app_id] > 0 and rt.inflight_depth < max_inflight:
                rt.dispatch()
                remaining[app_id] -= 1
                dispatched += 1
        harvested = sum(harvest(a) for a in out)
        busy = [a for a in out if runtimes[a].inflight_depth > 0]
        if not busy and all(v == 0 for v in remaining.values()):
            return out
        if dispatched == 0 and harvested == 0 and busy:
            # every window full / work pending: wait on the oldest dispatch
            oldest = min(busy, key=lambda a: runtimes[a].oldest_dispatch_t())
            harvest(oldest, block=True)


class BlockScheduler:
    """Admission queue + dispatch loop over a ClusterController."""

    def __init__(self, ctl, max_inflight: int = 2,
                 preemption_enabled: bool = True,
                 policy: Optional[SchedulingPolicy] = None):
        self.ctl = ctl
        self.max_inflight = max_inflight
        self.preemption_enabled = preemption_enabled
        self.policy = policy or SchedulingPolicy()
        self.waitlist: Dict[str, QueueEntry] = {}   # app_id -> entry

    # ------------------------------------------------------------ admission
    def _entry_for(self, app_id: str, job: Optional[object],
                   priority: Optional[int], pod: Optional[int],
                   deadline_s: Optional[float], now: float) -> QueueEntry:
        """Build a queue entry, persisting overrides onto the request: after
        admission the request is the canonical record, and preemption
        (victim selection, requeue) must see the same priority/pod/deadline
        that admission used."""
        blk = self.ctl.registry.get(app_id)
        if priority is not None:
            blk.request.priority = priority
        if pod is not None:
            blk.request.pod = pod
        if deadline_s is not None:
            blk.request.deadline_s = deadline_s
        if blk.request.deadline_s is not None and blk.deadline_at is None:
            # the SLO clock starts at submission and is absolute from then
            # on — requeues after preemption keep the original deadline
            blk.deadline_at = now + blk.request.deadline_s
        return QueueEntry(
            app_id=app_id, user=blk.request.user,
            n_chips=blk.request.n_chips,
            priority=blk.request.priority,
            enqueued_at=now, seq=0, pod=blk.request.pod, job=job,
            deadline_at=blk.deadline_at, gang_id=blk.request.gang_id)

    def submit(self, app_id: str, job: Optional[object] = None,
               priority: Optional[int] = None,
               pod: Optional[int] = None,
               deadline_s: Optional[float] = None,
               now: Optional[float] = None) -> Optional[BlockGrant]:
        """Admit a registered application now, or park it on the waitlist.

        Returns the grant on immediate admission, None when queued.  With a
        ``job`` the block is auto-confirmed, activated and run on admission
        (immediately or later from ``pump()``), so a caller can fire
        arbitrary request traffic at the cluster and let it absorb the load.
        Requests the user's quota cannot cover are waitlisted (not denied)
        until the user's running blocks retire.  ``now`` keeps deadline and
        wait accounting on the model clock under a simulated-clock driver.
        """
        now = now if now is not None else time.time()
        blk = self.ctl.registry.get(app_id)
        with TRACER.span("sched.submit", cat="sched", app_id=app_id,
                         user=blk.request.user,
                         n_chips=blk.request.n_chips) as sp:
            if not self.ctl.partitioner.shape_possible(blk.request.n_chips):
                # never admissible (invalid size / exceeds pod geometry):
                # waitlisting would park it forever, so reject up front
                self.ctl.registry.deny(
                    app_id,
                    f"{blk.request.n_chips} chips can never fit this pod")
                sp.set(outcome="denied")
                return None
            entry = self._entry_for(app_id, job, priority, pod, deadline_s,
                                    now)
            if self._submit_unit([entry], now):
                sp.set(outcome="admitted")
                return self.ctl.registry.get(app_id).grant
            sp.set(outcome="queued")
            return None

    def submit_gang(self, app_ids: List[str],
                    jobs: Optional[Mapping[str, object]] = None,
                    priority: Optional[int] = None,
                    pod: Optional[int] = None,
                    deadline_s: Optional[float] = None,
                    now: Optional[float] = None
                    ) -> Optional[Dict[str, BlockGrant]]:
        """All-or-nothing admission of a set of registered applications
        (multi-block jobs that must co-start).  Returns ``{app_id: grant}``
        when the whole gang is admitted now, None when it was waitlisted as
        a unit — no member is ever admitted without the others, and a
        failed attempt leaves the partitioner inventory untouched."""
        now = now if now is not None else time.time()
        jobs = jobs or {}
        reg = self.ctl.registry
        part = self.ctl.partitioner
        if not all(part.shape_possible(reg.get(a).request.n_chips)
                   for a in app_ids):
            for a in app_ids:       # one impossible member dooms the gang
                reg.deny(a, "gang member can never fit this pod")
            return None
        gang_id = f"gang_{app_ids[0]}"
        unit = []
        for app_id in app_ids:
            reg.get(app_id).request.gang_id = gang_id
            unit.append(self._entry_for(app_id, jobs.get(app_id),
                                        priority, pod, deadline_s, now))
        if self._submit_unit(unit, now):
            return {e.app_id: reg.get(e.app_id).grant for e in unit}
        return None

    def _submit_unit(self, unit: List[QueueEntry], now: float) -> bool:
        """Shared submission sequence for a singleton or gang unit: admit
        the existing waitlist first (so a newcomer can't jump a
        higher-ranked entry that also fits), try immediate admission —
        zero-wait admissions count as SLO outcomes too, or the miss rate
        would only see requests that queued — otherwise enqueue every
        member and backfill (pump admits in fair-share order with
        skip-past).  Returns True when the whole unit holds grants."""
        # a unit whose chip footprint exceeds its user's own cap can never
        # become admissible (no running block of theirs can retire enough):
        # waitlisting would park it forever, so reject up front the way
        # shape_possible rejects geometrically-impossible sizes
        per_user: Dict[str, int] = {}
        for e in unit:
            per_user[e.user] = per_user.get(e.user, 0) + e.n_chips
        for user, req in per_user.items():
            cap = self.policy.quota_for(user).max_chips
            if cap is not None and req > cap:
                for e in unit:
                    self.ctl.registry.deny(
                        e.app_id,
                        f"quota: {req} chips exceeds {user}'s cap {cap}")
                return False
        self.pump(now)
        quota_reason = self._quota_blocked(unit, self._held_chips_by_user(),
                                           self._chip_seconds_by_user())
        if not self.waitlist and quota_reason is None:
            if self._admit_unit(unit, now) is not None:
                for e in unit:
                    blk = self.ctl.registry.get(e.app_id)
                    slack = (None if e.deadline_at is None
                             else e.deadline_at - now)
                    self.ctl.bus.publish(
                        "admitted", app_id=e.app_id, block_id=blk.block_id,
                        user=e.user, now=now, immediate=True, wait_s=0.0,
                        priority=e.priority, slack_s=slack)
                return True
        note = (f"gang {unit[0].gang_id} waitlisted" if len(unit) > 1
                else "waitlisted")
        for entry in unit:
            entry.seq = self.ctl.registry.enqueue(
                entry.app_id,
                quota_reason or f"{note}: {entry.n_chips} chips unavailable",
                now=now)
            entry.enqueued_at = self.ctl.registry.get(entry.app_id).queued_at
            self.waitlist[entry.app_id] = entry
            self.ctl.bus.publish("enqueued", app_id=entry.app_id,
                                 user=entry.user, now=now,
                                 priority=entry.priority,
                                 n_chips=entry.n_chips)
        self.pump(now)
        return all(e.app_id not in self.waitlist for e in unit)

    def _held_chips_by_user(self) -> Dict[str, int]:
        held: Dict[str, int] = {}
        reg = self.ctl.registry
        for app_id in reg.by_state(BlockState.APPROVED, BlockState.CONFIRMED,
                                   BlockState.ACTIVE, BlockState.RUNNING,
                                   BlockState.DONE):
            blk = reg.get(app_id)
            if blk.grant:
                held[blk.request.user] = (held.get(blk.request.user, 0)
                                          + blk.grant.n_chips)
        return held

    def _chip_seconds_by_user(self) -> Dict[str, float]:
        """Cumulative per-user compute spend, aggregated from the Monitor's
        per-block chip-second accounting (the quota budget input)."""
        used: Dict[str, float] = {}
        mon = self.ctl.monitor
        for blk in list(self.ctl.registry.apps.values()):
            if blk.block_id:
                s = mon.stats.get(blk.block_id)
                if s is not None:
                    used[blk.request.user] = (used.get(blk.request.user, 0.0)
                                              + s.chip_seconds)
        return used

    def _quota_blocked(self, unit: List[QueueEntry],
                       held: Dict[str, int],
                       used: Dict[str, float]) -> Optional[str]:
        """Policy consultation: may this admission unit (singleton or whole
        gang) be admitted under its users' quotas right now?  Returns the
        blocking reason, or None.  Blocked units stay waitlisted."""
        per_user: Dict[str, int] = {}
        for e in unit:
            per_user[e.user] = per_user.get(e.user, 0) + e.n_chips
        for user, req in per_user.items():
            reason = self.policy.admission_blocked(
                user, req, held.get(user, 0), used.get(user, 0.0))
            if reason:
                return reason
        return None

    def _service_estimate_s(self, entry: QueueEntry) -> float:
        """Estimated remaining service time for a waitlisted entry: the
        requester's declared ``est_steps`` (minus steps already run — a
        preempted victim resumes mid-job) times the Monitor's EWMA step
        time (the block's own when it has run, else the cluster mean).
        0.0 when nothing is declared or nothing has ever run, which
        degrades slack back to pure time-to-deadline."""
        blk = self.ctl.registry.get(entry.app_id)
        est = blk.request.est_steps
        if not est:
            return 0.0
        step_s = self.ctl.monitor.step_time_estimate(blk.block_id)
        if not step_s:
            return 0.0
        done = self.ctl.monitor.steps_done(blk.block_id)
        return max(0, est - done) * step_s

    def _entry_key(self, entry: QueueEntry, held: Dict[str, int],
                   now: float):
        return self.policy.waitlist_key(entry, held.get(entry.user, 0),
                                        now, self._service_estimate_s(entry))

    def ordered_waitlist(self, now: Optional[float] = None
                         ) -> List[QueueEntry]:
        """Fair-share admission order (policy's ``waitlist_key``): priority
        desc, then preempted victims ahead of their fair-share class (they
        already earned their slot once and paid an eviction), then fewest
        chips the user currently holds, then least effective deadline slack
        (time-to-deadline minus estimated time-to-complete), then FIFO."""
        now = now if now is not None else time.time()
        held = self._held_chips_by_user()
        return sorted(self.waitlist.values(),
                      key=lambda e: self._entry_key(e, held, now))

    def _units(self, now: float,
               held: Dict[str, int]) -> List[List[QueueEntry]]:
        """Admission units in fair-share order: singleton entries, plus
        gangs grouped into one all-or-nothing unit ranked by their best
        member.  Preempted gang members re-enter as a gang unit too —
        co-start holds across evictions, so a half-evicted gang co-resumes
        instead of trickling back one member at a time."""
        gangs: Dict[str, List[QueueEntry]] = {}
        units: List[List[QueueEntry]] = []
        for e in self.waitlist.values():
            if e.gang_id is not None:
                gangs.setdefault(e.gang_id, []).append(e)
            else:
                units.append([e])
        units.extend(gangs.values())

        def unit_key(unit: List[QueueEntry]):
            return min(self._entry_key(e, held, now) for e in unit)

        units.sort(key=unit_key)
        for unit in units:
            unit.sort(key=lambda e: e.seq)
        return units

    def requeue_preempted(self, app_id: str, seq: int) -> None:
        """Park an evicted block on the waitlist for auto-resume (the
        registry has already transitioned it to PREEMPTED and assigned the
        queue sequence number)."""
        blk = self.ctl.registry.get(app_id)
        self.waitlist[app_id] = QueueEntry(
            app_id=app_id, user=blk.request.user,
            n_chips=blk.grant.n_chips if blk.grant else blk.request.n_chips,
            priority=blk.request.priority, enqueued_at=blk.queued_at,
            seq=seq, pod=blk.request.pod, preempted=True,
            deadline_at=blk.deadline_at, gang_id=blk.request.gang_id)
        self.ctl.bus.publish("enqueued", app_id=app_id,
                             user=blk.request.user, block_id=blk.block_id,
                             priority=blk.request.priority, preempted=True)

    def _try_admit(self, entry: QueueEntry) -> Optional[BlockGrant]:
        try:
            if entry.preempted:
                # victim re-admission: restore, don't re-grant — the block
                # keeps its identity/token and resumes from its checkpoint
                return self.ctl.resume(entry.app_id)
            grant = self.ctl.grant_block(entry.app_id, entry.n_chips,
                                         pod=entry.pod)
        except AllocationError:
            return None
        if entry.job is not None:
            self.ctl.confirm(entry.app_id, grant.token)
            self.ctl.activate(entry.app_id, entry.job)
            self.ctl.run(entry.app_id)
        return grant

    def _try_admit_gang(self, unit: List[QueueEntry],
                        now: Optional[float] = None
                        ) -> Optional[Dict[str, BlockGrant]]:
        """Admit every member of a gang or none: ``grant_gang`` allocates
        all rectangles under one partitioner lock hold and rolls back on
        partial failure, so a None return leaves the inventory untouched."""
        try:
            grants = self.ctl.grant_gang([e.app_id for e in unit])
        except AllocationError:
            return None
        try:
            for e in unit:
                if e.job is not None:
                    self.ctl.confirm(e.app_id, grants[e.app_id].token)
                    self.ctl.activate(e.app_id, e.job)
                    self.ctl.run(e.app_id)
        except Exception:
            # co-start is all-or-nothing through boot too: a member whose
            # activation fails must not leave its siblings half-running —
            # terminate the whole gang (drain + release) and surface the
            # boot error
            for e in unit:
                try:
                    self.ctl.expire(e.app_id, now=now)
                except Exception:
                    pass
            raise
        return grants

    def _try_resume_gang(self, unit: List[QueueEntry],
                         now: Optional[float] = None
                         ) -> Optional[Dict[str, BlockGrant]]:
        """Co-resume every preempted member of a gang or none: the dry-run
        ``can_fit_many`` and the per-member ``resume`` allocations run the
        same first-fit search in the same order on the same single thread,
        so after the dry run passes each resume finds its rectangle.  On an
        unexpected mid-loop failure the already-resumed members are
        gracefully re-evicted (suspend + requeue), restoring the
        all-or-nothing property."""
        part = self.ctl.partitioner
        if not part.can_fit_many([(e.n_chips, e.pod) for e in unit]):
            return None
        grants: Dict[str, BlockGrant] = {}
        try:
            for e in unit:
                grants[e.app_id] = self.ctl.resume(e.app_id)
        except AllocationError:
            for a in list(grants):
                # the member never left the waitlist (entries are removed
                # only after the whole unit admits), and preempt() ->
                # requeue_preempted re-adds it — retire the stale entry's
                # accounting first or queue_depth inflates forever
                blk = self.ctl.registry.get(a)
                self.ctl.bus.publish("dequeued", app_id=a,
                                     user=blk.request.user)
                self.ctl.preempt(a, reason="gang co-resume rolled back",
                                 now=now)
            return None
        return grants

    def _admit_unit(self, unit: List[QueueEntry],
                    now: Optional[float] = None
                    ) -> Optional[Dict[str, BlockGrant]]:
        if len(unit) == 1:
            grant = self._try_admit(unit[0])
            return None if grant is None else {unit[0].app_id: grant}
        if all(e.preempted for e in unit):
            # evicted gang members co-resume as one unit (members of a
            # waitlisted-then-preempted mix cannot occur: a gang is either
            # entirely queued pre-admission or its evicted subset is
            # entirely PREEMPTED)
            return self._try_resume_gang(unit, now=now)
        return self._try_admit_gang(unit, now=now)

    def _unit_fits(self, unit: List[QueueEntry]) -> bool:
        if len(unit) == 1:
            return self.ctl.partitioner.can_fit(unit[0].n_chips, unit[0].pod)
        return self.ctl.partitioner.can_fit_many(
            [(e.n_chips, e.pod) for e in unit])

    def _prune_waitlist(self) -> None:
        """Drop entries whose application left the QUEUED (or, for evicted
        victims, PREEMPTED) state behind the scheduler's back (admin deny,
        forced expiry): admitting them would be an illegal transition and
        would leak their chips.  A pruned gang member takes its whole gang
        with it — the survivors could never co-start."""
        pruned_gangs = set()
        for app_id, entry in list(self.waitlist.items()):
            expect = (BlockState.PREEMPTED if entry.preempted
                      else BlockState.QUEUED)
            if self.ctl.registry.get(app_id).state != expect:
                del self.waitlist[app_id]
                self.ctl.bus.publish("dequeued", app_id=app_id,
                                     user=entry.user)
                if entry.gang_id is not None and not entry.preempted:
                    pruned_gangs.add(entry.gang_id)
        for app_id, entry in list(self.waitlist.items()):
            if entry.gang_id in pruned_gangs and not entry.preempted:
                del self.waitlist[app_id]
                self.ctl.bus.publish("dequeued", app_id=app_id,
                                     user=entry.user)
                self.ctl.registry.deny(
                    app_id, f"gang {entry.gang_id} member withdrawn")

    # the waitlist dict has no lock of its own by design: every mutation is
    # daemon-serialized, which REPRO_RACE_CHECK=1 asserts at runtime
    @runtime_check.guard_serialized("control-plane")
    def pump(self, now: Optional[float] = None,
             sample_util: bool = False) -> List[str]:
        """Admit waitlisted admission units that now fit, in fair-share +
        deadline-slack order (with backfill past units that don't fit or
        are quota-blocked).  When nothing fits and preemption is enabled,
        evict the cheapest sufficient set of strictly-lower-priority
        running blocks per round to make room for the best-ranked unit.
        Called from ``tick()`` and after every expiry/shrink.

        ``sample_util=True`` (the tick path) additionally publishes one
        pod-utilization event computed from the held-chips snapshot the
        admission loop already builds — the Monitor's utilization sampling
        rides the pump's own bookkeeping instead of a second inventory
        scan per tick (which matters once the autostep engine has the
        pump looping at step cadence)."""
        if not TRACER.enabled:
            return self._pump_body(now, sample_util)
        with TRACER.span("sched.pump", cat="sched") as sp:
            admitted = self._pump_body(now, sample_util)
            sp.set(admitted=len(admitted))
            return admitted

    def _pump_body(self, now: Optional[float],
                   sample_util: bool) -> List[str]:
        admitted: List[str] = []
        # `now or time.time()` would swap wall clock in for model-time 0.0
        # and corrupt wait accounting under a simulated clock
        now = now if now is not None else time.time()
        self._prune_waitlist()
        while True:
            progress = False
            held = self._held_chips_by_user()
            used = self._chip_seconds_by_user()
            for unit in self._units(now, held):
                if self._quota_blocked(unit, held, used) is not None:
                    continue     # stays waitlisted until usage drops
                if not self._unit_fits(unit):
                    continue
                if self._admit_unit(unit, now) is None:
                    continue
                for e in unit:
                    del self.waitlist[e.app_id]
                    wait_s = max(0.0, now - e.enqueued_at)
                    # a resume is not a second SLO outcome: the job's
                    # deadline hit/miss was recorded at first admission
                    slack = (None if e.deadline_at is None or e.preempted
                             else e.deadline_at - now)
                    blk = self.ctl.registry.get(e.app_id)
                    self.ctl.bus.publish(
                        "admitted", app_id=e.app_id, block_id=blk.block_id,
                        user=e.user, now=now, wait_s=wait_s,
                        priority=e.priority, slack_s=slack,
                        resumed=e.preempted)
                    admitted.append(e.app_id)
                progress = True
                break    # holdings changed: recompute fair-share order
            if not progress and self.preemption_enabled:
                progress = self._preempt_for_waiters(now, held, used)
            if not progress:
                break
        if sample_util:
            # final-iteration `held` is current (that iteration admitted
            # nothing); its sum is exactly the chips blocks hold right now
            self.ctl.bus.publish(
                "utilization", now=now,
                used_chips=sum(held.values()),
                total_chips=self.ctl.total_chips())
        return admitted

    # ----------------------------------------------------------- preemption
    def _preempt_for_waiters(self, now: Optional[float] = None,
                             held: Optional[Dict[str, int]] = None,
                             used: Optional[Dict[str, float]] = None) -> bool:
        """Evict running block(s) so the best-ranked admission unit that
        cannot currently fit gets room.  Returns True when victims were
        suspended (the caller's next fair-share pass then admits the
        unit)."""
        now = now if now is not None else time.time()
        held = held if held is not None else self._held_chips_by_user()
        used = used if used is not None else self._chip_seconds_by_user()
        for unit in self._units(now, held):
            if self._quota_blocked(unit, held, used) is not None:
                continue     # never evict for a unit quota forbids admitting
            victims = self._select_victims(unit, held, used, now)
            if not victims:
                continue
            label = (unit[0].gang_id if len(unit) > 1 else unit[0].app_id)
            with TRACER.span("sched.evict", cat="sched", target=label,
                             victims=len(victims)):
                for victim in victims:
                    self.ctl.preempt(
                        victim, reason=f"evicted for {label} "
                                       f"(priority {unit[0].priority})",
                        now=now)
            return True
        return False

    def _victim_remaining_s(self, blk) -> float:
        """Estimated service time the victim still needs (declared
        ``est_steps`` minus steps run, times its EWMA step time); 0.0 when
        undeclared — its deadline slack then stands in alone."""
        est = blk.request.est_steps
        if not est or blk.block_id is None:
            return 0.0
        step_s = self.ctl.monitor.step_time_estimate(blk.block_id)
        if not step_s:
            return 0.0
        done = self.ctl.monitor.steps_done(blk.block_id)
        return max(0, est - done) * step_s

    def _select_victims(self, unit: List[QueueEntry],
                        held: Dict[str, int],
                        used: Dict[str, float],
                        now: Optional[float] = None) -> List[str]:
        """Victim choice for an admission unit: among running/active blocks
        of *strictly* lower priority than every member (the no-churn guard
        — equal-priority blocks can never evict each other in a loop),
        ranked by the policy's victim key — quota-busting blocks first,
        then (priority, deadline headroom desc, progress-lost = steps since
        the victim's last checkpoint, held chips): least important, least
        SLO-pressured, cheapest-to-stop, smallest.  A victim the eviction
        would push into a deadline miss it would not otherwise have had
        (on-track, headroom under the policy margin) is exempt entirely.
        Prefer a single victim whose chips let the whole unit
        fit; a footprint spanning several smaller blocks gets the shortest
        rank-order prefix of victims that frees enough contiguous room for
        *every* member (gang admission evicts for the whole gang or not at
        all).  Returns [] (and nothing is evicted) when even the full
        eligible set would not make the unit fit."""
        now = now if now is not None else time.time()
        reg = self.ctl.registry
        part = self.ctl.partitioner
        floor = min(e.priority for e in unit)
        footprint = [(e.n_chips, e.pod) for e in unit]
        eligible: List[Tuple[Tuple, str, str]] = []
        for app_id in reg.by_state(BlockState.RUNNING, BlockState.ACTIVE):
            blk = reg.get(app_id)
            if blk.grant is None or blk.request.priority >= floor:
                continue
            remaining_s = self._victim_remaining_s(blk)
            if self.policy.victim_deadline_exempt(blk.deadline_at, now,
                                                  remaining_s):
                continue
            rt = self.ctl.runtimes.get(app_id)
            progress_lost = int(getattr(rt, "progress_lost", 0) or 0)
            over = self.policy.over_quota(
                blk.request.user, held.get(blk.request.user, 0),
                used.get(blk.request.user, 0.0))
            key = self.policy.victim_key(
                over, blk.request.priority, progress_lost,
                blk.grant.n_chips,
                headroom_s=self.policy.victim_headroom(
                    blk.deadline_at, now, remaining_s))
            eligible.append((key, app_id, blk.grant.block_id))
        eligible.sort()
        for _, app_id, block_id in eligible:
            if part.can_fit_many(footprint, [block_id]):
                return [app_id]
        chosen: List[str] = []
        freed: List[str] = []
        for _, app_id, block_id in eligible:
            chosen.append(app_id)
            freed.append(block_id)
            if part.can_fit_many(footprint, freed):
                break
        else:
            return []
        # prune: a rank-order prefix can include victims whose chips don't
        # actually contribute to the fit (wrong pod / outside the found
        # rectangle) — never evict a block the waiter doesn't need
        for app_id, block_id in list(zip(chosen, freed))[:-1]:
            without = [b for b in freed if b != block_id]
            if part.can_fit_many(footprint, without):
                chosen.remove(app_id)
                freed.remove(block_id)
        return chosen

    def queue_depth(self) -> int:
        self._prune_waitlist()
        return len(self.waitlist)

    # ------------------------------------------------------------- dispatch
    @runtime_check.guard_serialized("control-plane")
    def run_dispatch(self, targets: Union[int, Mapping[str, int]],
                     max_inflight: Optional[int] = None,
                     ) -> Dict[str, List[Dict[str, float]]]:
        """Event-driven stepping of RUNNING blocks.

        ``targets`` is either a per-app step count or a single int applied
        to every RUNNING block.  Completions feed the Monitor as they land.
        """
        reg = self.ctl.registry
        if isinstance(targets, int):
            targets = {a: targets for a in reg.by_state(BlockState.RUNNING)}
        runtimes = {a: self.ctl.runtimes[a] for a in targets
                    if a in self.ctl.runtimes}

        def on_step(app_id: str, rec: Dict[str, float]) -> None:
            blk = reg.get(app_id)
            metrics = {k: v for k, v in rec.items() if k != "step_s"}
            self.ctl.bus.publish("step", app_id=app_id,
                                 block_id=blk.block_id,
                                 user=blk.request.user,
                                 step_s=rec["step_s"],
                                 n_chips=blk.grant.n_chips,
                                 metrics=metrics or None)

        # `max_inflight or ...` would turn an explicit 0 ("dispatch
        # nothing") into the scheduler default — same falsy-zero trap as
        # the model-time `now` parameters
        return drive(runtimes, targets,
                     max_inflight=(max_inflight if max_inflight is not None
                                   else self.max_inflight),
                     on_step=on_step)


# ---------------------------------------------------------------- simulation
class SimRuntime(InflightWindow):
    """Wall-clock model of a block runtime: steps are serially dependent
    within the block (each becomes ready ``step_s`` after its predecessor)
    and concurrent across blocks — the paper's disjoint-sub-mesh model.

    Shares the in-flight window protocol (``dispatch``/``poll``/``drain``)
    with BlockRuntime via InflightWindow; a completion token here is the
    model-time interval ``(start, ready_at)``.  Also models the preemption
    surface — periodic checkpoints every ``ckpt_every`` steps feeding
    ``progress_lost``, plus ``suspend``/``resume`` — so scheduler tests and
    benchmarks exercise the full eviction path without devices."""

    def __init__(self, step_s: float, ckpt_every: int = 0):
        self.step_s = step_s
        self.step_count = 0
        self.ckpt_every = ckpt_every       # 0 = checkpoint only on suspend
        self.last_saved_step = 0
        self.suspended = False
        self._chain_free_at = 0.0          # when the serial chain is idle
        self._init_window()

    # --------------------------------------------- InflightWindow hooks
    def _launch(self):
        now = time.perf_counter()
        start = max(now, self._chain_free_at)
        self._chain_free_at = start + self.step_s
        return (start, self._chain_free_at)

    def _token_ready(self, token) -> bool:
        return time.perf_counter() >= token[1]

    def _token_wait(self, token) -> None:
        now = time.perf_counter()
        if now < token[1]:
            time.sleep(token[1] - now)

    def _completion_record(self, dispatch_t: float, token) -> Dict[str, float]:
        start, ready_at = token
        self.step_count += 1
        if self.ckpt_every and self.step_count % self.ckpt_every == 0:
            self.last_saved_step = self.step_count   # periodic checkpoint
        # model execution time only (not wait-behind-predecessor): the same
        # serial-chain accounting BlockRuntime's completions use
        return {"step_s": ready_at - start}

    # ------------------------------------------------------- preemption
    @property
    def progress_lost(self) -> int:
        return max(0, self.step_count - self.last_saved_step)

    def suspend(self) -> Dict[str, float]:
        drained = self.drain()
        self.last_saved_step = self.step_count   # graceful synchronous save
        self.suspended = True
        return {"step": self.step_count, "drained_steps": len(drained)}

    def resume(self, grant, devices) -> int:
        assert self.suspended, "resume() is only legal after suspend()"
        self.suspended = False
        self._chain_free_at = 0.0
        return self.step_count

    def step(self) -> Dict[str, float]:
        """Synchronous step (old round-robin semantics)."""
        self.dispatch()
        return self.poll(block=True)[0]
