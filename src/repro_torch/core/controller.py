"""ClusterController — the paper's master node + administrator (the port
of ``repro.core.controller``; its chips are CUDA devices, each on a rank
under a process group).

Owns the chip inventory (Partitioner), the application workflow (Registry),
per-block runtimes, the Monitor, and the BlockScheduler.  One controller
process drives *all* blocks concurrently (the shared-master property the
paper's Fig. 3 measures); dispatch is event-driven with per-block in-flight
windows, and requests the pod cannot fit are waitlisted and auto-admitted
as capacity frees (``submit``/``tick``) instead of raising.

Fault tolerance: chip-failure injection marks chips unhealthy, fails the
owning block, re-carves a fresh sub-mesh from the free pool and restores the
block's state from its checkpoint namespace.  Elastic resize uses the same
re-carve + reshard-restore path.

Preemption: ``preempt`` suspends a running block (drain → synchronous
checkpoint → release chips under the partitioner lock) and re-enters it on
the waitlist ahead of its fair-share class; ``resume`` re-grants chips
(possibly a different set / geometry) and restores from the checkpoint.
``tick()`` drives auto-resume as capacity frees.  The scheduler invokes the
same pair automatically when a strictly-higher-priority waiter can't fit.

Tenancy policy: the scheduler consults a ``SchedulingPolicy`` for per-user
quotas, deadline-slack ordering and preferred-victim choice;
``submit_gang``/``grant_gang`` admit multi-block jobs atomically
(all-or-nothing) via ``Partitioner.allocate_many``.

Observability: every lifecycle transition and scheduling decision is
published on the controller's ``EventBus`` (``repro_torch.core.events``); the
``Monitor`` subscribes for its accounting and the web gateway's long-poll
feeds replay the same stream.  Callers outside ``repro_torch.core`` should go
through the ``ClusterDaemon`` service layer rather than constructing a
controller directly.

Under a process group (the paper's LIPI ran an MPI daemon per user; here
a block has process groups of its own) every rank runs this controller
as one program: the same calls, in the same order, with an explicit
``now=`` where a call takes one, so every rank's partitioner (a
deterministic copy of the reference's) reaches the same grants.  Each
chip belongs to a rank (``device.chips``), and blocks run at once on
disjoint subsets of the ranks.  A block's id, token and expiry are drawn
on rank 0 and broadcast at grant time.  Every rank builds every block's
mesh (``launch.mesh.make_block_mesh``: creating a group is a call every
rank makes, in the same order); the block's ranks build its
``BlockRuntime``, and every other rank an ``OffRankRuntime`` that holds
nothing of it and follows its step count and saves, so the registry,
the scheduler's loop and the event stream are the same on every rank.
A migration or resize rebuilds the block on its new ranks from the
checkpoint its old first rank names (``BlockRuntime.rebuild``); a
resume under a process group is such a rebuild.  A direct caller
across ranks gives every call that takes one a ``now`` (``tick``
without it raises there: each rank's wall clock is its own); the
daemon's background mode across ranks is ``core.service``'s
``ServiceDaemon``, whose leader on rank 0 orders every command, tick
and engine round into a log that every other rank replays, each entry
at the leader's ``now``.  A paged serve block's sessions are followed
on every rank (``OffRankRuntime``), so its generate surface answers
from any rank.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import runtime_check
from repro_torch.core import interference
from repro_torch.core.block import (Block, BlockGrant, BlockRequest, BlockState,
                              TRANSITIONS)
from repro_torch.core.events import EventBus
from repro_torch.core.monitor import Monitor
from repro_torch.core.partition import AllocationError, mesh_shape_for
from repro_torch.core.registry import Registry
from repro_torch.core.runtime import (BlockRuntime, JobSpec, OffRankRuntime,
                                      SimJobSpec, check_block)
from repro_torch.core.scheduler import BlockScheduler, SimRuntime
from repro_torch.core.topology import Coord, Topology
from repro_torch.device import (chips, cuda_devices, from_rank, is_writer,
                                rank, world_size)
from repro_torch.federation import (FederatedPartitioner, FederatedPlacer,
                              HealthMonitor, PodRegistry)
from repro_torch.federation.pods import POD_DEAD, POD_READY, to_local
from repro_torch.obs.flight import RECORDER
from repro_torch.obs.trace import TRACER
from repro_torch.train import compile_cache

# lifecycle states that hold chips (a PREEMPTED block holds nothing)
_HOLDING = (BlockState.APPROVED, BlockState.CONFIRMED, BlockState.ACTIVE,
            BlockState.RUNNING, BlockState.DONE)


class ClusterController:
    def __init__(self, topo: Topology, devices: Optional[Sequence] = None,
                 ckpt_root: str = "artifacts/ckpt",
                 state_path: Optional[str] = None,
                 bus: Optional[EventBus] = None,
                 placer: Optional[FederatedPlacer] = None):
        self.topo = topo
        self.devices = chips(list(devices) if devices is not None
                             else cuda_devices())
        if len(self.devices) < topo.n_chips:
            raise ValueError(
                f"topology needs {topo.n_chips} devices, have "
                f"{len(self.devices)} (one chip per CUDA device, or per "
                f"rank under a process group; pass devices= to map "
                f"several chips onto one device)")
        # the event bus is the observable spine: the registry publishes
        # every lifecycle transition, scheduler/controller publish the
        # scheduling decisions, and the Monitor subscribes instead of
        # being called directly
        self.bus = bus or EventBus()
        self.monitor = Monitor()
        self.monitor.subscribe_to(self.bus)
        # compile-cache hit/miss events flow onto this controller's bus
        # (process-wide cache: reuse spans every block the host runs)
        compile_cache.GLOBAL.set_bus(self.bus)
        # the boot topology is carved into one federation pod per paper pod
        # (pod p owns the matching contiguous device slice, preserving the
        # pre-federation chip_index device mapping); more pods attach and
        # detach at runtime via attach_pod/detach_pod
        self.pods = PodRegistry(bus=self.bus)
        pod_chips = topo.pod_x * topo.pod_y
        for p in range(topo.n_pods):
            self.pods.attach(
                topo.pod_x, topo.pod_y,
                self.devices[p * pod_chips:(p + 1) * pod_chips],
                name=f"boot{p}", boot=True, pod_id=p)
        self.placer = placer or FederatedPlacer()
        self.partitioner = FederatedPartitioner(self.pods, self.placer)
        self.health = HealthMonitor(self.pods)
        # one state file for the whole control plane: world rank 0's
        self.registry = Registry(
            state_path=state_path if is_writer() else None, bus=self.bus)
        # re-attach runtime pods recorded in the registry snapshot (their
        # devices are not persistable — they come back as sim pods on the
        # host's first device, the same replication the CI smokes use)
        for entry in self.registry.pods_snapshot():
            pid = int(entry["pod_id"])
            if (entry.get("boot") or entry.get("phase") == POD_DEAD
                    or self.pods.get(pid) is not None):
                continue
            px, py = int(entry["pod_x"]), int(entry["pod_y"])
            self.pods.attach(px, py, [self.devices[0]] * (px * py),
                             name=entry.get("name"), pod_id=pid,
                             power_budget_chips=entry.get(
                                 "power_budget_chips"))
            phase = entry.get("phase", POD_READY)
            if phase != POD_READY:        # draining/degraded survives reboot
                self.pods.set_phase(pid, phase)
        self.runtimes: Dict[str, BlockRuntime] = {}   # app_id -> runtime
        self.ckpt_root = ckpt_root
        self.scheduler = BlockScheduler(self)
        # installed by the ClusterDaemon: the autostep engine, consulted so
        # a preemption harvests (publishes) an engine-driven victim's
        # in-flight completions instead of silently discarding them
        self.engine = None

    # -------------------------------------------------- device mapping
    def devices_for(self, coords: Sequence[Coord]) -> List:
        out = []
        for c in coords:
            pod = self.pods.pod(c[0])
            out.append(pod.devices[pod.topo.chip_index((0, c[1], c[2]))])
        return out

    def _new_grant(self, coords, mesh_shape, duration_s) -> BlockGrant:
        """A fresh grant, its id, token and expiry rank 0's on every rank
        (every rank grants in the same order); the ranks' chips must
        agree, or they have diverged."""
        grant = BlockGrant.new(coords, mesh_shape, duration_s)
        if world_size() == 1:
            return grant
        agreed = from_rank(0, grant)
        if agreed.coords != grant.coords:
            raise RuntimeError(
                f"the ranks' control planes diverged: rank 0 granted "
                f"{agreed.coords}, rank {rank()} {grant.coords}")
        return agreed

    def _runtime(self, grant: BlockGrant, job) -> "BlockRuntime":
        """The block's runtime on this rank: a ``BlockRuntime`` on its own
        ranks (every rank without a process group), an ``OffRankRuntime``
        elsewhere; each enters the block's mesh creation."""
        devices = self.devices_for(grant.coords)
        return self._runtime_class(grant, devices)(
            grant, job, devices, self.ckpt_root)

    def _runtime_class(self, grant, devices):
        ranks = check_block(grant, devices)
        return (BlockRuntime if ranks is None or rank() in ranks
                else OffRankRuntime)

    def _rebuild(self, old, grant: BlockGrant):
        """The block rebuilt on ``grant`` (``BlockRuntime.rebuild``): on
        this rank a runtime or a stand-in, as the new grant's ranks say."""
        devices = self.devices_for(grant.coords)
        return self._runtime_class(grant, devices).rebuild(
            old, grant, devices, self.ckpt_root)

    def total_chips(self) -> int:
        """Federation-wide capacity (live pods only)."""
        return self.pods.total_chips()

    # -------------------------------------------------- workflow (Fig. 2)
    def register(self, user: str, job_description: str, n_chips: int,
                 arch: str = "", shape: str = "train_4k",
                 duration_s: float = 3600.0, priority: int = 0,
                 deadline_s: Optional[float] = None,
                 est_steps: Optional[int] = None) -> str:
        return self.registry.register(BlockRequest(
            user=user, job_description=job_description, n_chips=n_chips,
            arch=arch, shape=shape, duration_s=duration_s,
            priority=priority, deadline_s=deadline_s, est_steps=est_steps))

    def submit(self, user: str, job_description: str, n_chips: int,
               job: Optional[JobSpec] = None, priority: int = 0,
               pod: Optional[int] = None, now: Optional[float] = None,
               **register_kw):
        """Automated admission (no admin in the loop): register and either
        admit now or waitlist until capacity frees.  Returns
        ``(app_id, grant-or-None)``; with a ``job`` the block is activated
        and run the moment it is admitted.  ``now`` keeps deadline/wait
        accounting on the model clock under a simulated-clock driver."""
        app_id = self.register(user, job_description, n_chips,
                               priority=priority, **register_kw)
        grant = self.scheduler.submit(app_id, job=job, pod=pod, now=now)
        return app_id, grant

    def submit_gang(self, user: str, members: Sequence[Tuple],
                    priority: int = 0, pod: Optional[int] = None,
                    deadline_s: Optional[float] = None,
                    now: Optional[float] = None, **register_kw):
        """Atomic multi-block submission (paper follow-up arXiv:0708.3446:
        jobs spanning several blocks at once).  ``members`` is a sequence of
        ``(job_description, n_chips)`` or ``(job_description, n_chips,
        JobSpec-or-None)`` tuples.  Every member is admitted together — all
        co-start — or the whole gang is waitlisted as one unit.  Returns
        ``(app_ids, {app_id: grant} or None)``."""
        app_ids: List[str] = []
        jobs: Dict[str, JobSpec] = {}
        for member in members:
            desc, n_chips = member[0], member[1]
            job = member[2] if len(member) > 2 else None
            app_id = self.register(user, desc, n_chips, priority=priority,
                                   deadline_s=deadline_s, **register_kw)
            app_ids.append(app_id)
            if job is not None:
                jobs[app_id] = job
        grants = self.scheduler.submit_gang(app_ids, jobs=jobs, pod=pod,
                                            now=now)
        return app_ids, grants

    def grant_block(self, app_id: str, n_chips: int,
                    pod: Optional[int] = None) -> BlockGrant:
        """Grant finalization (shared by admin review and scheduler
        admission): allocate under a pending reservation, mint the grant,
        re-tag the chips to the real block id atomically — a concurrent
        allocate must never observe them as free mid-retag — and approve.
        Raises AllocationError (leaving no chips held) when nothing fits."""
        blk = self.registry.get(app_id)
        tmp_grant_id = f"pending_{app_id}"
        coords = self.partitioner.allocate(n_chips, tmp_grant_id, pod=pod)
        grant = self._new_grant(coords, mesh_shape_for(n_chips),
                                blk.request.duration_s)
        self.partitioner.retag(tmp_grant_id, grant.block_id)
        try:
            self.registry.approve(app_id, grant)
        except Exception:
            # e.g. illegal transition (review of an already-approved app):
            # give the chips back instead of leaking them under an orphan id
            self.partitioner.release(grant.block_id)
            raise
        return grant

    def grant_gang(self, app_ids: Sequence[str]) -> Dict[str, BlockGrant]:
        """Gang grant finalization: every member's rectangle is found under
        ONE partitioner lock hold (``allocate_many``) and rolled back on
        partial failure, so either every member gets a grant or the
        inventory is bit-identical to before the call.  Member states are
        validated up front so the post-allocation approve loop cannot fail
        halfway through."""
        for app_id in app_ids:
            blk = self.registry.get(app_id)
            if BlockState.APPROVED not in TRANSITIONS.get(blk.state, set()):
                raise ValueError(
                    f"gang member {app_id} in state {blk.state.value} "
                    f"cannot be approved")
        specs = [(self.registry.get(a).request.n_chips, f"pending_{a}",
                  self.registry.get(a).request.pod) for a in app_ids]
        alloc = self.partitioner.allocate_many(specs)
        grants: Dict[str, BlockGrant] = {}
        try:
            for app_id in app_ids:
                blk = self.registry.get(app_id)
                coords = alloc[f"pending_{app_id}"]
                grant = self._new_grant(coords, mesh_shape_for(len(coords)),
                                        blk.request.duration_s)
                self.partitioner.retag(f"pending_{app_id}", grant.block_id)
                try:
                    self.registry.approve(app_id, grant)
                except Exception:
                    self.partitioner.release(grant.block_id)
                    raise
                grants[app_id] = grant
        except Exception:
            # all-or-nothing extends to grant finalization: an approve that
            # raises mid-loop (e.g. registry persist I/O error) must not
            # leave earlier members holding chips or later members' pending
            # reservations leaked.  Denies are best-effort (the registry's
            # persist may be the very thing failing); chip release is what
            # must never be skipped.
            for a in app_ids:
                self.partitioner.release(f"pending_{a}")
            for a, g in grants.items():
                self.partitioner.release(g.block_id)
            for a in app_ids:
                blk = self.registry.get(a)
                # includes the member whose approve raised *after* its
                # APPROVED transition: it must not stay APPROVED holding a
                # grant whose chips were just released
                if a in grants or blk.state == BlockState.APPROVED:
                    try:
                        self.registry.deny(a, "gang grant finalization failed")
                    except Exception:
                        pass
            raise
        return grants

    def review(self, app_id: str, *, approve: bool = True,
               pod: Optional[int] = None, n_chips: Optional[int] = None) -> Optional[BlockGrant]:
        """Admin review: assign a contiguous block (possibly a different size
        than requested — the admin has full control, paper §3)."""
        blk = self.registry.get(app_id)
        if not approve:
            self.registry.deny(app_id, "admin denied")
            return None
        return self.grant_block(app_id, n_chips or blk.request.n_chips,
                                pod=pod)

    def confirm(self, app_id: str, token: str) -> None:
        self.registry.confirm(app_id, token)

    def activate(self, app_id: str, job):
        """Power on the block's chips and boot its runtime (paper: switch
        nodes on + activate the user's MPD daemons).  A ``SimJobSpec``
        boots the device-free wall-clock simulator instead of a real
        runtime — the gateway's sim jobs and scheduler benchmarks drive
        the identical lifecycle without a device."""
        blk = self.registry.get(app_id)
        assert blk.grant is not None
        with TRACER.span("ctl.activate", cat="ctl", app_id=app_id,
                         user=blk.request.user):
            if isinstance(job, SimJobSpec):
                rt = SimRuntime(job.step_s, ckpt_every=job.ckpt_every)
            else:
                rt = self._runtime(blk.grant, job)
                rt.init_state()
                self._follow_checkpoints(rt)
                self._attach_roofline(blk, rt)
            self.runtimes[app_id] = rt
            self.registry.set_state(app_id, BlockState.ACTIVE,
                                    "runtime built")
            return rt

    @staticmethod
    def _follow_checkpoints(rt) -> None:
        """A stand-in learns the checkpoints a block starts with (a stable
        namespace may hold earlier runs') from the block's first rank."""
        if rt.ranks is None or world_size() == 1:
            return
        latest = from_rank(rt.ranks[0], rt._manager().latest_step()
                           if rt.ckpt is not None else None)
        if isinstance(rt, OffRankRuntime) and latest is not None:
            rt.ckpt.saved(latest)

    def _attach_roofline(self, blk, rt) -> None:
        """Give the Monitor this block's roofline model (useful FLOPs per
        step + modeled step-time floor) so its step-time EWMA reads back as
        achieved-vs-peak utilization.  Re-run on every rebuild: a resume on
        fewer chips changes the denominator."""
        job = getattr(rt, "job", None)
        if job is None or blk.block_id is None:
            return
        try:
            from repro_torch.launch import hlo_analysis
            self.monitor.set_roofline(
                blk.block_id,
                hlo_analysis.block_roofline(job.cfg, job.shape,
                                            len(blk.grant.coords)))
        except Exception:
            pass    # monitoring garnish: never block activation on it

    def run(self, app_id: str) -> None:
        self.registry.set_state(app_id, BlockState.RUNNING, "job started")

    def download(self, app_id: str) -> Dict:
        """Step (7): the user collects results (metrics + checkpoint path)."""
        blk = self.registry.get(app_id)
        rt = self.runtimes.get(app_id)
        stats = self.monitor.stats.get(blk.block_id or "", None)
        if blk.state == BlockState.RUNNING:
            self.registry.set_state(app_id, BlockState.DONE, "results ready")
        ckpt = getattr(rt, "ckpt", None)      # SimRuntime has no manager
        return {
            "steps": rt.step_count if rt else 0,
            "metrics": stats.last_metrics if stats else {},
            "checkpoints": ckpt.steps() if ckpt else [],
            "checkpoint_dir": ckpt.dir if ckpt else None,
        }

    def expire(self, app_id: str, now: Optional[float] = None) -> None:
        """Usage period over: shut nodes down, free the block, and admit
        whatever the freed capacity now fits from the waitlist.  (A block
        whose period ends while PREEMPTED holds no chips — it simply never
        resumes.)  The runtime is drained *before* its chips are released:
        async dispatches could otherwise still be executing on chips the
        next ``pump()`` hands to another block.  ``now`` (model time under
        a simulated clock) flows through to the pump's wait accounting."""
        blk = self.registry.get(app_id)
        self._end(self.runtimes.pop(app_id, None))
        if blk.grant:
            self.partitioner.release(blk.grant.block_id)
        self.registry.set_state(app_id, BlockState.EXPIRED, "period over")
        self.scheduler.pump(now)

    @staticmethod
    def _end(rt) -> None:
        """A block's runtime leaves the controller: its in-flight steps
        drained, its groups back to the pool (every rank, as every rank
        builds them)."""
        for name in ("drain", "release_groups"):
            fn = getattr(rt, name, None)
            if fn is not None:
                fn()

    # ------------------------------------------------------- preemption
    def preempt(self, app_id: str, reason: str = "admin preempt",
                now: Optional[float] = None) -> None:
        """Evict a running/active block: drain its in-flight dispatches,
        checkpoint synchronously (suspend), release its chips — the
        partitioner's lock makes the release atomic w.r.t. concurrent
        allocates — and park it on the waitlist (PREEMPTED) ahead of its
        fair-share class for auto-resume."""
        blk = self.registry.get(app_id)
        # validate before any irreversible step: suspend/release must not
        # run if the PREEMPTED transition would be rejected afterwards
        if blk.state not in (BlockState.RUNNING, BlockState.ACTIVE):
            raise ValueError(
                f"cannot preempt {app_id} in state {blk.state.value}")
        assert blk.grant is not None, f"{app_id} holds no grant"
        with TRACER.span("ctl.preempt", cat="ctl", app_id=app_id,
                         user=blk.request.user, reason=reason):
            self._preempt_body(app_id, blk, reason, now)

    def _preempt_body(self, app_id: str, blk, reason: str,
                      now: Optional[float]) -> None:
        rt = self.runtimes.get(app_id)
        if self.engine is not None:
            # engine-driven victims: publish the in-flight completions as
            # step events before the suspend discards them (the drive
            # stays armed and re-arms itself when the block resumes)
            self.engine.drain_block(app_id, now=now)
        # progress measured *before* the suspend-save: what a non-graceful
        # kill would have lost, and what victim selection minimized
        progress_lost = int(getattr(rt, "progress_lost", 0) or 0)
        info = rt.suspend() if rt is not None else {}
        self.partitioner.release(blk.grant.block_id)
        seq = self.registry.mark_preempted(
            app_id, reason, progress_lost_steps=progress_lost,
            checkpoint_step=(int(info["step"]) if info else None),
            now=now)
        self.bus.publish("preempted", app_id=app_id, block_id=blk.block_id,
                         user=blk.request.user, now=now, reason=reason,
                         progress_lost_steps=progress_lost,
                         checkpoint_step=(int(info["step"]) if info
                                          else None))
        self.scheduler.requeue_preempted(app_id, seq)

    def resume(self, app_id: str,
               n_chips: Optional[int] = None) -> BlockGrant:
        """Re-admit a PREEMPTED block: carve a fresh sub-mesh (possibly
        different chips; pass ``n_chips`` to resume on a different
        geometry), rebuild the runtime there and restore from the
        checkpoint.  Keeps the block's identity, token and expiry.  Raises
        AllocationError — holding nothing — when the pod can't fit it yet
        (the scheduler then keeps it queued)."""
        blk = self.registry.get(app_id)
        assert blk.state == BlockState.PREEMPTED, (app_id, blk.state)
        assert blk.grant is not None
        with TRACER.span("ctl.resume", cat="ctl", app_id=app_id,
                         user=blk.request.user):
            return self._resume_body(app_id, blk, n_chips)

    def _resume_body(self, app_id: str, blk,
                     n_chips: Optional[int]) -> BlockGrant:
        old = blk.grant
        old_pod = old.coords[0][0] if old.coords else None
        n = n_chips or old.n_chips
        coords = self.partitioner.allocate(n, old.block_id,
                                           pod=blk.request.pod)
        new_grant = BlockGrant(block_id=old.block_id, coords=coords,
                               mesh_shape=mesh_shape_for(n),
                               token=old.token, expires_at=old.expires_at)
        rt = self.runtimes.get(app_id)
        if rt is not None:
            try:
                if getattr(rt, "ranks", None) is not None:
                    # under a process group the block may come back on
                    # other ranks, where it is another class of runtime
                    # (a BlockRuntime or a stand-in): rebuilt there from
                    # its suspend's save.  Without one it resumes in
                    # place, the reference's contract: a caller holding
                    # the runtime across the preemption sees it resumed
                    rt = self.runtimes[app_id] = self._rebuild(rt, new_grant)
                else:
                    rt.resume(new_grant, self.devices_for(coords))
            except Exception:
                self.partitioner.release(old.block_id)
                raise
        blk.grant = new_grant
        if rt is not None:
            self._attach_roofline(blk, rt)   # chip count may have changed
        self.registry.set_state(
            app_id, BlockState.ACTIVE,
            f"resumed on {n} chips at step "
            f"{rt.step_count if rt is not None else 0}")
        # return to the pre-preemption lifecycle position: a block that was
        # only ACTIVE (user never started the job) must not come back RUNNING
        if blk.preemptions and blk.preemptions[-1].get("from_state") == \
                BlockState.RUNNING.value:
            self.registry.set_state(app_id, BlockState.RUNNING, "resumed")
        self.bus.publish("resumed", app_id=app_id,
                         block_id=new_grant.block_id, user=blk.request.user,
                         n_chips=n,
                         step=(rt.step_count if rt is not None else 0))
        if old_pod is not None and coords and coords[0][0] != old_pod:
            # cross-pod resume: the block migrated toward other capacity
            self.bus.publish("migrated", app_id=app_id,
                             block_id=new_grant.block_id,
                             user=blk.request.user, from_pod=old_pod,
                             to_pod=coords[0][0], n_chips=n)
        return new_grant

    @runtime_check.guard_serialized("control-plane")
    def tick(self, now: Optional[float] = None) -> List[str]:
        """Periodic housekeeping: auto-expire blocks past their period,
        advance pod health (evicting residents of newly dead pods), admit
        from the waitlist (including auto-resume of preempted blocks),
        sample federation utilization."""
        if now is None and world_size() > 1:
            raise NotImplementedError(
                "tick() without now= under a process group of several "
                "ranks would read each rank's own clock: every rank ticks "
                "at the same time, so pass now=, or run the daemon's "
                "background mode through core.service.ServiceDaemon, "
                "whose leader gives every tick its now")
        expired = self.registry.expired(now)
        for app_id in expired:
            self.expire(app_id, now=now)
        for pod_id in self.health.check(now):
            self.fail_pod(pod_id, reason="missed heartbeats", now=now)
        # sample_util: the pump publishes the utilization sample from the
        # held-chips snapshot it already computes per round — no second
        # inventory scan here (one sample per tick, as before)
        self.scheduler.pump(now, sample_util=True)
        return expired

    # ---------------------------------------------------------- federation
    def attach_pod(self, pod_x: int, pod_y: int, name: Optional[str] = None,
                   devices: Optional[Sequence] = None,
                   power_budget_chips: Optional[float] = None,
                   now: Optional[float] = None) -> Dict:
        """Attach capacity at runtime.  The pump runs immediately after, so
        QUEUED and PREEMPTED blocks migrate toward the new pod without the
        daemon restarting.  Without explicit ``devices`` the pod replicates
        the host's first device (a sim pod — the CI dashboard idiom)."""
        n = pod_x * pod_y
        pod = self.pods.attach(
            pod_x, pod_y,
            chips(devices) if devices is not None else [self.devices[0]] * n,
            name=name, power_budget_chips=power_budget_chips, now=now)
        self.registry.store_pods(self.pods.snapshot())
        self.scheduler.pump(now)
        return pod.describe()

    def drain_pod(self, pod_id: int, now: Optional[float] = None) -> Dict:
        """Stop placing new blocks on the pod; residents keep running."""
        pod = self.pods.set_phase(pod_id, "draining", now=now)
        self.registry.store_pods(self.pods.snapshot())
        return pod.describe()

    def detach_pod(self, pod_id: int, force: bool = False,
                   now: Optional[float] = None) -> Dict:
        """Remove a pod.  Refuses while blocks are resident unless
        ``force``, which evicts them first (preempt + migrate, the same
        path a pod death takes — graceful, so nothing is lost)."""
        pod = self.pods.pod(pod_id)            # KeyError -> unknown pod
        residents = self.pod_residents(pod_id)
        if residents and not force:
            raise ValueError(
                f"pod {pod_id} has {len(residents)} resident block(s); "
                f"drain first or detach with force")
        if residents:
            # drain before evicting: a READY pod would satisfy the
            # migration's resize *in place* and the residents would never
            # leave the pod being removed
            self.pods.set_phase(pod_id, "draining", now=now)
            self._evict_pod_residents(pod_id, f"pod {pod.name} detached",
                                      now=now)
        self.pods.detach(pod_id, now=now)
        self.registry.store_pods(self.pods.snapshot())
        self.scheduler.pump(now)
        return pod.describe()

    def fail_pod(self, pod_id: int, reason: str = "pod died",
                 now: Optional[float] = None) -> List[str]:
        """A pod (and every chip in it) is gone: mark it dead, evict every
        resident block into PREEMPTED via its checkpoint, and migrate them
        toward surviving capacity.  Returns the evicted app ids."""
        self.pods.set_phase(pod_id, POD_DEAD, now=now)
        self.registry.store_pods(self.pods.snapshot())
        victims = self._evict_pod_residents(pod_id, reason, now=now)
        # postmortem after the eviction sweep: the victims' final
        # preempted/state events and spans are in the recorder's ring by
        # now, so the artifact captures each one's last moments
        RECORDER.dump("pod_death", apps=victims, now=now,
                      detail={"pod": pod_id, "reason": reason})
        self.scheduler.pump(now)
        return victims

    def pod_heartbeat(self, pod_id: int,
                      now: Optional[float] = None) -> Dict:
        """Health heartbeat from a pod agent; first beat arms monitoring."""
        return self.health.beat(pod_id, now=now).describe()

    def pod_residents(self, pod_id: int) -> List[str]:
        """App ids currently holding chips on this pod."""
        out = []
        for app_id in self.registry.by_state(*_HOLDING):
            blk = self.registry.get(app_id)
            if (blk.grant is not None and blk.grant.coords
                    and blk.grant.coords[0][0] == pod_id):
                out.append(app_id)
        return out

    def _evict_pod_residents(self, pod_id: int, reason: str,
                             now: Optional[float] = None) -> List[str]:
        """Clear every resident block off a pod, leaking nothing: executing
        blocks preempt (checkpoint, release, requeue ahead of class);
        non-executing holders migrate their grant to another pod, or
        terminate cleanly when nothing fits anywhere."""
        victims = []
        for app_id in self.pod_residents(pod_id):
            blk = self.registry.get(app_id)
            victims.append(app_id)
            if blk.state in (BlockState.ACTIVE, BlockState.RUNNING):
                self.preempt(app_id, reason=reason, now=now)
                continue
            # APPROVED/CONFIRMED/DONE: chips but no executing job — same
            # handling as a chip failure before activation
            try:
                coords = self.partitioner.resize(blk.grant.block_id,
                                                 blk.grant.n_chips)
                blk.grant = BlockGrant(block_id=blk.grant.block_id,
                                       coords=coords,
                                       mesh_shape=blk.grant.mesh_shape,
                                       token=blk.grant.token,
                                       expires_at=blk.grant.expires_at)
                old_rt = self.runtimes.get(app_id)
                if old_rt is not None:
                    self.runtimes[app_id] = self._rebuild(old_rt, blk.grant)
                self.registry.persist()
                self.bus.publish("migrated", app_id=app_id,
                                 block_id=blk.block_id,
                                 user=blk.request.user, now=now,
                                 from_pod=pod_id, to_pod=coords[0][0],
                                 n_chips=len(coords))
            except AllocationError:
                self._end(self.runtimes.pop(app_id, None))
                self.partitioner.release(blk.grant.block_id)
                self.registry.set_state(
                    app_id, BlockState.EXPIRED,
                    f"{reason}; no replacement rectangle free — resubmit")
        return victims

    # ------------------------------------------------ concurrent execution
    def step_all(self, rounds: int = 1, sync_every: int = 1) -> Dict[str, List[Dict]]:
        """Step every RUNNING block ``rounds`` times, event-driven.

        Delegates to the BlockScheduler's dispatch loop: completions are
        harvested in device-finish order with per-block in-flight windows
        (``sync_every`` = dispatch depth), so a slow block no longer stalls
        fast blocks on the host thread the way the old fixed-order
        round-robin ``block_until_ready`` did.
        """
        return self.scheduler.run_dispatch(
            rounds, max_inflight=max(1, sync_every))

    # ------------------------------------------------------ fault handling
    def inject_chip_failure(self, coord: Coord,
                            now: Optional[float] = None) -> Optional[str]:
        """Simulate a chip failure.  Returns the app_id that was failed over
        (recovered now, or requeued for deferred recovery), if any block
        owned the chip."""
        block_id = self.partitioner.mark_unhealthy(coord)
        if block_id is None:
            return None
        app_id = self.registry.by_block_id(block_id)
        if app_id is None:
            return None
        blk = self.registry.get(app_id)
        pre_failure_state = blk.state
        blk.failure_reason = f"chip {coord} failed"
        if pre_failure_state in (BlockState.ACTIVE, BlockState.RUNNING):
            self.registry.set_state(app_id, BlockState.FAILED, str(coord))
            self.recover_block(app_id, from_state=pre_failure_state.value,
                               now=now)
            return app_id
        # non-executing holder (APPROVED/CONFIRMED own chips from grant
        # time but have no runtime; a DONE block keeps one for result
        # download) — FAILED is not even a legal transition here.  Re-carve
        # the grant in place; when nothing healthy fits, terminate the
        # grant cleanly instead of leaving the block stranded on a dead
        # chip.
        try:
            coords = self.partitioner.resize(block_id, blk.grant.n_chips,
                                             pod=blk.request.pod)
            blk.grant = BlockGrant(block_id=block_id, coords=coords,
                                   mesh_shape=blk.grant.mesh_shape,
                                   token=blk.grant.token,
                                   expires_at=blk.grant.expires_at)
            old_rt = self.runtimes.get(app_id)
            if old_rt is not None:
                # a DONE block's runtime must follow its grant onto the new
                # chips — DONE -> RUNNING is legal, so a stale device set
                # would execute on the dead chip if the job were restarted
                self.runtimes[app_id] = self._rebuild(old_rt, blk.grant)
            self.registry.persist()
        except AllocationError:
            self._end(self.runtimes.pop(app_id, None))
            self.partitioner.release(block_id)
            self.registry.set_state(
                app_id, BlockState.EXPIRED,
                f"chip {coord} failed before activation, no replacement "
                f"rectangle free — resubmit")
            self.scheduler.pump(now)
        return app_id

    def recover_block(self, app_id: str,
                      from_state: Optional[str] = None,
                      now: Optional[float] = None
                      ) -> Optional[BlockRuntime]:
        """Re-carve a healthy sub-mesh and restore from checkpoint.

        The replacement rectangle is found with the block's own (healthy)
        chips treated as free, under one partitioner lock hold
        (``Partitioner.resize`` at the same size) — the old
        release-before-allocate sequence opened a window where a concurrent
        ``submit()``/``pump()`` could steal the freed chips and recovery
        died with AllocationError, leaving the block FAILED holding nothing
        and never requeued.  When no healthy rectangle exists *right now*,
        the block is checkpointed and requeued (PREEMPTED) for auto-resume
        once capacity frees, and None is returned.  ``from_state`` is the
        pre-*failure* lifecycle state (so a deferred auto-resume returns an
        ACTIVE block to ACTIVE, not RUNNING)."""
        blk = self.registry.get(app_id)
        old_rt = self.runtimes.get(app_id)
        assert blk.grant is not None and old_rt is not None
        try:
            coords = self.partitioner.resize(blk.grant.block_id,
                                             blk.grant.n_chips,
                                             pod=blk.request.pod)
        except AllocationError:
            # deferred recovery: suspend (drain -> sync checkpoint -> drop
            # device refs), free the remains, park for auto-resume — the
            # pre-failure position was RUNNING, so resume returns it there
            progress_lost = int(getattr(old_rt, "progress_lost", 0) or 0)
            info = old_rt.suspend()
            self.partitioner.release(blk.grant.block_id)
            seq = self.registry.mark_preempted(
                app_id, "recovery deferred: no healthy rectangle free",
                progress_lost_steps=progress_lost,
                checkpoint_step=(int(info["step"]) if info else None),
                from_state=from_state or BlockState.RUNNING.value,
                now=now)
            self.bus.publish("preempted", app_id=app_id,
                             block_id=blk.block_id, user=blk.request.user,
                             now=now,
                             reason="recovery deferred: no healthy "
                                    "rectangle free",
                             progress_lost_steps=progress_lost,
                             checkpoint_step=(int(info["step"]) if info
                                              else None))
            self.scheduler.requeue_preempted(app_id, seq)
            return None
        new_grant = BlockGrant(block_id=blk.grant.block_id, coords=coords,
                               mesh_shape=blk.grant.mesh_shape,
                               token=blk.grant.token,
                               expires_at=blk.grant.expires_at)
        blk.grant = new_grant
        rt = self._rebuild(old_rt, new_grant)
        self.runtimes[app_id] = rt
        self.registry.set_state(app_id, BlockState.ACTIVE, "recovered")
        # return to the pre-failure lifecycle position: an ACTIVE block
        # whose job was never started must not come back RUNNING
        if from_state is None or from_state == BlockState.RUNNING.value:
            self.registry.set_state(app_id, BlockState.RUNNING, "resumed")
        return rt

    def resize_block(self, app_id: str, new_n_chips: int,
                     now: Optional[float] = None) -> BlockRuntime:
        """Elastic scaling: grow/shrink a running block; state is resharded
        onto the new sub-mesh via checkpoint restore.  ``now`` is the
        admission pump's clock afterwards (its wait and slack order), as
        ``expire``'s."""
        blk = self.registry.get(app_id)
        old_rt = self.runtimes[app_id]
        old_rt.save(async_=False)
        coords = self.partitioner.resize(blk.grant.block_id, new_n_chips)
        new_grant = BlockGrant(block_id=blk.grant.block_id, coords=coords,
                               mesh_shape=mesh_shape_for(new_n_chips),
                               token=blk.grant.token,
                               expires_at=blk.grant.expires_at)
        blk.grant = new_grant
        rt = self._rebuild(old_rt, new_grant)
        self.runtimes[app_id] = rt
        self._attach_roofline(blk, rt)       # new chip-count denominator
        self.scheduler.pump(now)   # a shrink may free room for queued blocks
        return rt

    # ------------------------------------------------------- interference
    def interference_report(self) -> interference.InterferenceReport:
        """Link contention among executing blocks, analyzed per pod in each
        pod's own geometry (blocks in different pods share zero fabric by
        construction — only the abstract DCN — so cross-pod pairs are
        recorded as zero shared links)."""
        by_pod: Dict[int, Dict[str, List[Coord]]] = {}
        for app_id in self.registry.by_state(BlockState.ACTIVE,
                                             BlockState.RUNNING):
            blk = self.registry.get(app_id)
            pid = blk.grant.coords[0][0]
            by_pod.setdefault(pid, {})[blk.block_id] = to_local(
                blk.grant.coords)
        block_links: Dict[str, int] = {}
        shared: Dict[Tuple[str, str], int] = {}
        slowdown: Dict[str, float] = {}
        for pid, blocks in sorted(by_pod.items()):
            pod = self.pods.get(pid)
            if pod is None:
                continue
            rep = interference.analyze_blocks(pod.topo, blocks)
            block_links.update(rep.block_links)
            shared.update(rep.shared_links)
            slowdown.update(rep.slowdown)
        ids = sorted(block_links)
        for i in range(len(ids)):
            for j in range(i + 1, len(ids)):
                shared.setdefault((ids[i], ids[j]), 0)
        return interference.InterferenceReport(
            block_links=block_links, shared_links=shared, slowdown=slowdown)
