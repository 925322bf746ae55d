"""User/application registry — the paper's web-workflow state (Fig. 2),
persisted as JSON so an external UI/CLI can observe it.

Steps (paper §3): (1) register -> (2) admin review+assign -> (3) user
reconfirm -> (4) adjust program -> (5) upload+run -> (6) monitor ->
(7) download; auto-shutdown at period end.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

from repro_torch.core.block import Block, BlockGrant, BlockRequest, BlockState

# process umask, read once at import: os.umask(0)/os.umask(x) probing on
# every persist would leave a window where concurrent writers (e.g. the
# checkpoint manager's background thread) create world-writable files
_UMASK = os.umask(0)
os.umask(_UMASK)


class Registry:
    def __init__(self, state_path: Optional[str] = None, bus=None):
        self._lock = threading.RLock()
        self.apps: Dict[str, Block] = {}
        self._next_id = 1
        self._queue_seq = 0
        self._queue_order: Dict[str, int] = {}   # app_id -> enqueue sequence
        self.state_path = state_path
        self.bus = bus           # EventBus: every transition becomes a
                                 # kind="state" event for the live feed
        # gateway session state (profiles + event-feed cursors), persisted
        # inside the registry snapshot under the reserved "_sessions" key
        # so a restarted gateway rehydrates the paper's per-user
        # configuration instead of forgetting every session
        self._sessions: Dict = {}
        # federation pod directory, persisted under the reserved "_pods"
        # key so a restarted daemon re-attaches runtime pods (devices are
        # rebuilt on attach — only the directory state round-trips)
        self._pods: List = []
        if state_path and os.path.exists(state_path):
            try:
                with open(state_path) as f:
                    snap = json.load(f)
                self._sessions = snap.get("_sessions", {}) or {}
                self._pods = snap.get("_pods", []) or []
            except (OSError, ValueError):
                pass     # a corrupt snapshot must not block daemon boot

    # ------------------------------------------------------------- sessions
    def session_snapshot(self) -> Dict:
        """Deep copy of the stored gateway session state."""
        with self._lock:
            return json.loads(json.dumps(self._sessions, default=str))

    def store_sessions(self, sessions: Dict) -> None:
        """Replace the gateway session state and persist it with the next
        registry snapshot write."""
        with self._lock:
            self._sessions = dict(sessions)
            self._persist()

    # ----------------------------------------------------------------- pods
    def pods_snapshot(self) -> List:
        """Deep copy of the stored federation pod directory."""
        with self._lock:
            return json.loads(json.dumps(self._pods, default=str))

    def store_pods(self, pods: List) -> None:
        """Replace the federation pod directory and persist it with the
        next registry snapshot write."""
        with self._lock:
            self._pods = list(pods)
            self._persist()

    def _emit(self, app_id: str, note: str = "",
              now: Optional[float] = None) -> None:
        """Publish the block's (new) lifecycle state on the event bus —
        the per-block feed must show *every* transition, including ones no
        scheduling decision accompanies (confirm, run, done...)."""
        if self.bus is None:
            return
        blk = self.apps[app_id]
        self.bus.publish("state", app_id=app_id, block_id=blk.block_id,
                         user=blk.request.user, now=now,
                         state=blk.state.value, note=note)

    # ------------------------------------------------------------ workflow
    def register(self, request: BlockRequest) -> str:
        with self._lock:
            app_id = f"app_{self._next_id:04d}"
            self._next_id += 1
            self.apps[app_id] = Block(request=request)
            self.apps[app_id].history.append(
                (time.time(), f"registered by {request.user}"))
            self._persist()
            if self.bus is not None:
                self.bus.publish("registered", app_id=app_id,
                                 user=request.user,
                                 n_chips=request.n_chips,
                                 job=request.job_description)
            return app_id

    def approve(self, app_id: str, grant: BlockGrant) -> None:
        with self._lock:
            blk = self.apps[app_id]
            blk.grant = grant
            blk.transition(BlockState.APPROVED,
                           f"{grant.n_chips} chips assigned")
            self._persist()
            self._emit(app_id, f"{grant.n_chips} chips assigned")

    def enqueue(self, app_id: str, note: str = "pod full",
                now: Optional[float] = None) -> int:
        """Place an application on the admission waitlist (QUEUED state).
        Returns its FIFO sequence number (the base ordering the scheduler's
        fair-share policy refines).  ``now`` keeps queued_at on the model
        clock when the caller drives simulated time."""
        with self._lock:
            blk = self.apps[app_id]
            blk.transition(BlockState.QUEUED, note)
            blk.queued_at = now if now is not None else time.time()
            self._queue_seq += 1
            self._queue_order[app_id] = self._queue_seq
            self._persist()
            self._emit(app_id, note, now=now)
            return self._queue_order[app_id]

    def mark_preempted(self, app_id: str, note: str,
                       progress_lost_steps: int = 0,
                       checkpoint_step: Optional[int] = None,
                       from_state: Optional[str] = None,
                       now: Optional[float] = None) -> int:
        """Record an eviction: transition to PREEMPTED, append to the
        persisted preemption history, and re-enter the admission queue
        (preempted blocks keep their FIFO position machinery so the
        scheduler can order them for auto-resume).  Returns the new
        queue sequence number.  ``from_state`` overrides the recorded
        pre-eviction state (deferred chip-failure recovery passes the
        pre-*failure* state so auto-resume returns the block there)."""
        with self._lock:
            blk = self.apps[app_id]
            if from_state is None:
                from_state = blk.state.value
            blk.transition(BlockState.PREEMPTED, note)
            blk.record_preemption(note, progress_lost_steps, checkpoint_step,
                                  from_state)
            blk.queued_at = now if now is not None else time.time()
            self._queue_seq += 1
            self._queue_order[app_id] = self._queue_seq
            self._persist()
            self._emit(app_id, note, now=now)
            return self._queue_order[app_id]

    def queue_seq(self, app_id: str) -> int:
        with self._lock:
            return self._queue_order.get(app_id, 0)

    def queued(self) -> List[str]:
        """QUEUED applications in FIFO enqueue order."""
        with self._lock:
            ids = [a for a, b in self.apps.items()
                   if b.state == BlockState.QUEUED]
            return sorted(ids, key=lambda a: self._queue_order.get(a, 0))

    def deny(self, app_id: str, reason: str = "") -> None:
        with self._lock:
            self.apps[app_id].transition(BlockState.DENIED, reason)
            self._persist()
            self._emit(app_id, reason)

    def confirm(self, app_id: str, token: str) -> None:
        with self._lock:
            blk = self.apps[app_id]
            if blk.grant is None or token != blk.grant.token:
                raise PermissionError("bad block token")
            blk.transition(BlockState.CONFIRMED, "user reconfirmed")
            self._persist()
            self._emit(app_id, "user reconfirmed")

    def set_state(self, app_id: str, state: BlockState, note: str = "") -> None:
        with self._lock:
            self.apps[app_id].transition(state, note)
            self._persist()
            self._emit(app_id, note)

    # -------------------------------------------------------------- queries
    def get(self, app_id: str) -> Block:
        return self.apps[app_id]

    def by_state(self, *states: BlockState) -> List[str]:
        with self._lock:
            return [a for a, b in self.apps.items() if b.state in states]

    def by_block_id(self, block_id: str) -> Optional[str]:
        with self._lock:
            for a, b in self.apps.items():
                if b.grant and b.grant.block_id == block_id:
                    return a
            return None

    def expired(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.time()   # 0.0 is model time
        with self._lock:
            return [a for a, b in self.apps.items()
                    if b.grant and now > b.grant.expires_at
                    and b.state in (BlockState.APPROVED, BlockState.CONFIRMED,
                                    BlockState.ACTIVE, BlockState.RUNNING,
                                    BlockState.DONE, BlockState.PREEMPTED)]

    # -------------------------------------------------------------- persist
    def persist(self) -> None:
        """Snapshot state out-of-band (e.g. after a grant re-carve that
        changes no lifecycle state)."""
        with self._lock:
            self._persist()

    def _persist(self) -> None:
        if not self.state_path:
            return
        # "_sessions"/"_pods" cannot collide with app ids (always "app_NNNN")
        snap: Dict = {"_sessions": self._sessions} if self._sessions else {}
        if self._pods:
            snap["_pods"] = self._pods
        for app_id, blk in self.apps.items():
            snap[app_id] = {
                "user": blk.request.user,
                "job": blk.request.job_description,
                "arch": blk.request.arch,
                "shape": blk.request.shape,
                "n_chips": blk.request.n_chips,
                # tenancy-policy metadata: a restarted scheduler (or the
                # external UI) must see the same priority/deadline/gang
                # facts admission ordering uses for QUEUED entries
                "priority": blk.request.priority,
                "deadline_s": blk.request.deadline_s,
                "deadline_at": blk.deadline_at,
                "gang_id": blk.request.gang_id,
                "state": blk.state.value,
                "block_id": blk.block_id,
                "coords": blk.grant.coords if blk.grant else None,
                "expires_at": blk.grant.expires_at if blk.grant else None,
                "history": blk.history[-20:],
                "failure": blk.failure_reason,
                "queued_at": blk.queued_at,
                "preempt_count": blk.preempt_count,
                "preemptions": blk.preemptions[-20:],
            }
        target_dir = os.path.dirname(self.state_path) or "."
        os.makedirs(target_dir, exist_ok=True)
        # Crash-safe write: unique temp file in the *same directory* (so the
        # rename cannot cross filesystems), fsync before the atomic
        # os.replace — a crash at any point leaves either the old state file
        # or the new one, never a truncated mix.  A fixed ".tmp" name would
        # also let two writers clobber each other's half-written file.
        fd, tmp = tempfile.mkstemp(prefix=".registry_", suffix=".tmp",
                                   dir=target_dir)
        try:
            # mkstemp creates 0600; restore umask-default permissions so
            # the external UI/CLI this file exists for can still read it
            os.fchmod(fd, 0o666 & ~_UMASK)
            with os.fdopen(fd, "w") as f:
                json.dump(snap, f, indent=1, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.state_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
