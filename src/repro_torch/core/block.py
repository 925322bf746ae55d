"""Block model: the paper's per-tenant unit of allocation.

A *block* = an admin-assigned, disjoint set of chips + its own parallel
runtime configuration ("MPD ring" in the paper: per-user daemon + config
files).  Here: BlockRequest (the user's application), BlockGrant (the
admin's assignment: chip coords, mesh shape, capability token) and the
lifecycle state machine of Fig. 2 of the paper, extended with the
admission waitlist (QUEUED) and checkpoint-backed preemption (PREEMPTED).

Lifecycle state machine::

    REQUESTED --> DENIED
        |  \\
        |   +--> QUEUED ----------> DENIED | EXPIRED
        v           |
    APPROVED <------+
        |  \\
        |   +--> DENIED | EXPIRED
        v
    CONFIRMED --> EXPIRED
        |
        v
      ACTIVE <------------------+----------------+
        |  \\                    |                |
        |   +--> EXPIRED|FAILED |                | resume (re-grant,
        v                       |                |  possibly different
      RUNNING --> DONE --> EXPIRED               |  chips / mesh shape)
        |   \\                                   |
        |    +--> FAILED --> ACTIVE (recover)    |
        v                                        |
    PREEMPTED (drained + checkpointed, chips released) --> EXPIRED
        ^
        '-- scheduler evicts a lower-priority running block so a
            higher-priority waiter can be admitted; the victim re-enters
            the waitlist ahead of its fair-share class and is auto-resumed
            by ``tick()`` when capacity frees.  FAILED --> PREEMPTED covers
            deferred recovery: a chip-failed block whose replacement
            rectangle cannot be carved *right now* is checkpointed and
            parked for auto-resume instead of dying FAILED holding nothing.
"""
from __future__ import annotations

import dataclasses
import enum
import secrets
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.topology import Coord


class BlockState(str, enum.Enum):
    REQUESTED = "requested"       # (1) user registered an application
    QUEUED = "queued"             # (1b) admitted to the waitlist: pod full
    APPROVED = "approved"         # (2) admin reviewed, nodes assigned
    CONFIRMED = "confirmed"       # (3) user reconfirmed the assignment
    ACTIVE = "active"             # (3b) nodes powered, daemons up (runtime built)
    RUNNING = "running"           # (5) program uploaded and executing
    PREEMPTED = "preempted"       # (5b) evicted for a higher-priority block:
                                  #      drained, checkpointed, chips released
    DONE = "done"                 # (7) finished, results downloadable
    EXPIRED = "expired"           # usage period over, nodes shut down
    FAILED = "failed"             # chip failure / fatal error
    DENIED = "denied"             # admin rejected the application


# legal transitions of the lifecycle state machine
TRANSITIONS = {
    BlockState.REQUESTED: {BlockState.APPROVED, BlockState.DENIED,
                           BlockState.QUEUED},
    BlockState.QUEUED: {BlockState.APPROVED, BlockState.DENIED,
                        BlockState.EXPIRED},
    BlockState.APPROVED: {BlockState.CONFIRMED, BlockState.DENIED,
                          BlockState.EXPIRED},
    BlockState.CONFIRMED: {BlockState.ACTIVE, BlockState.EXPIRED},
    BlockState.ACTIVE: {BlockState.RUNNING, BlockState.EXPIRED,
                        BlockState.FAILED, BlockState.PREEMPTED},
    BlockState.RUNNING: {BlockState.DONE, BlockState.FAILED,
                         BlockState.EXPIRED, BlockState.ACTIVE,
                         BlockState.PREEMPTED},
    BlockState.PREEMPTED: {BlockState.ACTIVE, BlockState.EXPIRED},
    BlockState.FAILED: {BlockState.ACTIVE, BlockState.EXPIRED,
                        BlockState.PREEMPTED},
    BlockState.DONE: {BlockState.EXPIRED, BlockState.RUNNING},
}


@dataclasses.dataclass
class BlockRequest:
    user: str
    job_description: str
    n_chips: int
    arch: str = ""                    # architecture config id
    shape: str = "train_4k"           # input-shape cell
    duration_s: float = 3600.0        # requested usage period
    priority: int = 0                 # admission priority (higher = sooner)
    pod: Optional[int] = None         # admin pod pinning (None = any pod)
    deadline_s: Optional[float] = None  # SLO: wanted done this many seconds
                                        # after submission (None = no SLO)
    est_steps: Optional[int] = None   # user-declared work size; with the
                                      # Monitor's EWMA step time this gives
                                      # the admission-time completion
                                      # estimate slack ordering uses
    gang_id: Optional[str] = None     # co-scheduled set this block belongs
                                      # to (all-or-nothing admission)


@dataclasses.dataclass
class BlockGrant:
    block_id: str
    coords: List[Coord]               # admin-assigned chips (user-immutable)
    mesh_shape: Tuple[int, int]       # (data, model) within the block
    token: str                        # capability token (paper: MPD_SECRETWORD)
    expires_at: float                 # end of usage period

    @staticmethod
    def new(coords: List[Coord], mesh_shape: Tuple[int, int],
            duration_s: float) -> "BlockGrant":
        return BlockGrant(
            block_id=f"blk_{secrets.token_hex(4)}",
            coords=list(coords),
            mesh_shape=mesh_shape,
            token=secrets.token_hex(16),
            expires_at=time.time() + duration_s,
        )

    @property
    def n_chips(self) -> int:
        return len(self.coords)


@dataclasses.dataclass
class Block:
    request: BlockRequest
    state: BlockState = BlockState.REQUESTED
    grant: Optional[BlockGrant] = None
    history: List[Tuple[float, str]] = dataclasses.field(default_factory=list)
    result_path: Optional[str] = None
    failure_reason: Optional[str] = None
    queued_at: Optional[float] = None   # when the app entered the waitlist
    deadline_at: Optional[float] = None  # absolute SLO deadline, fixed at
                                         # submission (deadline_s is relative)
    # checkpoint-backed preemption bookkeeping (persisted by the Registry):
    # one record per eviction with the victim's progress state at that moment
    preemptions: List[Dict] = dataclasses.field(default_factory=list)

    @property
    def preempt_count(self) -> int:
        return len(self.preemptions)

    def record_preemption(self, reason: str, progress_lost_steps: int,
                          checkpoint_step: Optional[int],
                          from_state: str) -> None:
        self.preemptions.append({
            "t": time.time(),
            "reason": reason,
            "progress_lost_steps": int(progress_lost_steps),
            "checkpoint_step": checkpoint_step,
            "from_state": from_state,    # resume returns the block here
        })

    def transition(self, new_state: BlockState, note: str = "") -> None:
        if new_state not in TRANSITIONS.get(self.state, set()):
            raise ValueError(
                f"illegal transition {self.state.value} -> {new_state.value} "
                f"({self.request.user}: {note})")
        self.state = new_state
        self.history.append((time.time(), f"{new_state.value}: {note}"))

    @property
    def block_id(self) -> Optional[str]:
        return self.grant.block_id if self.grant else None
