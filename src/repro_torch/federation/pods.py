"""Pod registry: dynamic capacity units that join and leave at runtime.

A ``Pod`` is one unit of attachable capacity — its own single-pod
``Topology`` and its own ``Partitioner`` inventory, operating in *local*
coordinates ``(0, x, y)``.  The federation addresses chips by *global*
coordinates ``(pod_id, x, y)``; translation happens at the
``FederatedPartitioner`` boundary so each pod's allocator stays oblivious
to the pods around it (the paper's independent-block property).

Pod lifecycle is a flat phase string, deliberately separate from the block
lifecycle state machine:

    ready ──(missed heartbeats)──> degraded ──(more missed)──> dead
      │  ^──(heartbeat: false-positive grace)──┘
      └──(admin drain)──> draining ──(admin detach / health)──> gone|dead

Only ``ready`` pods receive new placements; ``draining``/``degraded`` pods
keep their residents; ``dead`` pods get their residents evicted by the
controller.  Every phase change is announced as a kind="pod" event.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core.partition import Partitioner
from repro_torch.core.topology import Coord, Topology

POD_READY = "ready"
POD_DEGRADED = "degraded"
POD_DRAINING = "draining"
POD_DEAD = "dead"
POD_PHASES = (POD_READY, POD_DEGRADED, POD_DRAINING, POD_DEAD)

# phase -> event action announced on the bus
_PHASE_ACTION = {POD_READY: "recovered", POD_DEGRADED: "degraded",
                 POD_DRAINING: "drained", POD_DEAD: "dead"}


def to_global(pod_id: int, coords: Sequence[Coord]) -> List[Coord]:
    return [(pod_id, x, y) for (_p, x, y) in coords]


def to_local(coords: Sequence[Coord]) -> List[Coord]:
    return [(0, x, y) for (_p, x, y) in coords]


@dataclasses.dataclass
class Pod:
    """One attachable capacity unit.  Mutable fields (phase, last_beat) are
    only written through ``PodRegistry`` methods under its lock."""
    pod_id: int
    name: str
    topo: Topology                 # local single-pod topology (n_pods == 1)
    part: Partitioner              # local-coordinate chip inventory
    devices: List = dataclasses.field(default_factory=list)
    phase: str = POD_READY
    joined_at: float = 0.0
    last_beat: Optional[float] = None   # None until the first heartbeat
    power_budget_chips: Optional[float] = None  # adaptive pacing budget
    boot: bool = False             # carved from the boot topology

    @property
    def n_chips(self) -> int:
        return self.topo.n_chips

    def describe(self) -> Dict:
        return {
            "pod_id": self.pod_id, "name": self.name,
            "pod_x": self.topo.pod_x, "pod_y": self.topo.pod_y,
            "n_chips": self.n_chips,
            "free_chips": len(self.part.free_chips()),
            "phase": self.phase, "joined_at": self.joined_at,
            "last_beat": self.last_beat,
            "power_budget_chips": self.power_budget_chips,
            "boot": self.boot,
        }


class PodRegistry:
    """Thread-safe pod directory.  Attach/detach/phase changes mutate the
    directory under ``_lock`` and publish kind="pod" events after releasing
    it (so the bus's subscriber chain never runs under a registry lock)."""

    def __init__(self, bus=None):
        self._lock = threading.RLock()
        self._pods: Dict[int, Pod] = {}
        self._next_id = 0
        self.bus = bus

    # -------------------------------------------------------------- attach
    def attach(self, pod_x: int, pod_y: int, devices: Sequence,
               name: Optional[str] = None,
               power_budget_chips: Optional[float] = None,
               boot: bool = False, pod_id: Optional[int] = None,
               now: Optional[float] = None) -> Pod:
        topo = Topology(n_pods=1, pod_x=pod_x, pod_y=pod_y)
        if len(devices) < topo.n_chips:
            raise ValueError(
                f"pod needs {topo.n_chips} devices, have {len(devices)}")
        t = now if now is not None else time.time()
        with self._lock:
            pid = pod_id if pod_id is not None else self._next_id
            if pid in self._pods:
                raise ValueError(f"pod {pid} already attached")
            self._next_id = max(self._next_id, pid) + 1
            pod = Pod(pod_id=pid, name=name or f"pod{pid}", topo=topo,
                      part=Partitioner(topo), devices=list(devices),
                      joined_at=t, power_budget_chips=power_budget_chips,
                      boot=boot)
            self._pods[pid] = pod
        self._publish("joined", pod, now=t)
        return pod

    def detach(self, pod_id: int, now: Optional[float] = None) -> Pod:
        """Remove a pod from the directory.  The caller (controller) is
        responsible for having evicted or migrated its residents first."""
        with self._lock:
            pod = self._pods.pop(pod_id)       # KeyError -> unknown pod
        self._publish("left", pod, now=now)
        return pod

    def set_phase(self, pod_id: int, phase: str,
                  now: Optional[float] = None) -> Pod:
        assert phase in POD_PHASES, phase
        with self._lock:
            pod = self._pods[pod_id]
            changed = pod.phase != phase
            pod.phase = phase
        if changed:
            self._publish(_PHASE_ACTION[phase], pod, now=now)
        return pod

    def beat(self, pod_id: int, now: Optional[float] = None) -> Pod:
        t = now if now is not None else time.time()
        with self._lock:
            pod = self._pods[pod_id]
            pod.last_beat = t
        return pod

    # --------------------------------------------------------------- reads
    def get(self, pod_id: int) -> Optional[Pod]:
        with self._lock:
            return self._pods.get(pod_id)

    def pod(self, pod_id: int) -> Pod:
        with self._lock:
            return self._pods[pod_id]          # KeyError -> unknown pod

    def pods(self) -> List[Pod]:
        """All pods (any phase), pod_id order."""
        with self._lock:
            return [self._pods[k] for k in sorted(self._pods)]

    def live(self) -> List[Pod]:
        """Pods that still hold capacity (everything but dead)."""
        return [p for p in self.pods() if p.phase != POD_DEAD]

    def placeable(self) -> List[Pod]:
        """Pods eligible for *new* placements."""
        return [p for p in self.pods() if p.phase == POD_READY]

    def total_chips(self) -> int:
        return sum(p.n_chips for p in self.live())

    def describe_all(self) -> List[Dict]:
        return [p.describe() for p in self.pods()]

    def snapshot(self) -> List[Dict]:
        """Persistable pod directory state (no devices — those are rebuilt
        on attach).  Round-trips through ``Registry`` under the reserved
        ``"_pods"`` key."""
        out = []
        for p in self.pods():
            out.append({
                "pod_id": p.pod_id, "name": p.name,
                "pod_x": p.topo.pod_x, "pod_y": p.topo.pod_y,
                "phase": p.phase, "joined_at": p.joined_at,
                "power_budget_chips": p.power_budget_chips,
                "boot": p.boot,
            })
        return out

    # ------------------------------------------------------------- events
    def _publish(self, action: str, pod: Pod,
                 now: Optional[float] = None) -> None:
        if self.bus is None:
            return
        self.bus.publish("pod", now=now, action=action, pod=pod.pod_id,
                         name=pod.name, phase=pod.phase, n_chips=pod.n_chips)
