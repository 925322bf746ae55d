"""Heartbeat-fed pod health with a false-positive grace period.

Pods attached over the gateway are expected to heartbeat
(``POST /v1/pods/<id>/heartbeat``).  A pod that has *ever* heartbeat is
monitored; boot pods (and sim pods nobody heartbeats) never decay — the
daemon cannot tell "no agent" from "dead agent", so silence only counts
against pods that once spoke.

Decay is two-stage, which is the grace period:

    ready --(degraded_after_s silent)--> degraded
    degraded --(heartbeat)--> ready          (false positive cleared)
    degraded --(dead_after_s silent)--> dead (controller evicts residents)

``degraded`` pods stop receiving new placements (the placer only considers
``ready`` pods) but keep their residents running — nothing is evicted on a
single missed heartbeat.  Only ``dead`` triggers migration.
"""
from __future__ import annotations

import time
from typing import List, Optional

from repro_torch.federation.pods import (POD_DEAD, POD_DEGRADED, POD_READY,
                                   Pod, PodRegistry)


class HealthMonitor:
    """Stateless policy over the ``PodRegistry`` — all health state lives
    on the pods themselves (``last_beat``, ``phase``), so a registry
    snapshot carries it for free."""

    def __init__(self, pods: PodRegistry,
                 degraded_after_s: float = 5.0,
                 dead_after_s: float = 15.0):
        self.pods = pods
        self.degraded_after_s = degraded_after_s
        self.dead_after_s = dead_after_s

    def beat(self, pod_id: int, now: Optional[float] = None) -> Pod:
        """Record a heartbeat; a degraded pod recovers (false positive)."""
        t = now if now is not None else time.time()
        pod = self.pods.beat(pod_id, t)        # KeyError -> unknown pod
        if pod.phase == POD_DEGRADED:
            pod = self.pods.set_phase(pod_id, POD_READY, now=t)
        return pod

    def check(self, now: Optional[float] = None) -> List[int]:
        """Advance decay; returns pod ids newly declared dead so the
        controller can evict and migrate their residents."""
        t = now if now is not None else time.time()
        died: List[int] = []
        for pod in self.pods.pods():
            if pod.last_beat is None or pod.phase == POD_DEAD:
                continue
            age = t - pod.last_beat
            if age >= self.dead_after_s:
                self.pods.set_phase(pod.pod_id, POD_DEAD, now=t)
                died.append(pod.pod_id)
            elif age >= self.degraded_after_s and pod.phase == POD_READY:
                self.pods.set_phase(pod.pod_id, POD_DEGRADED, now=t)
        return died
