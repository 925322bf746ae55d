"""Elastic multi-pod federation — dynamic capacity for the control plane.

The paper's public cluster is built from independent node blocks that are
attached, carved up, and retired while the control plane keeps serving
everyone else (arXiv:0708.3446, and the openPC toolkit, arXiv:1012.2499).
This package is that elasticity for the TPU reproduction:

* ``PodRegistry`` / ``Pod`` — pods register and deregister with the daemon
  at runtime; each pod is its own single-pod ``Topology`` plus its own
  ``Partitioner`` inventory (pods.py);
* ``FederatedPartitioner`` — a drop-in ``Partitioner`` facade that carves
  rectangles across every attached pod, so the controller/scheduler keep
  their single-partitioner API (partition.py);
* ``HealthMonitor`` — heartbeat-fed pod health with a false-positive grace
  period; dead pods get their residents evicted into PREEMPTED and migrated
  toward surviving capacity via cross-geometry checkpoint restore
  (health.py);
* ``FederatedPlacer`` — per-pod placement scoring (free capacity, health,
  gang locality) plus the interference penalty that wires
  ``core/interference.py`` into admission (placer.py).
"""
from repro_torch.federation.health import HealthMonitor
from repro_torch.federation.partition import FederatedPartitioner
from repro_torch.federation.placer import FederatedPlacer
from repro_torch.federation.pods import (POD_DEAD, POD_DEGRADED, POD_DRAINING,
                                   POD_PHASES, POD_READY, Pod, PodRegistry)

__all__ = [
    "FederatedPartitioner", "FederatedPlacer", "HealthMonitor", "Pod",
    "PodRegistry", "POD_READY", "POD_DEGRADED", "POD_DRAINING", "POD_DEAD",
    "POD_PHASES",
]
