"""Per-pod placement scoring for federated admission.

The placer answers two questions for the ``FederatedPartitioner``:

* **which pod first?** — ``order()`` ranks placeable pods by free capacity
  (most-free first, stable by pod id), spreading load across the
  federation so a newly joined pod immediately attracts the waitlist;
* **is this rectangle a good neighbour?** — ``rect_penalty()`` predicts
  the cross-block interference a candidate rectangle would create against
  the pod's residents using the seed link-contention model
  (``core/interference.py``: ``analyze_blocks`` ring-collective footprints;
  ``bisection_bandwidth`` is the same model's bandwidth view).  Candidates
  whose predicted worst-case slowdown exceeds ``max_slowdown`` are
  *deprioritized*, never rejected — a penalized rectangle is still used
  when it is the only way to admit.  ``interference_penalty=False``
  disables the scoring entirely (the knob the satellite task requires).

Gang locality is the third scoring input: with ``allow_gang_split=False``
(the default) a gang's unpinned members are only placed when one pod fits
all of them, so co-scheduled blocks never straddle the DCN.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.core.interference import analyze_blocks
from repro_torch.core.topology import Coord
from repro_torch.federation.pods import Pod

# ownership tags that are not real resident blocks (grant reservations are
# real — they are about to become blocks — so they stay in the model)
_CANDIDATE = "__candidate__"


class FederatedPlacer:
    def __init__(self, interference_penalty: bool = True,
                 max_slowdown: float = 1.0,
                 allow_gang_split: bool = False):
        self.interference_penalty = interference_penalty
        self.max_slowdown = max_slowdown
        self.allow_gang_split = allow_gang_split

    def order(self, pods: Sequence[Pod]) -> List[Pod]:
        """Placement order: most free capacity first, then pod id."""
        return sorted(pods, key=lambda p: (-len(p.part.free_chips()),
                                           p.pod_id))

    def rect_penalty(self, pod: Pod, coords: Sequence[Coord]) -> float:
        """Predicted interference cost of placing this rectangle in this
        pod: 0.0 when the candidate stays within the slowdown threshold
        against every resident, else how far past the threshold the worst
        block lands.  Coordinates are pod-local."""
        if not self.interference_penalty:
            return 0.0
        placements = pod.part.placements()
        placements[_CANDIDATE] = list(coords)
        if len(placements) == 1:
            return 0.0                   # empty pod: nothing to interfere
        rep = analyze_blocks(pod.topo, placements)
        worst = max(rep.slowdown.values())
        return max(0.0, worst - self.max_slowdown)
