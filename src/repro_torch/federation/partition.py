"""FederatedPartitioner — the single-partitioner API over many pods.

The controller and scheduler were written against one ``Partitioner``; the
federation keeps that contract.  This facade implements the same surface
(allocate / can_fit / allocate_many / can_fit_many / resize / retag /
release / ...) by fanning out to each attached pod's own inventory, with
two twists:

* **coordinates are global** — callers see ``(pod_id, x, y)``; each pod's
  ``Partitioner`` only ever sees its local ``(0, x, y)`` frame;
* **pod choice is scored** — the ``FederatedPlacer`` orders placeable pods
  (free capacity, health via the placeable filter, gang locality) and
  deprioritizes rectangles whose predicted interference against resident
  blocks exceeds the threshold.

Gang semantics: unpinned gang members are co-placed inside one pod unless
the placer's ``allow_gang_split`` knob is set — co-scheduled blocks talk,
and the DCN link between pods is the one link rectangles cannot own.
Cross-pod ``resize`` doubles as migration: when the home pod cannot grow a
block (or is dead), the replacement rectangle is carved from another pod
and ownership moves atomically.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.partition import AllocationError
from repro_torch.core.topology import Coord, rect_coords
from repro_torch.federation.placer import FederatedPlacer
from repro_torch.federation.pods import POD_READY, Pod, PodRegistry, to_global


class FederatedPartitioner:
    """Drop-in ``Partitioner`` facade over the pod federation.  Holds no
    lock of its own: each pod's inventory is internally locked, and every
    multi-pod mutation runs under the daemon's control-plane serialization
    (the "thin federation layer" — cross-pod decisions are serialized by
    construction)."""

    def __init__(self, pods: PodRegistry,
                 placer: Optional[FederatedPlacer] = None):
        self.pods = pods
        self.placer = placer or FederatedPlacer()

    # ------------------------------------------------------------- helpers
    def _alloc_pods(self, pod: Optional[int]) -> List[Pod]:
        """Pods eligible to receive this placement, in placer order."""
        if pod is not None:
            p = self.pods.get(pod)
            return [p] if p is not None and p.phase == POD_READY else []
        return self.placer.order(self.pods.placeable())

    # ----------------------------------------------------------- inventory
    @property
    def chips(self) -> Dict[Coord, object]:
        """Merged chip inventory under global coordinates (read-only
        snapshot view — ``Partitioner.chips`` drop-in for inspection)."""
        out: Dict[Coord, object] = {}
        for p in self.pods.pods():
            for c, info in p.part.chips.items():
                out[(p.pod_id,) + c[1:]] = info
        return out

    def free_chips(self, pod: Optional[int] = None) -> List[Coord]:
        if pod is not None:
            p = self.pods.get(pod)
            return to_global(pod, p.part.free_chips()) if p else []
        out: List[Coord] = []
        for p in self.pods.placeable():
            out.extend(to_global(p.pod_id, p.part.free_chips()))
        return out

    def owner_of(self, coord: Coord) -> Optional[str]:
        return self.pods.pod(coord[0]).part.owner_of((0,) + coord[1:])

    def mark_unhealthy(self, coord: Coord) -> Optional[str]:
        return self.pods.pod(coord[0]).part.mark_unhealthy((0,) + coord[1:])

    def mark_healthy(self, coord: Coord) -> None:
        self.pods.pod(coord[0]).part.mark_healthy((0,) + coord[1:])

    # ------------------------------------------------------------ allocate
    def allocate(self, n_chips: int, block_id: str,
                 pod: Optional[int] = None) -> List[Coord]:
        """First fit across pods in placer order, preferring the first
        zero-interference rectangle; a penalized rectangle is still used
        when nothing better exists anywhere."""
        pods = self._alloc_pods(pod)
        best: Optional[Tuple[float, int, Pod]] = None
        for idx, p in enumerate(pods):
            try:
                found = p.part._find_rect(n_chips, 0)   # racy-ok dry probe
            except AllocationError:
                continue                                # shape never fits p
            if found is None:
                continue
            pen = self.placer.rect_penalty(p, rect_coords(*found))
            if best is None or (pen, idx) < (best[0], best[1]):
                best = (pen, idx, p)
            if pen <= 0.0:
                break
        if best is None:
            raise AllocationError(
                f"no contiguous {n_chips}-chip rectangle free in any "
                f"placeable pod ({len(pods)} pods, "
                f"free={len(self.free_chips(pod))})")
        coords = best[2].part.allocate(n_chips, block_id, pod=0)
        return to_global(best[2].pod_id, coords)

    def can_fit(self, n_chips: int, pod: Optional[int] = None) -> bool:
        return any(p.part.can_fit(n_chips, 0) for p in self._alloc_pods(pod))

    def allocate_many(self, specs: Sequence[Tuple[int, str, Optional[int]]]
                      ) -> Dict[str, List[Coord]]:
        """Gang allocation, all-or-nothing across the federation.  Pinned
        members go to their pod; unpinned members are co-placed inside one
        pod unless the placer allows gang splits."""
        placed: Dict[str, List[Coord]] = {}
        try:
            unpinned: List[Tuple[int, str]] = []
            for n_chips, block_id, pod in specs:
                if block_id in placed or any(b == block_id
                                             for _n, b in unpinned):
                    raise AllocationError(
                        f"duplicate gang block id {block_id}")
                if pod is not None:
                    placed[block_id] = self.allocate(n_chips, block_id,
                                                     pod=pod)
                else:
                    unpinned.append((n_chips, block_id))
            if unpinned:
                if self.placer.allow_gang_split:
                    for n_chips, block_id in unpinned:
                        placed[block_id] = self.allocate(n_chips, block_id)
                else:
                    placed.update(self._gang_one_pod(unpinned))
        except AllocationError:
            for block_id in placed:
                self.release(block_id)
            raise
        return placed

    def _gang_one_pod(self, specs: Sequence[Tuple[int, str]]
                      ) -> Dict[str, List[Coord]]:
        """Place every (n_chips, block_id) inside a single pod, trying pods
        in placer order; rolls the pod back between attempts."""
        for p in self._alloc_pods(None):
            placed: Dict[str, List[Coord]] = {}
            ok = True
            for n_chips, block_id in specs:
                try:
                    coords = p.part.allocate(n_chips, block_id, pod=0)
                except AllocationError:
                    ok = False
                    break
                placed[block_id] = to_global(p.pod_id, coords)
            if ok:
                return placed
            for block_id in placed:
                p.part.release(block_id)
        raise AllocationError(
            f"gang of {len(specs)} members fits no single pod "
            f"(gang split disabled)")

    def can_fit_many(self, specs: Sequence[Tuple[int, Optional[int]]],
                     freed_block_ids: Sequence[str] = ()) -> bool:
        """Gang admission dry-run (optionally a preemption what-if): runs
        the real ``allocate_many`` under temporary ids with the freed
        blocks' chips suspended, then rolls everything back — so the answer
        agrees with the commit path by construction."""
        saved = [(p, p.part.suspend_owners(freed_block_ids))
                 for p in self.pods.pods()]
        dry = [(n, f"_fdry_{i}", pod) for i, (n, pod) in enumerate(specs)]
        try:
            try:
                placed = self.allocate_many(dry)
            except AllocationError:
                return False
            for block_id in placed:
                self.release(block_id)
            return True
        finally:
            for p, s in saved:
                p.part.restore_owners(s)

    def can_fit_excluding(self, n_chips: int, freed_block_ids: Sequence[str],
                          pod: Optional[int] = None) -> bool:
        return self.can_fit_many([(n_chips, pod)], freed_block_ids)

    def shape_possible(self, n_chips: int) -> bool:
        """Could this request ever fit some live pod's geometry?"""
        return any(p.part.shape_possible(n_chips) for p in self.pods.live())

    def free_capacity(self, pod: Optional[int] = None) -> int:
        return len(self.free_chips(pod))

    def retag(self, old_id: str, new_id: str) -> int:
        return sum(p.part.retag(old_id, new_id) for p in self.pods.pods())

    def release(self, block_id: str) -> int:
        return sum(p.part.release(block_id) for p in self.pods.pods())

    def owned_by(self, block_id: str) -> List[Coord]:
        out: List[Coord] = []
        for p in self.pods.pods():
            out.extend(to_global(p.pod_id, p.part.owned_by(block_id)))
        return out

    def placements(self) -> Dict[str, List[Coord]]:
        out: Dict[str, List[Coord]] = {}
        for p in self.pods.pods():
            for block_id, coords in p.part.placements().items():
                out.setdefault(block_id, []).extend(
                    to_global(p.pod_id, coords))
        return out

    # ------------------------------------------------------------- elastic
    def resize(self, block_id: str, new_n_chips: int,
               pod: Optional[int] = None) -> List[Coord]:
        """Grow/shrink in place when the home pod can, else migrate: carve
        the replacement rectangle from another placeable pod and move
        ownership.  On failure the block keeps its old chips."""
        home: Optional[Pod] = None
        for p in self.pods.pods():
            if p.part.owned_by(block_id):
                home = p
                break
        if (home is not None and home.phase == POD_READY
                and (pod is None or pod == home.pod_id)):
            try:
                return to_global(home.pod_id,
                                 home.part.resize(block_id, new_n_chips, 0))
            except AllocationError:
                pass                          # fall through to migration
        tmp = f"_fmove_{block_id}"
        coords = self.allocate(new_n_chips, tmp, pod=pod)   # may raise
        self.release(block_id)
        self.retag(tmp, block_id)
        return coords

    # ---------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        seen: Dict[str, int] = {}
        for p in self.pods.pods():
            p.part.check_invariants()
            for block_id in p.part.placements():
                if block_id in seen:
                    raise AssertionError(
                        f"block {block_id} owns chips in pods "
                        f"{seen[block_id]} and {p.pod_id}")
                seen[block_id] = p.pod_id
