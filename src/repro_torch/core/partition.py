"""Torus-aware block partitioner: carve disjoint contiguous sub-meshes out of
the pod complex, track chip health, support elastic resize.

Contiguity is the TPU-native isolation property (DESIGN.md §2): a contiguous
rectangle owns all ICI links in its interior, so concurrent blocks share zero
fabric.  The allocator therefore only hands out axis-aligned rectangles
(first-fit, smallest-waste), never fragments.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.topology import Coord, Topology, rect_coords


class AllocationError(RuntimeError):
    pass


def mesh_shape_for(n_chips: int) -> Tuple[int, int]:
    """(data, model) factorization: closest-to-square, model <= 16."""
    best = (n_chips, 1)
    for m in range(1, min(n_chips, 16) + 1):
        if n_chips % m == 0:
            d = n_chips // m
            if abs(math.log(d / m)) <= abs(math.log(best[0] / best[1])):
                best = (d, m)
    return best


@dataclasses.dataclass
class ChipInfo:
    coord: Coord
    healthy: bool = True
    owner: Optional[str] = None      # block_id or None (free)


class Partitioner:
    """Thread-safe chip inventory + contiguous rectangle allocator."""

    def __init__(self, topo: Topology):
        self.topo = topo
        self._lock = threading.RLock()
        self.chips: Dict[Coord, ChipInfo] = {
            c: ChipInfo(c) for c in topo.coords()}

    # ----------------------------------------------------------- inventory
    def free_chips(self, pod: Optional[int] = None) -> List[Coord]:
        with self._lock:
            return [c for c, info in self.chips.items()
                    if info.owner is None and info.healthy
                    and (pod is None or c[0] == pod)]

    def owner_of(self, coord: Coord) -> Optional[str]:
        with self._lock:
            return self.chips[coord].owner

    def mark_unhealthy(self, coord: Coord) -> Optional[str]:
        """Chip failure: returns the owning block_id (to be failed over)."""
        with self._lock:
            info = self.chips[coord]
            info.healthy = False
            return info.owner

    def mark_healthy(self, coord: Coord) -> None:
        with self._lock:
            self.chips[coord].healthy = True

    # ------------------------------------------------------------ allocate
    def _rect_free(self, pod: int, x0: int, y0: int, w: int, h: int) -> bool:
        if x0 + w > self.topo.pod_x or y0 + h > self.topo.pod_y:
            return False
        for c in rect_coords(pod, x0, y0, w, h):
            info = self.chips[c]
            if info.owner is not None or not info.healthy:
                return False
        return True

    def _candidate_shapes(self, n_chips: int) -> List[Tuple[int, int]]:
        if n_chips < 1:
            raise AllocationError(f"invalid block size {n_chips}")
        shapes = []
        for w in range(1, self.topo.pod_x + 1):
            if n_chips % w == 0 and n_chips // w <= self.topo.pod_y:
                shapes.append((w, n_chips // w))
        if not shapes:
            raise AllocationError(f"{n_chips} chips has no rectangular shape")
        # prefer near-square (best locality / bisection)
        shapes.sort(key=lambda s: abs(math.log(s[0] / s[1])))
        return shapes

    def _find_rect(self, n_chips: int, pod: Optional[int]
                   ) -> Optional[Tuple[int, int, int, int, int]]:
        """First free (pod, x0, y0, w, h) rectangle, or None.  Caller holds
        the lock (or accepts a racy dry-run answer, as can_fit does)."""
        shapes = self._candidate_shapes(n_chips)
        pods = [pod] if pod is not None else list(range(self.topo.n_pods))
        for p in pods:
            for w, h in shapes:
                for x0 in range(self.topo.pod_x - w + 1):
                    for y0 in range(self.topo.pod_y - h + 1):
                        if self._rect_free(p, x0, y0, w, h):
                            return (p, x0, y0, w, h)
        return None

    def allocate(self, n_chips: int, block_id: str,
                 pod: Optional[int] = None) -> List[Coord]:
        """First-fit contiguous rectangle of >= n_chips (exact when n_chips
        factors into a rectangle that fits; raises otherwise)."""
        with self._lock:
            found = self._find_rect(n_chips, pod)
            if found is not None:
                p, x0, y0, w, h = found
                coords = rect_coords(p, x0, y0, w, h)
                for c in coords:
                    self.chips[c].owner = block_id
                return coords
        raise AllocationError(
            f"no contiguous {n_chips}-chip rectangle free "
            f"(free={len(self.free_chips())})")

    def can_fit(self, n_chips: int, pod: Optional[int] = None) -> bool:
        """Admission dry-run: would ``allocate`` succeed right now?  Does not
        mutate the inventory."""
        with self._lock:
            try:
                return self._find_rect(n_chips, pod) is not None
            except AllocationError:
                return False

    def allocate_many(self, specs: Sequence[Tuple[int, str, Optional[int]]]
                      ) -> Dict[str, List[Coord]]:
        """Gang allocation: find a rectangle for *every* ``(n_chips,
        block_id, pod)`` spec under one lock hold, committing only when all
        fit.  On any failure every partial placement is rolled back and the
        inventory is bit-identical to before the call — the all-or-nothing
        property multi-block (gang) admission requires."""
        with self._lock:
            placed: Dict[str, List[Coord]] = {}
            try:
                for n_chips, block_id, pod in specs:
                    if block_id in placed:
                        raise AllocationError(
                            f"duplicate gang block id {block_id}")
                    found = self._find_rect(n_chips, pod)
                    if found is None:
                        raise AllocationError(
                            f"gang member {block_id} needs {n_chips} chips: "
                            f"no contiguous rectangle free")
                    coords = rect_coords(*found)
                    for c in coords:
                        self.chips[c].owner = block_id
                    placed[block_id] = coords
            except AllocationError:
                for coords in placed.values():
                    for c in coords:
                        self.chips[c].owner = None
                raise
            return placed

    def can_fit_many(self, specs: Sequence[Tuple[int, Optional[int]]],
                     freed_block_ids: Sequence[str] = ()) -> bool:
        """Gang admission dry-run (optionally a preemption what-if with
        ``freed_block_ids``' chips treated as free): would ``allocate_many``
        succeed right now?  Places each rectangle under temporary dry-run
        ownership so members can't double-count the same free region; the
        inventory is unchanged when this returns."""
        with self._lock:
            saved: Dict[Coord, str] = {}
            freed = set(freed_block_ids)
            for c, info in self.chips.items():
                if info.owner in freed:
                    saved[c] = info.owner
                    info.owner = None
            marked: List[Coord] = []
            ok = True
            try:
                for i, (n_chips, pod) in enumerate(specs):
                    try:
                        found = self._find_rect(n_chips, pod)
                    except AllocationError:
                        found = None
                    if found is None:
                        ok = False
                        break
                    for c in rect_coords(*found):
                        self.chips[c].owner = f"_dryrun_{i}"
                        marked.append(c)
            finally:
                for c in marked:
                    self.chips[c].owner = None
                for c, owner in saved.items():
                    self.chips[c].owner = owner
            return ok

    def can_fit_excluding(self, n_chips: int, freed_block_ids: Sequence[str],
                          pod: Optional[int] = None) -> bool:
        """Preemption what-if for a single rectangle: would ``allocate``
        succeed if these blocks' chips were freed first?  The inventory is
        unchanged when this returns."""
        return self.can_fit_many([(n_chips, pod)], freed_block_ids)

    def shape_possible(self, n_chips: int) -> bool:
        """Could this request *ever* fit (valid size with a rectangular
        shape inside one pod)?  False means waitlisting it is pointless."""
        try:
            self._candidate_shapes(n_chips)
            return True
        except AllocationError:
            return False

    def free_capacity(self, pod: Optional[int] = None) -> int:
        """Free healthy chips (upper bound on what can be admitted; actual
        admission also needs a contiguous rectangle — see can_fit)."""
        return len(self.free_chips(pod))

    def retag(self, old_id: str, new_id: str) -> int:
        """Atomically re-assign every chip owned by ``old_id`` to ``new_id``
        (grant finalization: pending reservation -> real block id).  Holding
        the lock across the whole sweep means a concurrent allocate can never
        observe the chips as free mid-retag."""
        with self._lock:
            n = 0
            for info in self.chips.values():
                if info.owner == old_id:
                    info.owner = new_id
                    n += 1
            return n

    def release(self, block_id: str) -> int:
        with self._lock:
            n = 0
            for info in self.chips.values():
                if info.owner == block_id:
                    info.owner = None
                    n += 1
            return n

    def owned_by(self, block_id: str) -> List[Coord]:
        with self._lock:
            return [c for c, info in self.chips.items()
                    if info.owner == block_id]

    def placements(self) -> Dict[str, List[Coord]]:
        """Snapshot of current ownership: ``{block_id: coords}``.  Feeds the
        federation placer's interference scoring (core/interference.py)."""
        with self._lock:
            out: Dict[str, List[Coord]] = {}
            for c, info in self.chips.items():
                if info.owner is not None:
                    out.setdefault(info.owner, []).append(c)
            return out

    def suspend_owners(self, block_ids: Sequence[str]) -> Dict[Coord, str]:
        """Temporarily free these blocks' chips for a preemption what-if and
        return the saved ownership for ``restore_owners``.  The federation's
        gang dry-run uses this pair instead of reaching into ``chips``."""
        with self._lock:
            ids = set(block_ids)
            saved: Dict[Coord, str] = {}
            for c, info in self.chips.items():
                if info.owner in ids:
                    saved[c] = info.owner
                    info.owner = None
            return saved

    def restore_owners(self, saved: Dict[Coord, str]) -> None:
        with self._lock:
            for c, owner in saved.items():
                self.chips[c].owner = owner

    # ------------------------------------------------------------- elastic
    def resize(self, block_id: str, new_n_chips: int,
               pod: Optional[int] = None) -> List[Coord]:
        """Elastic grow/shrink, atomic under one lock hold: the replacement
        rectangle is searched with the block's *own* chips treated as free
        — so growing 4→8 in place works whenever the block's rectangle plus
        adjacent free chips form a valid 8-rect — and ownership flips
        old→new only after a rectangle is found.  On failure the block
        keeps its old chips; there is never a window where it holds
        nothing."""
        with self._lock:
            mine = [c for c, info in self.chips.items()
                    if info.owner == block_id]
            for c in mine:
                self.chips[c].owner = None
            found = None
            try:
                found = self._find_rect(new_n_chips, pod)
            finally:
                if found is None:
                    for c in mine:
                        self.chips[c].owner = block_id
            if found is None:
                raise AllocationError(
                    f"no contiguous {new_n_chips}-chip rectangle for "
                    f"resize of {block_id} (even counting its own chips)")
            coords = rect_coords(*found)
            for c in coords:
                self.chips[c].owner = block_id
            return coords

    # ---------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        """Every chip has <= 1 owner; owners' chip sets are disjoint (by
        construction of the map, but kept as an explicit verifiable claim —
        the paper's 'interferences completely avoided')."""
        with self._lock:
            seen: Dict[str, Set[Coord]] = {}
            for c, info in self.chips.items():
                if info.owner is not None:
                    seen.setdefault(info.owner, set()).add(c)
            ids = list(seen)
            for i in range(len(ids)):
                for j in range(i + 1, len(ids)):
                    inter = seen[ids[i]] & seen[ids[j]]
                    assert not inter, f"blocks {ids[i]},{ids[j]} share {inter}"
