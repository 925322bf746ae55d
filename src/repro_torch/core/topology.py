"""Torus topology model for the pod complex.

A pod is a 2D (16x16) chip grid with ICI links between +/-x, +/-y neighbors
(wraparound at the pod boundary); pods are joined by a lower-bandwidth
inter-pod fabric (DCN).  This is the structural substrate for the paper's
interference question: which physical links does each tenant block use, and
do concurrent blocks share any.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, Iterable, List, Sequence, Set, Tuple

Coord = Tuple[int, int, int]          # (pod, x, y)
Link = Tuple[Coord, Coord]            # canonical: min endpoint first


@dataclasses.dataclass(frozen=True)
class Topology:
    n_pods: int = 2
    pod_x: int = 16
    pod_y: int = 16
    wrap: bool = True                 # torus wraparound within a pod

    @property
    def n_chips(self) -> int:
        return self.n_pods * self.pod_x * self.pod_y

    def coords(self) -> List[Coord]:
        return [(p, x, y)
                for p in range(self.n_pods)
                for x in range(self.pod_x)
                for y in range(self.pod_y)]

    def chip_index(self, c: Coord) -> int:
        p, x, y = c
        return (p * self.pod_x + x) * self.pod_y + y

    def neighbors(self, c: Coord) -> List[Coord]:
        p, x, y = c
        out = []
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nx, ny = x + dx, y + dy
            if self.wrap:
                nx %= self.pod_x
                ny %= self.pod_y
                out.append((p, nx, ny))
            elif 0 <= nx < self.pod_x and 0 <= ny < self.pod_y:
                out.append((p, nx, ny))
        return out

    def canonical_link(self, a: Coord, b: Coord) -> Link:
        return (a, b) if a <= b else (b, a)

    def links(self) -> Set[Link]:
        out: Set[Link] = set()
        for c in self.coords():
            for n in self.neighbors(c):
                out.add(self.canonical_link(c, n))
        return out

    # ------------------------------------------------------------ routing
    def route(self, a: Coord, b: Coord) -> List[Link]:
        """Dimension-ordered shortest path (X then Y); inter-pod hops are
        represented as a single abstract 'pod link'."""
        links: List[Link] = []
        cur = a
        if a[0] != b[0]:
            # abstract DCN hop: (pod boundary)
            links.append(self.canonical_link(cur, (b[0], cur[1], cur[2])))
            cur = (b[0], cur[1], cur[2])

        def step_towards(v, t, size):
            if v == t:
                return v
            if not self.wrap:
                return v + 1 if t > v else v - 1
            fwd = (t - v) % size
            bwd = (v - t) % size
            return (v + 1) % size if fwd <= bwd else (v - 1) % size

        while cur[1] != b[1]:
            nxt = (cur[0], step_towards(cur[1], b[1], self.pod_x), cur[2])
            links.append(self.canonical_link(cur, nxt))
            cur = nxt
        while cur[2] != b[2]:
            nxt = (cur[0], cur[1], step_towards(cur[2], b[2], self.pod_y))
            links.append(self.canonical_link(cur, nxt))
            cur = nxt
        return links

    def ring_links(self, chips: Sequence[Coord]) -> Dict[Link, int]:
        """Links (with multiplicity) used by a ring collective over ``chips``
        in the given order — the traffic footprint of one all-reduce round."""
        use: Dict[Link, int] = {}
        n = len(chips)
        for i in range(n):
            for l in self.route(chips[i], chips[(i + 1) % n]):
                use[l] = use.get(l, 0) + 1
        return use


def rect_coords(pod: int, x0: int, y0: int, w: int, h: int) -> List[Coord]:
    return [(pod, x, y) for x in range(x0, x0 + w) for y in range(y0, y0 + h)]


def min_bisection_links(coords: Sequence[Coord], topo: Topology) -> int:
    """Number of topology links crossing the best axis-aligned bisection of
    the chip set (contiguous rectangles: min(w, h) * rows-ish; general sets:
    evaluated over axis cuts)."""
    chips = set(coords)
    best = None
    xs = sorted({c[1] for c in chips})
    ys = sorted({c[2] for c in chips})
    # candidate cuts between consecutive x (or y) values splitting chips ~half
    for axis, vals in ((1, xs), (2, ys)):
        for cut in vals[1:]:
            left = {c for c in chips if c[axis] < cut}
            if not left or len(left) * 2 < len(chips) * 0.5:
                continue
            right = chips - left
            if not right:
                continue
            cross = 0
            for c in left:
                for n in topo.neighbors(c):
                    if n in right:
                        cross += 1
            if abs(len(left) - len(right)) <= max(1, len(chips) // 8):
                best = cross if best is None else min(best, cross)
    return best if best is not None else 0
