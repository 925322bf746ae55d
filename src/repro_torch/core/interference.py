"""Link-contention / bisection-bandwidth model — the structural analogue of
the paper's Fig. 3 measurement.

The paper measured mpptest bisection bandwidth for one block alone vs. two
blocks concurrently, sharing a master node, and found "only slight" impact.
On a TPU torus the analogous question is physical: do two blocks' collective
footprints share ICI links?  For contiguous rectangular blocks the answer is
provably zero-shared-links; for fragmented placements this module quantifies
the contention and the resulting per-block effective bandwidth.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.topology import (Coord, Link, Topology, min_bisection_links)

LINK_BW = 50e9          # bytes/s per ICI link (v5e)
DCN_BW = 25e9           # bytes/s inter-pod (abstract pod link)


@dataclasses.dataclass
class InterferenceReport:
    block_links: Dict[str, int]              # links used per block
    shared_links: Dict[Tuple[str, str], int]  # pairwise shared-link counts
    slowdown: Dict[str, float]               # predicted collective slowdown

    @property
    def isolated(self) -> bool:
        return all(v == 0 for v in self.shared_links.values())


def analyze_blocks(topo: Topology,
                   blocks: Dict[str, Sequence[Coord]]) -> InterferenceReport:
    """Compute each block's ring-collective link footprint and all pairwise
    link sharing.  slowdown[b] = max over links used by b of (total users of
    that link) — 1.0 means perfectly isolated."""
    usage: Dict[str, Dict[Link, int]] = {
        bid: topo.ring_links(list(coords)) for bid, coords in blocks.items()}
    link_users: Dict[Link, int] = {}
    for bid, links in usage.items():
        for l in links:
            link_users[l] = link_users.get(l, 0) + 1
    shared: Dict[Tuple[str, str], int] = {}
    ids = sorted(usage)
    for i in range(len(ids)):
        for j in range(i + 1, len(ids)):
            inter = set(usage[ids[i]]) & set(usage[ids[j]])
            shared[(ids[i], ids[j])] = len(inter)
    slowdown = {}
    for bid, links in usage.items():
        slowdown[bid] = float(max((link_users[l] for l in links), default=1))
    return InterferenceReport(
        block_links={b: len(l) for b, l in usage.items()},
        shared_links=shared, slowdown=slowdown)


def bisection_bandwidth(coords: Sequence[Coord], topo: Topology,
                        *, contention: float = 1.0) -> float:
    """Aggregate bytes/s across the block's minimum bisection."""
    links = min_bisection_links(list(coords), topo)
    return links * LINK_BW / max(contention, 1.0)


def predicted_fig3(topo: Topology, block_a: Sequence[Coord],
                   block_b: Sequence[Coord],
                   message_sizes: Sequence[int],
                   *, host_overhead_s: float = 5e-6) -> List[Dict]:
    """Predicted mpptest-style bisection-bandwidth curves: block A alone vs.
    A with B running concurrently.  With contiguous placements the two curves
    differ only by the shared-host dispatch overhead — the paper's result.
    """
    rep = analyze_blocks(topo, {"a": list(block_a), "b": list(block_b)})
    bw_alone = bisection_bandwidth(block_a, topo)
    bw_shared = bisection_bandwidth(block_a, topo,
                                    contention=rep.slowdown["a"])
    rows = []
    for size in message_sizes:
        t_alone = size / bw_alone + host_overhead_s
        t_shared = size / bw_shared + 2 * host_overhead_s  # 2 blocks on host
        rows.append({
            "bytes": size,
            "bw_single_GBs": size / t_alone / 1e9,
            "bw_multi_GBs": size / t_shared / 1e9,
            "shared_links": rep.shared_links[("a", "b")],
        })
    return rows
