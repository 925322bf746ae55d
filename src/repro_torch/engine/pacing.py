"""PacingPolicy — who gets the next dispatch slot, and how many.

Each engine round has a bounded dispatch budget (the pump thread must get
back to commands and ticks quickly).  The policy splits that budget across
the runnable autostep blocks by *weighted deficit round-robin*:

* every runnable block accrues credit proportional to its weight each
  round (``deficit``, persisted on the engine's per-block drive state);
* weight = a priority term, divided by the chips the block already holds
  (fair interleave: a 2x-bigger block gets half the dispatch slots — it
  does 2x the work per step), boosted when the block's *effective
  deadline slack* (time-to-deadline minus estimated remaining service
  time) is shrinking below ``boost_slack_s``;
* slots go to the highest-credit block first, one dispatch at a time,
  re-ranking after every grant — work-conserving: leftover budget flows
  to whoever still has window room even if their credit is negative.

Backpressure is structural, not policy: a block whose in-flight window is
full (``scheduler.max_inflight``) or whose per-block token bucket
(``max_rate_hz``) is empty is simply not a candidate this round, and its
deficit does not accrue (a stalled block must not bank unbounded credit
and then monopolize the budget when it wakes).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class BlockView:
    """One runnable autostep block, as the policy sees it this round."""
    app_id: str
    priority: int = 0
    n_chips: int = 1
    slack_s: Optional[float] = None    # effective deadline slack (None = no SLO)
    room: int = 0                      # dispatches the window/rate/run-until
                                       # targets still allow this round
    deficit: float = 0.0               # accrued credit (engine persists it)


class PacingPolicy:
    """Fair-interleave pacing with priority weighting and deadline boost.

    Subclass and override ``weight`` (or all of ``allocate``) to plug in a
    different pacing discipline; the engine only calls these two hooks.
    """

    def __init__(self, priority_weight: float = 0.5,
                 chip_fairness: bool = True,
                 boost_slack_s: float = 30.0,
                 deadline_boost: float = 4.0,
                 round_budget: int = 16,
                 default_rate_hz: Optional[float] = None):
        self.priority_weight = priority_weight
        self.chip_fairness = chip_fairness
        self.boost_slack_s = boost_slack_s
        self.deadline_boost = deadline_boost
        self.round_budget = round_budget
        #: per-block step-rate cap applied when the block's own config
        #: leaves ``max_rate_hz`` unset (None = unpaced)
        self.default_rate_hz = default_rate_hz

    # --------------------------------------------------------------- hooks
    def weight(self, view: BlockView) -> float:
        """Relative share of the dispatch budget this block earns per
        round.  Must be > 0 for every runnable block."""
        w = 1.0 + max(0, view.priority) * self.priority_weight
        if self.chip_fairness:
            w /= max(1, view.n_chips)
        if view.slack_s is not None and view.slack_s < self.boost_slack_s:
            # deadline-aware boost, scaling up as the slack keeps shrinking
            # (a block already past its deadline gets the full boost)
            frac = max(0.0, view.slack_s) / self.boost_slack_s
            w *= 1.0 + (self.deadline_boost - 1.0) * (1.0 - frac)
        return w

    def allocate(self, views: List[BlockView],
                 budget: Optional[int] = None) -> List[str]:
        """Split ``budget`` dispatch slots across ``views`` (one list entry
        per dispatch, in dispatch order).  Mutates each view's ``deficit``;
        the engine writes them back to its per-block drives."""
        budget = self.round_budget if budget is None else budget
        live = [v for v in views if v.room > 0]
        if not live or budget <= 0:
            return []
        weights: Dict[str, float] = {v.app_id: self.weight(v) for v in live}
        norm = sum(weights.values()) or 1.0
        for v in live:
            v.deficit += budget * weights[v.app_id] / norm
            # bank at most one round of credit: a block rate-capped for a
            # while must not starve everyone else when it becomes eligible
            v.deficit = min(v.deficit, float(budget))
        plan: List[str] = []
        while budget > 0:
            v = max((x for x in live if x.room > 0),
                    key=lambda x: x.deficit, default=None)
            if v is None:
                break
            plan.append(v.app_id)
            v.deficit -= 1.0
            v.room -= 1
            budget -= 1
        return plan
