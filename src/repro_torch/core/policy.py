"""SchedulingPolicy — the tenancy policy layer the BlockScheduler consults.

The paper's follow-ups make the missing multi-tenant pieces explicit:
"Multi and Independent Block Approach in Public Cluster" (arXiv:0708.3446)
requires jobs that span *several* blocks at once, and openPC
(arXiv:1012.2499) moves per-user ownership limits from the administrator
into the toolkit itself.  This module is where those rules live, separated
from the scheduler's mechanics so operators can swap or tune policy without
touching admission/dispatch code.  The scheduler consults it at three
points:

* **submit time** — ``admission_blocked`` decides whether a request (or a
  whole gang) may be admitted at all under the user's quota.  Over-quota is
  a *waitlist* outcome, never a denial: the request becomes admissible
  again as the user's running blocks retire.
* **pump time** — ``waitlist_key`` orders the waitlist.  Within a
  fair-share class (priority, then preempted victims, then held chips)
  entries are ordered by least deadline slack instead of FIFO, so a
  tight-deadline request submitted late still beats a loose one submitted
  early.
* **preempt time** — ``victim_key`` ranks eviction candidates.  Blocks
  whose user is currently *over* quota (caps can be lowered at runtime, and
  chip-second budgets run out while a block is running) are preferred
  victims ahead of the usual (priority, progress-lost, chips) key.

Quota accounting inputs are the scheduler's own held-chips map and the
per-user chip-seconds aggregated from ``Monitor.chip_seconds``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass
class UserQuota:
    """Hard per-user caps.  ``None`` means uncapped.

    * ``max_chips`` — chips the user may hold concurrently across all of
      their blocks (openPC's per-user node-ownership limit).
    * ``max_chip_seconds`` — cumulative compute budget; once spent, new
      admissions wait until the budget is raised.
    """
    max_chips: Optional[int] = None
    max_chip_seconds: Optional[float] = None


class SchedulingPolicy:
    """Quotas + deadline-slack ordering + victim preference.

    ``deadline_ordering=False`` degrades the within-class order back to
    plain FIFO (the PR-1 behavior) — the policy-vs-FIFO comparison knob
    ``benchmarks/policy_admission.py`` flips.  ``completion_aware=False``
    degrades slack back to pure time-to-deadline (ignoring the estimated
    remaining service time).  ``preempt_slack_margin_s`` is the headroom
    below which an on-track deadlined block is exempt from eviction (see
    ``victim_deadline_exempt``).
    """

    def __init__(self, default_quota: Optional[UserQuota] = None,
                 deadline_ordering: bool = True,
                 completion_aware: bool = True,
                 deadline_aware_preemption: bool = True,
                 preempt_slack_margin_s: float = 60.0):
        self.quotas: Dict[str, UserQuota] = {}
        self.default_quota = default_quota or UserQuota()
        self.deadline_ordering = deadline_ordering
        self.completion_aware = completion_aware
        self.deadline_aware_preemption = deadline_aware_preemption
        self.preempt_slack_margin_s = preempt_slack_margin_s

    # -------------------------------------------------------------- quotas
    def set_quota(self, user: str, max_chips: Optional[int] = None,
                  max_chip_seconds: Optional[float] = None) -> UserQuota:
        q = UserQuota(max_chips=max_chips, max_chip_seconds=max_chip_seconds)
        self.quotas[user] = q
        return q

    def quota_for(self, user: str) -> UserQuota:
        return self.quotas.get(user, self.default_quota)

    def admission_blocked(self, user: str, requested_chips: int,
                          held_chips: int,
                          used_chip_seconds: float) -> Optional[str]:
        """None when admissible; otherwise the human-readable reason the
        request must stay waitlisted (recorded in the registry history)."""
        q = self.quota_for(user)
        if q.max_chips is not None and \
                held_chips + requested_chips > q.max_chips:
            return (f"quota: {user} holds {held_chips} chips, "
                    f"+{requested_chips} exceeds cap {q.max_chips}")
        if q.max_chip_seconds is not None and \
                used_chip_seconds >= q.max_chip_seconds:
            return (f"quota: {user} spent {used_chip_seconds:.1f} "
                    f"chip-seconds of {q.max_chip_seconds:.1f} budget")
        return None

    def over_quota(self, user: str, held_chips: int,
                   used_chip_seconds: float) -> bool:
        """Is the user currently *above* either cap?  Admission enforces the
        caps, so this only becomes true while blocks run: a budget is spent
        step by step, and an operator can lower a cap under a running
        block.  Such blocks are the preferred preemption victims."""
        q = self.quota_for(user)
        if q.max_chips is not None and held_chips > q.max_chips:
            return True
        if q.max_chip_seconds is not None and \
                used_chip_seconds >= q.max_chip_seconds:
            return True
        return False

    # ------------------------------------------------------------ ordering
    @staticmethod
    def slack(deadline_at: Optional[float], now: float) -> float:
        """Seconds until the deadline; +inf when the entry has none (so
        deadline-less entries sort after every deadlined one in-class)."""
        return math.inf if deadline_at is None else deadline_at - now

    def waitlist_key(self, entry, held_chips: int, now: float,
                     service_s: float = 0.0) -> Tuple:
        """Admission order: priority desc, preempted victims ahead of their
        fair-share class, fewest held chips, then least *effective* slack,
        then FIFO sequence as the final tie-break.

        Effective slack is time-to-deadline minus the estimated remaining
        service time (``service_s``, from the requester's declared
        ``est_steps`` x the Monitor's EWMA step time): two entries with the
        same deadline no longer tie — the one with more work left is the
        one actually at risk and goes first."""
        slack = (self.slack(entry.deadline_at, now)
                 if self.deadline_ordering else math.inf)
        if self.completion_aware and math.isfinite(slack):
            slack -= service_s
        return (-entry.priority, not entry.preempted, held_chips,
                slack, entry.seq)

    # ----------------------------------------------------------- preemption
    def victim_headroom(self, deadline_at: Optional[float], now: float,
                        est_remaining_s: float = 0.0) -> float:
        """The victim's own deadline headroom if it kept running: slack
        minus its estimated remaining service time.  +inf without an SLO."""
        if deadline_at is None:
            return math.inf
        return deadline_at - now - est_remaining_s

    def victim_deadline_exempt(self, deadline_at: Optional[float],
                               now: float,
                               est_remaining_s: float = 0.0) -> bool:
        """Never evict a block into a deadline miss it would not otherwise
        have had: a victim currently *on track* (headroom >= 0) whose
        headroom could not absorb an eviction round-trip
        (< ``preempt_slack_margin_s``) is exempt.  A block already past
        recovery (headroom < 0) is not protected — eviction creates no
        *new* miss — and neither is a deadline-less block."""
        if not self.deadline_aware_preemption or deadline_at is None:
            return False
        headroom = deadline_at - now - est_remaining_s
        return 0.0 <= headroom < self.preempt_slack_margin_s

    def victim_key(self, over_quota: bool, priority: int,
                   progress_lost: int, n_chips: int,
                   headroom_s: float = math.inf) -> Tuple:
        """Eviction rank: quota-busting blocks first, then least important,
        most deadline headroom (a deadline-less block sorts ahead of any
        deadlined one — evicting it risks no SLO), cheapest-to-stop,
        smallest."""
        return (not over_quota, priority, -headroom_s, progress_lost,
                n_chips)
