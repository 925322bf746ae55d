"""Per-session token-bucket rate limiting (gateway hardening).

One bucket per session token: ``rate_per_s`` tokens flow in continuously
up to a ``burst`` cap, every handled request spends one.  An empty bucket
means 429 with a retry hint — the public cluster's gateway must survive a
misbehaving client without starving the other tenants' sessions, and the
autostep engine removes the legitimate reason to hammer ``/steps`` in a
tight loop.

Buckets are created lazily and only store two floats, so the table stays
tiny even with many sessions; unauthenticated requests share one bucket
(key ``None``) — a spray of bad tokens cannot fill the table either.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple


class RateLimiter:
    def __init__(self, rate_per_s: float, burst: Optional[int] = None):
        assert rate_per_s > 0, "rate_per_s must be positive"
        self.rate_per_s = float(rate_per_s)
        self.burst = float(burst if burst is not None
                           else max(1.0, rate_per_s))
        self._lock = threading.Lock()
        self._buckets: Dict[Optional[str], Tuple[float, float]] = {}

    def allow(self, key: Optional[str],
              now: Optional[float] = None) -> Tuple[bool, float]:
        """Spend one token for ``key``.  Returns ``(allowed,
        retry_after_s)`` — the hint is how long until one token has
        refilled (0.0 when allowed)."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            tokens, last = self._buckets.get(key, (self.burst, now))
            tokens = min(self.burst, tokens + (now - last) * self.rate_per_s)
            if tokens >= 1.0:
                self._buckets[key] = (tokens - 1.0, now)
                return True, 0.0
            self._buckets[key] = (tokens, now)
            return False, (1.0 - tokens) / self.rate_per_s
