"""Shared in-flight dispatch window — the protocol ``scheduler.drive``
targets.

Both the real per-tenant engine (``BlockRuntime``) and the wall-clock
simulation (``SimRuntime``) keep a bounded window of asynchronously
dispatched steps and harvest completions oldest-first.  The window
bookkeeping (depth, oldest-dispatch ordering, poll/drain loop, serial-chain
step accounting) is identical in both; only *what* a step is differs.
Subclasses implement three hooks:

* ``_launch() -> token``     — start one async step, return a completion
  token (a jax array whose readiness signals completion, or a model-time
  tuple for the simulator).
* ``_token_ready(token)``    — has the step completed (non-blocking)?
* ``_token_wait(token)``     — block until the step completes.

and may override ``_completion_record(dispatch_t, token)`` when wall-clock
measurement is not the right accounting (the simulator reports model time).

``step_s`` accounting: steps within a block form a serial chain, so each
completion is measured from max(its dispatch, the previous step's observed
completion) — counting each step from its own dispatch would bill the wait
behind its predecessor twice at dispatch depth > 1 (inflating EWMA/
straggler/chip-second accounting by ~the window depth).
"""
from __future__ import annotations

import collections
import time
from typing import Any, Deque, Dict, List, Tuple


class InflightWindow:
    """Mixin: bounded async dispatch window with oldest-first harvesting."""

    _inflight: Deque[Tuple[float, Any]]
    _last_ready_t: float

    def _init_window(self) -> None:
        # (dispatch wall-time, completion token) per step not yet observed
        self._inflight = collections.deque()
        self._last_ready_t = 0.0

    # ------------------------------------------------------------- hooks
    def _launch(self) -> Any:
        raise NotImplementedError

    def _token_ready(self, token: Any) -> bool:
        raise NotImplementedError

    def _token_wait(self, token: Any) -> None:
        raise NotImplementedError

    def _completion_record(self, dispatch_t: float,
                           token: Any) -> Dict[str, float]:
        now = time.perf_counter()
        rec = {"step_s": now - max(dispatch_t, self._last_ready_t)}
        self._last_ready_t = now
        return rec

    # ---------------------------------------------------------- protocol
    @property
    def inflight_depth(self) -> int:
        return len(self._inflight)

    def oldest_dispatch_t(self) -> float:
        """Dispatch wall-time of the oldest in-flight step (the scheduler
        blocks on the runtime with the smallest value when every window is
        full).  +inf when nothing is in flight."""
        return self._inflight[0][0] if self._inflight else float("inf")

    def dispatch(self) -> None:
        """Dispatch one async step and track its completion token.  The
        scheduler caps how many of these are outstanding per block
        (dispatch-depth backpressure) so host runahead stays bounded."""
        t0 = time.perf_counter()
        token = self._launch()
        self._inflight.append((t0, token))

    def poll(self, block: bool = False) -> List[Dict[str, float]]:
        """Harvest completed in-flight steps (oldest first).  With
        ``block=True``, waits for the head step if nothing is ready yet —
        the scheduler's no-busy-spin fallback."""
        out: List[Dict[str, float]] = []
        while self._inflight:
            t0, token = self._inflight[0]
            if block and not out:
                self._token_wait(token)
            if not self._token_ready(token):
                break
            self._inflight.popleft()
            out.append(self._completion_record(t0, token))
        return out

    def drain(self) -> List[Dict[str, float]]:
        """Block until every in-flight step has completed."""
        out: List[Dict[str, float]] = []
        while self._inflight:
            out.extend(self.poll(block=True))
        return out
