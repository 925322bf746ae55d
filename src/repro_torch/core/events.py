"""Event bus — the observable spine of the block lifecycle.

The paper's step (6) ("the administrator and automated system will monitor
the usage of all running users") and its web-interface companion
(arXiv:0711.0528) both assume the control plane *announces* what it does:
every lifecycle transition and every scheduling decision becomes a
``BlockEvent`` published on one bus, instead of the pre-daemon design where
the scheduler and controller called ``Monitor.record_*`` directly at a
dozen scattered sites.

Three consumer classes hang off the bus:

* the ``Monitor`` subscribes and translates semantic events (``admitted``,
  ``preempted``, ``step``, ...) into its accounting — same numbers as the
  old direct calls, now decoupled from the emitters;
* the web gateway's per-block event feed long-polls ``wait()`` so a
  browser (or ``examples/web_gateway_demo.py``) can watch a block move
  through the paper's lifecycle live;
* tests/benchmarks subscribe ad hoc (e.g. admit-to-event latency in
  ``benchmarks/gateway_throughput.py``).

Publishing is synchronous and in submission order: subscribers run on the
publishing thread before ``publish`` returns, so the deterministic
single-thread mode (tests, benchmarks) sees the exact same interleaving as
the pre-event-bus code.  The history ring buffer backs the long-poll feed;
``seq`` is a bus-wide monotonic cursor clients resume from.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Set

from repro_torch.obs.trace import TRACER


# The declared event taxonomy — the single schema every producer literal,
# consumer match and the dashboard's SSE subscription list are checked
# against by ``python -m repro.analysis`` (events_check pass).  Emitted by
# scheduler/controller, consumed by the Monitor.  Registry lifecycle
# transitions are additionally published as kind="state" with the new state
# in the payload, so the per-block feed shows *every* transition even when
# no scheduling decision was involved.  Ordered: docs and the dashboard
# enumerate kinds in this order.
EVENT_KINDS = (
    "registered",   # application entered the registry
    "state",        # lifecycle transition (payload: state, note)
    "enqueued",     # parked on the admission waitlist
    "dequeued",     # left the waitlist without admission (deny/expiry)
    "admitted",     # chips granted (payload: wait_s, priority, slack_s,
                    #   immediate, resumed)
    "preempted",    # evicted (payload: progress_lost_steps, reason,
                    #   checkpoint_step)
    "resumed",      # rebuilt on a fresh grant after preemption
    "step",         # one completed runtime step (payload: step_s, n_chips)
    "compile",      # a step executable was built or reused from the
                    #   compile cache (payload: action = hit | miss, label)
    "utilization",  # periodic pod usage sample from the scheduler pump
    "autostep",     # engine opt-in lifecycle (payload: action = enabled |
                    #   disabled | paced | done, plus the drive config)
    "session",      # generate-session lifecycle on a paged serve block
                    #   (payload: action = submitted | admitted | evicted |
                    #   finished, session, plus per-action detail)
    "generate",     # one generated token from a continuous-batching decode
                    #   step (payload: session, token, index, done)
    "pod",          # federation pod lifecycle (payload: action = joined |
                    #   left | drained | degraded | dead | recovered, plus
                    #   pod, name, phase, n_chips)
    "migrated",     # a block came back on a different pod than it was
                    #   evicted from (payload: from_pod, to_pod, n_chips)
    "postmortem",   # the flight recorder wrote a crash artifact (payload:
                    #   reason, name, n_events, n_spans)
)

KINDS = frozenset(EVENT_KINDS)


@dataclasses.dataclass(frozen=True)
class BlockEvent:
    seq: int                       # bus-wide monotonic cursor
    t: float                       # model time when the emitter passed now=
    kind: str
    app_id: Optional[str] = None
    block_id: Optional[str] = None
    user: Optional[str] = None
    payload: Dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {"seq": self.seq, "t": self.t, "kind": self.kind,
                "app_id": self.app_id, "block_id": self.block_id,
                "user": self.user, **self.payload}


Subscriber = Callable[[BlockEvent], None]


class EventBus:
    """Synchronous pub/sub with a bounded replay history.

    Thread-safe: publishes may come from the daemon's pump thread while
    gateway worker threads long-poll ``wait``.  Sequence numbers and the
    history ring are updated under one lock; subscriber callbacks run on
    the publishing thread *outside* the lock (a subscriber that publishes
    or waits would otherwise deadlock), which is order-preserving as long
    as mutations are serialized — exactly what the ClusterDaemon's command
    queue guarantees.
    """

    def __init__(self, history: int = 8192, per_block_history: int = 1024,
                 max_app_rings: int = 4096):
        # RLock: wait() re-enters events_since while holding the condition
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._seq = 0
        self._history: Deque[BlockEvent] = collections.deque(maxlen=history)
        # per-block rings behind the global ring: one hot block's step
        # storm (autostep engine) evicts only its *own* replay history —
        # another block's per-app feed stays complete even when the global
        # ring has long since wrapped past its events
        self._per_block_history = per_block_history
        self._per_app: Dict[str, Deque[BlockEvent]] = {}
        # per-app rings are created lazily and never die with the block
        # (a DONE/EXPIRED block's feed is still replayable) — so bound
        # their *count*: past the cap the least-recently-active quarter
        # is dropped (long-quiet blocks; the global ring still covers
        # anything recent)
        self._max_app_rings = max_app_rings
        self._subs: List[tuple] = []   # (callback, kinds-or-None)

    # ------------------------------------------------------------- publish
    def publish(self, kind: str, app_id: Optional[str] = None,
                block_id: Optional[str] = None, user: Optional[str] = None,
                now: Optional[float] = None, **payload) -> BlockEvent:
        """Emit one event.  ``now`` keeps the timestamp on the model clock
        under a simulated-clock driver (same convention as scheduler/
        registry ``now=`` everywhere else)."""
        if TRACER.enabled and "request_id" not in payload:
            # correlate events with the gateway request that caused them:
            # the request id rides the tracer's thread-local span stack
            # from the HTTP handler down into whatever publishes.  Inert
            # when tracing is off — the payload is byte-identical.
            rid = TRACER.current_request_id()
            if rid is not None:
                payload["request_id"] = rid
        with self._cond:
            self._seq += 1
            ev = BlockEvent(seq=self._seq,
                            t=now if now is not None else time.time(),
                            kind=kind, app_id=app_id, block_id=block_id,
                            user=user, payload=payload)
            self._history.append(ev)
            if app_id is not None:
                ring = self._per_app.get(app_id)
                if ring is None:
                    if len(self._per_app) >= self._max_app_rings:
                        stale = sorted(self._per_app,
                                       key=lambda a:
                                       self._per_app[a][-1].seq)
                        for a in stale[:max(1, len(stale) // 4)]:
                            del self._per_app[a]
                    ring = self._per_app[app_id] = collections.deque(
                        maxlen=self._per_block_history)
                ring.append(ev)
            subs = list(self._subs)
            self._cond.notify_all()
        for fn, kinds in subs:
            if kinds is None or kind in kinds:
                fn(ev)
        return ev

    # ----------------------------------------------------------- subscribe
    def subscribe(self, fn: Subscriber,
                  kinds: Optional[Set[str]] = None) -> Subscriber:
        """Register a callback (optionally filtered to ``kinds``); returns
        ``fn`` so callers can keep a handle for ``unsubscribe``."""
        with self._lock:
            self._subs.append((fn, set(kinds) if kinds else None))
        return fn

    def unsubscribe(self, fn: Subscriber) -> None:
        with self._lock:
            self._subs = [(f, k) for f, k in self._subs if f is not fn]

    # ------------------------------------------------------------- history
    @property
    def latest_seq(self) -> int:
        with self._lock:
            return self._seq

    def events_since(self, after_seq: int = 0,
                     app_id: Optional[str] = None,
                     kinds: Optional[Set[str]] = None,
                     limit: int = 1000) -> List[BlockEvent]:
        """Replay history after the cursor, optionally filtered to one
        application and/or a kind set.  Events older than the ring buffer
        are gone — clients that fall that far behind simply resume from
        what remains (the registry snapshot is the source of truth for
        *current* state).  Per-application queries read the block's own
        ring, so a busy neighbour cannot have evicted their events."""
        with self._lock:
            if app_id is not None:
                source = self._per_app.get(app_id, ())
            else:
                source = self._history
            out = [ev for ev in source
                   if ev.seq > after_seq
                   and (kinds is None or ev.kind in kinds)]
        return out[:limit]

    def wait(self, after_seq: int = 0, app_id: Optional[str] = None,
             kinds: Optional[Set[str]] = None, timeout: float = 10.0,
             limit: int = 1000) -> List[BlockEvent]:
        """Long-poll: return matching events newer than ``after_seq``,
        blocking up to ``timeout`` seconds for the first one.  Returns []
        on timeout — the HTTP feed turns that into an empty page and the
        client re-polls with the same cursor."""
        deadline = time.monotonic() + max(0.0, timeout)
        while True:
            evs = self.events_since(after_seq, app_id=app_id, kinds=kinds,
                                    limit=limit)
            if evs:
                return evs
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return []
            with self._cond:
                # re-check under the lock: a publish between events_since
                # and acquiring the condition must not be slept through
                if self._seq > after_seq and self.events_since(
                        after_seq, app_id=app_id, kinds=kinds, limit=1):
                    continue
                self._cond.wait(remaining)
