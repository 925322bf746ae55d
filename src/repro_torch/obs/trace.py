"""Distributed tracing — spans with trace/span/parent ids over one
process-global ``TRACER``.

Design constraints (why this is not a straight OpenTelemetry clone):

* **Inert by default.**  The control plane's deterministic inline mode
  and the ``policy_admission`` benchmark must be bit-identical with the
  tracer present.  A disabled tracer never reads a clock, never
  allocates a span and never takes a lock: ``span()`` returns one shared
  no-op object.  Hot loops additionally guard on ``TRACER.enabled`` so
  the disabled cost is a single attribute read.

* **Two propagation channels.**  Within a thread, spans nest through a
  thread-local stack (the gateway request span parents the daemon call
  span parents the scheduler decision span, all on the worker thread).
  Across threads — the daemon's command queue hands work from a gateway
  worker to the pump thread — the enqueuer captures ``context()`` into
  the ``Command`` and the pump re-attaches it, so the queue-wait and
  execution spans parent back to the originating request.

* **Block binding.**  A request is transient but a block lives on: the
  first span labeled with an ``app_id`` binds that block to its trace
  (``bind()``), and later spans for the block with no thread-local
  parent (engine rounds on the pump/pod-worker threads, decode rounds,
  post-resume activity) join the *bound* trace.  That is what makes a
  single ``generate`` request one connected trace across gateway →
  daemon queue → scheduler → engine → decode round, and what makes the
  trace context survive preempt/resume — the binding is keyed by
  ``app_id`` and outlives the runtime object.

Spans are kept in a bounded ring and exported as Chrome-trace JSON
(``{"traceEvents": [...]}``, ``ph: "X"`` complete events) which loads in
``chrome://tracing`` and Perfetto.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

#: (trace_id, parent_span_id) — what crosses a thread boundary
Context = Tuple[str, str]


@dataclasses.dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    cat: str
    t0: float                      # perf_counter at open
    t1: float = 0.0                # perf_counter at close
    tid: int = 0                   # opening thread id
    app_id: Optional[str] = None
    user: Optional[str] = None
    args: Dict = dataclasses.field(default_factory=dict)

    @property
    def dur_s(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def to_dict(self) -> Dict:
        d = {"trace_id": self.trace_id, "span_id": self.span_id,
             "parent_id": self.parent_id, "name": self.name,
             "cat": self.cat, "t0": self.t0, "t1": self.t1,
             "dur_s": self.dur_s, "tid": self.tid}
        if self.app_id is not None:
            d["app_id"] = self.app_id
        if self.user is not None:
            d["user"] = self.user
        if self.args:
            d["args"] = dict(self.args)
        return d


class _NoopSpan:
    """Shared do-nothing span: what a disabled tracer hands out.  Falsy,
    context-manager compatible, accepts the live span's surface."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **args):
        return self


_NOOP = _NoopSpan()


class _LiveSpan:
    """An open span: closes (and lands in the tracer ring) on __exit__."""

    __slots__ = ("tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self.tracer = tracer
        self.span = span

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.span.args.setdefault("error", repr(exc))
        self.tracer._close(self.span)
        return False

    def __bool__(self):
        return True

    def set(self, **args):
        self.span.args.update(args)
        return self


class Tracer:
    """Process-global span collector (see module docstring).  All public
    methods are safe to call with the tracer disabled — they no-op."""

    def __init__(self, max_spans: int = 16384):
        self.enabled = False
        self._lock = threading.Lock()
        self._spans: Deque[Span] = collections.deque(maxlen=max_spans)
        self._tls = threading.local()
        # itertools.count.__next__ is atomic under the GIL: id allocation
        # costs no lock on the span hot path
        self._ids = itertools.count(1)
        self._traces = itertools.count(1)
        #: app_id -> (trace_id, anchor span_id): the block's bound trace
        self._blocks: Dict[str, Context] = {}

    # ----------------------------------------------------------- lifecycle
    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop every recorded span, block binding and id counter (tests;
        the enabled flag is left as-is)."""
        with self._lock:
            self._spans.clear()
            self._blocks.clear()
            self._ids = itertools.count(1)
            self._traces = itertools.count(1)

    # ------------------------------------------------------------- plumbing
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _new_trace_id(self) -> str:
        return f"t{next(self._traces):012x}"

    def _new_span_id(self) -> str:
        return f"s{next(self._ids):012x}"

    def _close(self, span: Span) -> None:
        span.t1 = time.perf_counter()
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        else:                       # defensive: unbalanced exit
            try:
                st.remove(span)
            except ValueError:
                pass
        with self._lock:
            self._spans.append(span)

    # --------------------------------------------------------------- spans
    def span(self, name: str, cat: str = "span",
             app_id: Optional[str] = None, user: Optional[str] = None,
             ctx: Optional[Context] = None, t0: Optional[float] = None,
             parent: str = "auto", **args):
        """Open a span.  Parent resolution order: explicit ``ctx`` (a
        cross-thread handoff), the thread-local stack top, the block
        binding for ``app_id``, else a fresh trace root.
        ``parent="binding"`` flips the stack/binding priority: a span for
        a *bound* block joins the block's trace even when the opening
        thread already has a span stack (the engine's per-app dispatch
        runs under a round loop but must join the request trace that
        bound the block).  ``t0`` backdates the open (the pump starts the
        exec span at the exact instant the queue-wait span ends, so the
        two tile the enclosing call).  Returns a context manager (the
        shared no-op when disabled)."""
        if not self.enabled:
            return _NOOP
        st = self._stack()
        bound = self._blocks.get(app_id) if app_id is not None else None
        if ctx is not None:
            trace_id, parent_id = ctx
        elif parent == "binding" and bound is not None:
            trace_id, parent_id = bound
        elif st:
            trace_id, parent_id = st[-1].trace_id, st[-1].span_id
        elif bound is not None:
            trace_id, parent_id = bound
        else:
            trace_id, parent_id = self._new_trace_id(), None
        span = Span(trace_id=trace_id, span_id=self._new_span_id(),
                    parent_id=parent_id, name=name, cat=cat,
                    t0=t0 if t0 is not None else time.perf_counter(),
                    tid=threading.get_ident() % 100000,
                    app_id=app_id, user=user, args=dict(args) if args else {})
        if app_id is not None and app_id not in self._blocks:
            # first span for this block: bind the block to this trace so
            # later engine/decode activity (and post-resume spans) join it
            with self._lock:
                self._blocks.setdefault(app_id, (trace_id, span.span_id))
        st.append(span)
        return _LiveSpan(self, span)

    def record(self, name: str, t0: float, t1: float, cat: str = "span",
               ctx: Optional[Context] = None, app_id: Optional[str] = None,
               user: Optional[str] = None, **args) -> None:
        """Record an already-elapsed span from explicit ``perf_counter``
        endpoints (e.g. the daemon queue-wait measured between enqueue
        and pump claim — no thread ever 'holds' that span open)."""
        if not self.enabled:
            return
        trace_id, parent_id = ctx if ctx is not None else \
            (self._new_trace_id(), None)
        span = Span(trace_id=trace_id, span_id=self._new_span_id(),
                    parent_id=parent_id, name=name, cat=cat, t0=t0, t1=t1,
                    tid=threading.get_ident() % 100000,
                    app_id=app_id, user=user, args=dict(args) if args else {})
        with self._lock:
            self._spans.append(span)

    # ------------------------------------------------------------- context
    def context(self) -> Optional[Context]:
        """The current thread's trace context — what an enqueuer captures
        into a ``Command`` for the pump to ``attach``."""
        if not self.enabled:
            return None
        st = getattr(self._tls, "stack", None)
        if not st:
            return None
        return (st[-1].trace_id, st[-1].span_id)

    def current_request_id(self) -> Optional[str]:
        """The ``X-Request-ID`` carried by the innermost span that has one
        (the gateway stamps it on the request root span) — what the
        EventBus folds into event payloads as correlation metadata."""
        if not self.enabled:
            return None
        st = getattr(self._tls, "stack", None)
        if not st:
            return None
        for span in reversed(st):
            rid = span.args.get("request_id")
            if rid is not None:
                return rid
        return None

    def bind(self, app_id: str) -> None:
        """Bind ``app_id`` to the current thread's trace context (e.g. the
        generate command binds the serve block to the request's trace so
        its decode rounds join it)."""
        if not self.enabled:
            return
        ctx = self.context()
        if ctx is not None:
            with self._lock:
                self._blocks.setdefault(app_id, ctx)

    def block_trace(self, app_id: str) -> Optional[str]:
        """The trace id a block is bound to (stable across
        preempt/resume), or None."""
        bound = self._blocks.get(app_id)
        return bound[0] if bound else None

    # -------------------------------------------------------------- export
    def spans(self, app_id: Optional[str] = None,
              trace_id: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if app_id is not None:
            bound = self.block_trace(app_id)
            out = [s for s in out
                   if s.app_id == app_id
                   or (bound is not None and s.trace_id == bound)]
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def chrome_trace(self, app_id: Optional[str] = None,
                     trace_id: Optional[str] = None) -> Dict:
        """Chrome-trace/Perfetto JSON: one ``ph: "X"`` complete event per
        finished span, timestamps in microseconds on the tracer's own
        monotonic axis."""
        events = []
        for s in self.spans(app_id=app_id, trace_id=trace_id):
            args = {"trace_id": s.trace_id, "span_id": s.span_id}
            if s.parent_id:
                args["parent_id"] = s.parent_id
            if s.app_id:
                args["app_id"] = s.app_id
            if s.user:
                args["user"] = s.user
            args.update(s.args)
            events.append({"name": s.name, "cat": s.cat, "ph": "X",
                           "ts": round(s.t0 * 1e6, 3),
                           "dur": round(s.dur_s * 1e6, 3),
                           "pid": 1, "tid": s.tid, "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}


#: the process-global tracer every subsystem instruments against
TRACER = Tracer()
