"""Time-series metrics — counters, gauges, and log-bucket histograms in
one process-global ``REGISTRY``.

The hot-path cost model: every instrument update is one dict lookup plus
one arithmetic op under a single registry lock (uncontended in CPython:
acquire/release is ~100ns).  Histograms bucket by log2 of the value so a
record is an ``int.bit_length`` call, not a sort; quantiles (p50/p90/p99)
are reconstructed from bucket counts at render time, which is the cold
path (`GET /metrics` scrape or a dashboard poll).

Naming follows Prometheus conventions: ``repro_<subsystem>_<what>_<unit>``
with ``_total`` for counters, labels in ``{k="v"}`` form sorted by key.
The registry also keeps a bounded ring per series (``sample()``) so the
dashboard can draw sparklines without an external TSDB.
"""
from __future__ import annotations

import collections
import math
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

#: canonical label ordering inside a series key
Labels = Tuple[Tuple[str, str], ...]


def _labels(labels: Optional[Dict[str, str]]) -> Labels:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(labels: Labels) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class _Hist:
    """Log2-bucketed histogram over positive floats.

    Values are scaled to microseconds-resolution integers before
    bucketing so sub-millisecond latencies spread across buckets instead
    of collapsing into one.  Bucket ``i`` holds values in
    ``[2^(i-1), 2^i) µs``; quantiles interpolate within a bucket.
    """

    __slots__ = ("counts", "n", "total", "vmin", "vmax")

    SCALE = 1e6          # seconds -> µs
    NBUCKETS = 64

    def __init__(self):
        self.counts = [0] * self.NBUCKETS
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = 0.0

    def record(self, v: float) -> None:
        if v < 0.0:
            v = 0.0
        i = int(v * self.SCALE).bit_length()
        if i >= self.NBUCKETS:
            i = self.NBUCKETS - 1
        self.counts[i] += 1
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def quantile(self, q: float) -> float:
        """Approximate quantile in seconds (midpoint of the target
        log-bucket, clamped to the observed min/max)."""
        if self.n == 0:
            return 0.0
        target = q * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                lo = (2 ** (i - 1)) / self.SCALE if i > 0 else 0.0
                hi = (2 ** i) / self.SCALE
                mid = (lo + hi) / 2.0
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax

    def summary(self) -> Dict[str, float]:
        mean = self.total / self.n if self.n else 0.0
        return {"count": self.n, "sum": self.total, "mean": mean,
                "min": self.vmin if self.n else 0.0, "max": self.vmax,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Lock-cheap named counters/gauges/histograms plus per-series sample
    rings for dashboard sparklines.  Safe to use from any thread; never
    raises on the update path."""

    RING = 120           # sparkline samples kept per sampled series

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Labels], float] = {}
        self._gauges: Dict[Tuple[str, Labels], float] = {}
        self._hists: Dict[Tuple[str, Labels], _Hist] = {}
        self._help: Dict[str, str] = {}
        self._series: Dict[str, Deque[Tuple[float, float]]] = {}

    # ------------------------------------------------------------ describe
    def describe(self, name: str, help_text: str) -> None:
        with self._lock:
            self._help.setdefault(name, help_text)

    # ------------------------------------------------------------- updates
    def inc(self, name: str, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        key = (name, _labels(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges[(name, _labels(labels))] = float(value)

    def add_gauge(self, name: str, delta: float,
                  labels: Optional[Dict[str, str]] = None) -> float:
        """Atomic gauge increment/decrement (concurrent SSE streams both
        adjusting the stream count must not lose updates).  Clamps at
        zero and returns the new value."""
        key = (name, _labels(labels))
        with self._lock:
            v = max(0.0, self._gauges.get(key, 0.0) + delta)
            self._gauges[key] = v
            return v

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        key = (name, _labels(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Hist()
            h.record(value)

    def sample(self, series: str, value: float,
               now: Optional[float] = None) -> None:
        """Append a (t, value) point to a bounded dashboard series."""
        t = now if now is not None else time.time()
        with self._lock:
            ring = self._series.get(series)
            if ring is None:
                ring = self._series[series] = collections.deque(
                    maxlen=self.RING)
            ring.append((t, float(value)))

    # --------------------------------------------------------------- reads
    def counter_value(self, name: str,
                      labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._counters.get((name, _labels(labels)), 0.0)

    def counter_total(self, name: str) -> float:
        """Sum of a counter family across all label sets."""
        with self._lock:
            return sum(v for (n, _), v in self._counters.items()
                       if n == name)

    def gauge_value(self, name: str,
                    labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._gauges.get((name, _labels(labels)), 0.0)

    def hist_summary(self, name: str,
                     labels: Optional[Dict[str, str]] = None) -> Dict:
        with self._lock:
            h = self._hists.get((name, _labels(labels)))
            return h.summary() if h is not None else _Hist().summary()

    def series(self, name: Optional[str] = None) -> Dict[str, List]:
        """Sparkline series for the dashboard: name -> [[t, v], ...]."""
        with self._lock:
            if name is not None:
                ring = self._series.get(name, ())
                return {name: [list(p) for p in ring]}
            return {k: [list(p) for p in ring]
                    for k, ring in self._series.items()}

    def snapshot(self) -> Dict:
        """JSON-friendly dump (dashboard ``obs`` tile + tests)."""
        with self._lock:
            counters = {f"{n}{_fmt_labels(lb)}": v
                        for (n, lb), v in sorted(self._counters.items())}
            gauges = {f"{n}{_fmt_labels(lb)}": v
                      for (n, lb), v in sorted(self._gauges.items())}
            hists = {f"{n}{_fmt_labels(lb)}": h.summary()
                     for (n, lb), h in sorted(self._hists.items())}
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    # -------------------------------------------------------------- render
    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4).

        Histograms render as a ``_summary``-style family: ``_count``,
        ``_sum``, and ``{quantile="..."}`` gauge lines — scrapeable by
        any Prometheus-compatible agent without bucket-boundary
        negotiation.
        """
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = [(k, h.summary()) for k, h in sorted(self._hists.items())]
            helps = dict(self._help)
        out: List[str] = []
        seen_header = set()

        def header(name: str, mtype: str) -> None:
            if name in seen_header:
                return
            seen_header.add(name)
            htext = helps.get(name)
            if htext:
                out.append(f"# HELP {name} {htext}")
            out.append(f"# TYPE {name} {mtype}")

        for (name, lb), v in counters:
            header(name, "counter")
            out.append(f"{name}{_fmt_labels(lb)} {_num(v)}")
        for (name, lb), v in gauges:
            header(name, "gauge")
            out.append(f"{name}{_fmt_labels(lb)} {_num(v)}")
        for (name, lb), s in hists:
            header(name, "summary")
            base = _fmt_labels(lb)
            for q in ("0.5", "0.9", "0.99"):
                qkey = {"0.5": "p50", "0.9": "p90", "0.99": "p99"}[q]
                qlb = _fmt_labels(lb + (("quantile", q),))
                out.append(f"{name}{qlb} {_num(s[qkey])}")
            out.append(f"{name}_sum{base} {_num(s['sum'])}")
            out.append(f"{name}_count{base} {_num(s['count'])}")
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._series.clear()


def _num(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


#: the process-global registry every subsystem reports into
REGISTRY = MetricsRegistry()
