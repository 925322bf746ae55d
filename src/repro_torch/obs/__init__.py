"""Observability layer: distributed tracing, time-series metrics, and
flight-recorder postmortems for the whole control plane.

Three stdlib-only, inert-by-default components:

* ``trace.TRACER`` — a process-global tracer that opens spans with
  trace/span/parent ids and propagates a trace context along each
  request's whole path (gateway handler → daemon command queue →
  scheduler decision → engine round → runtime dispatch/harvest →
  decode round).  Disabled by default: a disabled tracer's ``span()``
  returns a shared no-op and records nothing, so inline deterministic
  mode and ``benchmarks/policy_admission.py`` stay bit-identical.
  Export is Chrome-trace/Perfetto JSON (``GET /v1/trace``).

* ``metrics.REGISTRY`` — a lock-cheap metrics registry (counters,
  gauges, log-bucket histograms with p50/p90/p99) rendered as
  Prometheus text at ``GET /metrics`` and as ring-buffered series
  backing the dashboard sparkline tiles.  Fed from the EventBus by
  ``bridge.wire_bus`` plus direct self-instrumentation of the daemon
  pump loop, engine rounds, SSE fan-out and the HTTP server.

* ``flight.RECORDER`` — a bounded ring of recent events + spans that
  dumps a postmortem JSON artifact automatically on block FAILED, pod
  death, or a daemon pump crash, downloadable via the gateway
  (``GET /v1/postmortems``).

The ``Monitor`` remains the semantic accountant (EWMAs, SLO outcomes,
federation totals); it is now one consumer of the event stream among
several rather than the only sink.
"""
from repro_torch.obs.bridge import wire_bus
from repro_torch.obs.flight import RECORDER, FlightRecorder
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.obs.trace import TRACER, Span, Tracer

__all__ = ["TRACER", "Tracer", "Span", "REGISTRY", "MetricsRegistry",
           "RECORDER", "FlightRecorder", "wire_bus"]
