"""Observability: the span tracer (a copy of ``repro.obs.trace``)."""
