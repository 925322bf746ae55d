"""EventBus → MetricsRegistry translator.

``wire_bus(bus)`` subscribes one callback that turns the control plane's
semantic event stream into time-series metrics: every published event
increments ``repro_events_total{kind}``, and the kinds that carry
latencies or capacities additionally feed histograms/gauges.  The
translator never mutates control-plane state and never raises into the
publishing thread, so wiring it changes no scheduling decision —
deterministic inline mode stays bit-identical.

Label conventions (documented in docs/architecture.md): ``user`` for
per-tenant counters, ``pod`` for pod lifecycle, ``label`` for the
compile-cache block-family, ``action``/``state``/``reason`` for
enumerated outcomes.  High-cardinality ids (app_id, session) are never
labels — they live in traces and the flight recorder instead.
"""
from __future__ import annotations

from repro_torch.obs.metrics import REGISTRY

_DESCRIPTIONS = [
    ("repro_events_total", "Events published on the cluster bus by kind"),
    ("repro_steps_total", "Block steps recorded, by user"),
    ("repro_step_duration_seconds", "Per-step wall time reported by blocks"),
    ("repro_admission_wait_seconds",
     "Queue wait between enqueue and admission"),
    ("repro_admissions_total", "Admissions by path (immediate/queued/resume)"),
    ("repro_queue_depth", "Blocks currently waiting for admission"),
    ("repro_preemptions_total", "Blocks preempted, by user"),
    ("repro_block_state_total", "Block lifecycle transitions by state"),
    ("repro_block_failures_total", "Blocks that entered FAILED"),
    ("repro_chips_used", "Chips currently granted to running blocks"),
    ("repro_chips_total", "Chips known to the partitioner"),
    ("repro_compile_total", "Compile-cache lookups by action and family"),
    ("repro_pod_events_total", "Pod lifecycle events by action"),
    ("repro_sessions_total", "Serve session events by action"),
    ("repro_generate_tokens_total", "Tokens emitted by generate streams"),
    ("repro_migrations_total", "Cross-pod block migrations"),
    ("repro_postmortems_total", "Flight-recorder artifacts written"),
]


def wire_bus(bus, registry=None) -> None:
    """Attach the translator to ``bus``.  Idempotent per (bus, registry):
    double-wiring would double-count."""
    reg = registry if registry is not None else REGISTRY
    wired = getattr(bus, "_obs_bridge_wired", None)
    if wired is None:
        wired = bus._obs_bridge_wired = set()
    if id(reg) in wired:
        return
    wired.add(id(reg))
    for name, help_text in _DESCRIPTIONS:
        reg.describe(name, help_text)

    def on_event(ev) -> None:
        try:
            _translate(ev, reg)
        except Exception:
            pass        # metrics must never break the publishing thread

    bus.subscribe(on_event)


def _translate(ev, reg) -> None:
    p = ev.payload
    user = ev.user if ev.user is not None else "-"
    reg.inc("repro_events_total", labels={"kind": ev.kind})
    if ev.kind == "step":
        reg.inc("repro_steps_total", labels={"user": user})
        step_s = p.get("step_s")
        if step_s is not None:
            reg.observe("repro_step_duration_seconds", step_s,
                        labels={"user": user})
    elif ev.kind == "admitted":
        wait_s = p.get("wait_s")
        if wait_s is not None:
            reg.observe("repro_admission_wait_seconds", wait_s)
        path = ("immediate" if p.get("immediate")
                else "resume" if p.get("resumed") else "queued")
        reg.inc("repro_admissions_total", labels={"path": path})
    elif ev.kind == "enqueued":
        reg.add_gauge("repro_queue_depth", 1)
    elif ev.kind == "dequeued":
        reg.add_gauge("repro_queue_depth", -1)       # clamps at zero
    elif ev.kind == "preempted":
        reg.inc("repro_preemptions_total", labels={"user": user})
    elif ev.kind == "state":
        state = p.get("state")
        if state is not None:
            reg.inc("repro_block_state_total", labels={"state": state})
            if state == "failed":
                reg.inc("repro_block_failures_total")
    elif ev.kind == "utilization":
        used = p.get("used_chips")
        total = p.get("total_chips")
        if used is not None:
            reg.set_gauge("repro_chips_used", used)
            reg.sample("chips_used", used)
        if total is not None:
            reg.set_gauge("repro_chips_total", total)
    elif ev.kind == "compile":
        reg.inc("repro_compile_total",
                labels={"action": p.get("action") or "-",
                        "label": p.get("label") or "-"})
    elif ev.kind == "pod":
        reg.inc("repro_pod_events_total",
                labels={"action": p.get("action") or "-"})
    elif ev.kind == "session":
        reg.inc("repro_sessions_total",
                labels={"action": p.get("action") or "-"})
    elif ev.kind == "generate":
        # one generate event per emitted token (see engine._harvest_generate)
        reg.inc("repro_generate_tokens_total", labels={"user": user})
    elif ev.kind == "migrated":
        reg.inc("repro_migrations_total")
    elif ev.kind == "postmortem":
        reg.inc("repro_postmortems_total",
                labels={"reason": p.get("reason") or "-"})
