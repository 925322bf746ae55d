"""Static-analysis + runtime-verification subsystem for the control plane.

The multi-block control plane (registry, partitioner, monitor, event bus,
daemon pump, gateway threads) is correct only under three conventions that
nothing used to check mechanically:

* **lock discipline** — every attribute a class mutates under ``with
  self._lock:`` must *only* be mutated under that lock (``locks``), and
  cross-object lock acquisition must stay acyclic (``locks``, lock-order
  graph);
* **lifecycle discipline** — every block-state change goes through
  ``Block.transition`` and respects the ``TRANSITIONS`` table
  (``lifecycle``);
* **event taxonomy** — every ``bus.publish(kind, ...)`` literal, every
  consumer match and the dashboard's SSE subscription list agree with the
  declared ``EVENT_KINDS`` schema (``events_check``).

``rules`` adds a repo-specific lint pack (falsy-zero model-time bug class).
``runtime_check`` is the dynamic companion: under ``REPRO_RACE_CHECK=1`` it
wraps ``threading.Lock``/``RLock`` with an acquisition-order recorder plus
deadlock-cycle detector, and asserts single-entrancy of daemon-serialized
sections, so the whole test suite doubles as a race-detection corpus.

Zero external dependencies — stdlib ``ast`` only.  Entry point::

    python -m repro_torch.analysis [paths] [--json out.json] [--describe]

Findings diff against ``analysis/baseline.json`` (kept empty: the repo is
clean); any non-baseline finding exits non-zero, which is the CI gate.
"""
from repro_torch.analysis.report import Finding, Report, load_baseline  # noqa: F401
from repro_torch.analysis.run import analyze_paths  # noqa: F401
