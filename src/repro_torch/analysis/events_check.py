"""Event-taxonomy checker.

``core/events.py`` declares the schema (``EVENT_KINDS``).  This pass
collects every *producer* literal (``bus.publish("kind", ...)``) and every
*consumer* reference:

* ``ev.kind == "x"`` / ``ev.kind in {...}`` comparisons (Monitor.on_event),
* literal ``kinds={...}`` sets passed to ``subscribe``/``events_since``/
  ``wait`` (SSE handlers, Monitor.subscribe_to),
* the dashboard's SSE subscription array in ``gateway/static/app.js``
  (regex scan — JS has no AST here).

Unknown kinds on either side are errors: a renamed kind can never again
silently orphan the dashboard or the Monitor's accounting.  A declared
kind that is never published, or that the dashboard does not subscribe
to, is a warning (advisory, does not gate CI).
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis._astutil import call_name, const_str
from repro_torch.analysis.report import Report

# kinds= consumers whose literal sets reference the taxonomy
_KIND_SINKS = {"subscribe", "events_since", "wait", "wait_events"}

# the dashboard subscribes in one loop: for (const kind of ["a", "b", ...])
_JS_KIND_ARRAY = re.compile(
    r"const\s+kind\s+of\s*\[([^\]]*)\]", re.MULTILINE)
_JS_STR = re.compile(r"[\"']([a-z_]+)[\"']")


def _declared_kinds() -> Set[str]:
    from repro_torch.core.events import EVENT_KINDS
    return set(EVENT_KINDS)


def _literal_strs(node: ast.AST) -> Optional[List[str]]:
    if isinstance(node, (ast.Set, ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            s = const_str(elt)
            if s is None:
                return None
            out.append(s)
        return out
    if isinstance(node, ast.Call) and call_name(node) in ("set", "frozenset") \
            and len(node.args) == 1:
        return _literal_strs(node.args[0])
    return None


def _qual_of(tree: ast.Module) -> Dict[int, str]:
    """lineno -> enclosing function qualname (best effort, for symbols)."""
    out: Dict[int, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(node):
                ln = getattr(sub, "lineno", None)
                if ln is not None and ln not in out:
                    out[ln] = node.name
    return out


def run(modules: Dict[str, ast.Module], js_files: List[Tuple[str, str]],
        report: Report) -> Dict[str, object]:
    declared = _declared_kinds()
    published: Dict[str, List[Tuple[str, int]]] = {}
    consumed: Dict[str, List[Tuple[str, int]]] = {}

    for path, tree in modules.items():
        quals = _qual_of(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                name = call_name(node)
                if name == "publish":
                    kind = const_str(node.args[0]) if node.args else None
                    if kind is None:
                        for kw in node.keywords:
                            if kw.arg == "kind":
                                kind = const_str(kw.value)
                    if kind is not None:
                        published.setdefault(kind, []).append(
                            (path, node.lineno))
                        if kind not in declared:
                            report.add(
                                "unknown-event-kind", path, node.lineno,
                                f"publish:{kind}",
                                f"publish({kind!r}) is not in EVENT_KINDS "
                                f"(core/events.py) — no consumer will ever "
                                f"see it; declare it or fix the name")
                if name in _KIND_SINKS:
                    for kw in node.keywords:
                        if kw.arg != "kinds":
                            continue
                        kinds = _literal_strs(kw.value)
                        for k in kinds or []:
                            consumed.setdefault(k, []).append(
                                (path, node.lineno))
                            if k not in declared:
                                report.add(
                                    "unknown-event-kind", path, node.lineno,
                                    f"{name}:kinds:{k}",
                                    f"{name}(kinds=...) filters on "
                                    f"{k!r}, which is not in EVENT_KINDS "
                                    f"— the filter can never match")
            elif isinstance(node, ast.Compare) and len(node.ops) == 1:
                # ev.kind == "x"  /  ev.kind in {"a", "b"} — only on
                # event-named receivers: ``job.kind`` (train|serve) and
                # other .kind fields are a different namespace
                left = node.left
                if not (isinstance(left, ast.Attribute)
                        and left.attr == "kind"
                        and isinstance(left.value, ast.Name)
                        and left.value.id in ("ev", "event", "evt")):
                    continue
                cmp_strs = ([const_str(node.comparators[0])]
                            if const_str(node.comparators[0]) is not None
                            else _literal_strs(node.comparators[0]))
                for k in cmp_strs or []:
                    if k is None:
                        continue
                    consumed.setdefault(k, []).append((path, node.lineno))
                    if k not in declared:
                        fn = quals.get(node.lineno, "?")
                        report.add(
                            "unknown-event-kind", path, node.lineno,
                            f"{fn}:kind=={k}",
                            f"{fn} matches ev.kind == {k!r}, which is not "
                            f"in EVENT_KINDS — dead consumer branch "
                            f"(renamed kind?)")

    dashboard: Set[str] = set()
    for js_path, js_src in js_files:
        arrays = _JS_KIND_ARRAY.findall(js_src)
        for arr in arrays:
            for m in _JS_STR.finditer(arr):
                k = m.group(1)
                dashboard.add(k)
                consumed.setdefault(k, []).append((js_path, 0))
                if k not in declared:
                    report.add(
                        "unknown-event-kind", js_path, 0,
                        f"dashboard:{k}",
                        f"the dashboard subscribes to SSE kind {k!r}, "
                        f"which is not in EVENT_KINDS — the stream will "
                        f"never deliver it (renamed kind orphaned the "
                        f"dashboard)")

    for k in sorted(declared - set(published)):
        report.add("unpublished-event-kind", "src/repro_torch/core/events.py", 0,
                   f"declared:{k}",
                   f"EVENT_KINDS declares {k!r} but no publish() literal "
                   f"emits it", severity="warning")
    if dashboard:
        for k in sorted(declared - dashboard):
            report.add("dashboard-kind-gap", js_files[0][0], 0,
                       f"dashboard-missing:{k}",
                       f"EVENT_KINDS declares {k!r} but the dashboard's "
                       f"SSE subscription loop does not include it",
                       severity="warning")

    return {
        "kinds": sorted(declared),
        "published": {k: len(v) for k, v in sorted(published.items())},
        "consumed": sorted(consumed),
        "dashboard": sorted(dashboard),
    }
