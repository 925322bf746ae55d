"""Pass orchestration: parse once, run every analyzer, return one report."""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import events_check, lifecycle, locks, rules
from repro_torch.analysis._astutil import iter_py_files, parse_module
from repro_torch.analysis.report import Report


def _find_js(paths: List[str]) -> List[Tuple[str, str]]:
    out = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".js"):
            with open(p, encoding="utf-8") as f:
                out.append((p, f.read()))
            continue
        if not os.path.isdir(p):
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git"))
            for f in sorted(files):
                if f.endswith(".js"):
                    full = os.path.join(root, f)
                    with open(full, encoding="utf-8") as fh:
                        out.append((full, fh.read()))
    return out


def analyze_paths(paths: List[str],
                  js_files: Optional[List[Tuple[str, str]]] = None
                  ) -> Tuple[Report, Dict[str, object]]:
    """Run all four passes over ``paths``.  ``js_files`` overrides the
    default scan for ``*.js`` under the given paths (tests)."""
    report = Report()
    modules: Dict[str, object] = {}
    sources: Dict[str, List[str]] = {}
    for path in iter_py_files(paths):
        tree, lines = parse_module(path)
        if tree is None:
            report.add("syntax-error", path, 0, "module",
                       "file does not parse; all passes skipped for it")
            continue
        modules[path] = tree
        sources[path] = lines
    model: Dict[str, object] = {}
    model["locks"] = locks.run(modules, sources, report)
    model["lifecycle"] = lifecycle.run(modules, report)
    if js_files is None:
        js_files = _find_js(paths)
    model["events"] = events_check.run(modules, js_files, report)
    rules.run(modules, report)
    return report, model
