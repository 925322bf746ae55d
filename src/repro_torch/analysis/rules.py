"""Repo-specific lint rule pack.

Rule ``falsy-zero-param``: the model-time convention passes ``now=None``
everywhere and substitutes the wall clock with ``now if now is not None
else time.time()``.  The recurring bug (fixed at least three times across
PRs 1-5 in ``pump``/``dead_blocks``/``expired``/``run_round``) is the
truthiness shortcut — ``if now:`` / ``now or time.time()`` — which
silently swaps wall clock in at model time 0.0 and corrupts every duration
derived from it.  The same falsy-zero trap applies to the other
``None``-defaulted numeric knobs where 0 is a meaningful value
(``max_rate_hz=0.0`` is "paused", ``max_inflight=0`` is "dispatch
nothing").  This rule flags any truthiness test of those parameters;
``is (not) None`` comparisons are the sanctioned form and never flagged.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from repro_torch.analysis.report import Report

# parameter names where 0/0.0 is a legal value distinct from None
_SUSPECT_PARAMS = {"now", "until_t", "deadline_at", "queued_at",
                   "enqueued_at", "max_rate_hz", "max_inflight"}


def _suspect_args(func: ast.FunctionDef) -> List[str]:
    args = func.args
    names = [a.arg for a in args.args + args.kwonlyargs + args.posonlyargs]
    return [n for n in names if n in _SUSPECT_PARAMS]


class _TruthinessScanner(ast.NodeVisitor):
    def __init__(self, suspects: List[str]):
        self.suspects = set(suspects)
        self.hits: List[ast.Name] = []   # bare-name truthiness uses
        # a reassignment like ``now = now if now is not None else ...``
        # retires the suspect: after it, ``now`` is a plain float
        self.retired: set = set()

    def _flag(self, node: ast.AST) -> None:
        if isinstance(node, ast.Name) and node.id in self.suspects \
                and node.id not in self.retired:
            self.hits.append(node)

    def visit_If(self, node: ast.If) -> None:
        self._flag(node.test)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._flag(node.test)
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._flag(node.test)
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._flag(node.test)
        self.generic_visit(node)

    def visit_UnaryOp(self, node: ast.UnaryOp) -> None:
        if isinstance(node.op, ast.Not):
            self._flag(node.operand)
        self.generic_visit(node)

    def visit_BoolOp(self, node: ast.BoolOp) -> None:
        # ``now or time.time()`` — any bare suspect in an and/or chain is
        # a truthiness use, whether as condition or value-select
        for v in node.values:
            self._flag(v)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id in self.suspects:
                self.retired.add(t.id)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        return          # nested defs get their own scan

    visit_AsyncFunctionDef = visit_FunctionDef


def run(modules: Dict[str, ast.Module], report: Report) -> None:
    for path, tree in modules.items():
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            suspects = _suspect_args(node)
            if not suspects:
                continue
            scanner = _TruthinessScanner(suspects)
            for stmt in node.body:
                scanner.visit(stmt)
            for hit in scanner.hits:
                report.add(
                    "falsy-zero-param", path, hit.lineno,
                    f"{node.name}:{hit.id}",
                    f"{node.name} tests parameter {hit.id!r} for "
                    f"truthiness — 0/0.0 is a legal value here (model "
                    f"time zero / paused / no dispatch) and falls through "
                    f"to the default; use '{hit.id} is not None'")
