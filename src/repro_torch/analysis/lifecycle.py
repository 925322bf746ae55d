"""Lifecycle-transition checker.

Resolves every ``Block.state`` assignment, ``mark_*``, ``transition`` and
``set_state`` call site against the ``TRANSITIONS`` table in
``core/block.py`` (imported — the table itself stays the single source of
truth) and flags:

* ``state-assign-bypass`` — a direct ``x.state = BlockState.X`` store
  anywhere but ``Block.transition`` (bypasses the runtime validator *and*
  the history log);
* ``illegal-transition-target`` — a literal target state that is not a
  target of *any* legal transition (e.g. ``REQUESTED``: nothing ever
  transitions back to it);
* ``illegal-transition-edge`` — a call site whose source state is pinned
  by a dominating membership guard (``assert x.state == S`` /
  ``if x.state not in (...): raise``) where some pinned source has no
  legal edge to the literal target.

The per-function fact tracking is linear and optimistic: facts survive
calls that are not themselves state changes (the codebase convention is
guard-then-transition inside one function), reset at loop entry (so the
``if blk.state is not RUNNING: continue`` pattern re-pins per iteration),
and merge by union across branches.  Unknown sources produce no finding —
this pass only flags what a guard *proves* wrong.
"""
from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from repro_torch.analysis._astutil import attr_chain, call_name
from repro_torch.analysis.report import Report

Facts = Dict[str, FrozenSet[str]]       # owner chain ("blk") -> possible states


def _table():
    from repro_torch.core.block import TRANSITIONS, BlockState
    legal = {(s.name, t.name) for s, ts in TRANSITIONS.items() for t in ts}
    states = {s.name for s in BlockState}
    targets = {t for _, t in legal}
    terminal = {s for s in states
                if not any(src == s for src, _ in legal)}
    return legal, states, targets, terminal


def _module_state_consts(tree: ast.Module) -> Dict[str, FrozenSet[str]]:
    """Module-level ``_TERMINAL = (BlockState.DONE, ...)`` style constants."""
    out: Dict[str, FrozenSet[str]] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            states = _state_ref(node.value, {})
            if states:
                out[node.targets[0].id] = states
    return out


def _state_ref(node: ast.AST,
               consts: Dict[str, FrozenSet[str]]) -> Optional[FrozenSet[str]]:
    """``BlockState.X`` / a module const / a literal tuple of either."""
    if isinstance(node, ast.Attribute):
        base = attr_chain(node)
        if base and len(base) >= 2 and base[-2] == "BlockState":
            return frozenset({node.attr})
        return None
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, (ast.Tuple, ast.Set, ast.List)):
        acc: Set[str] = set()
        for elt in node.elts:
            got = _state_ref(elt, consts)
            if got is None:
                return None
            acc |= got
        return frozenset(acc)
    return None


def _state_owner(node: ast.AST) -> Optional[str]:
    """``blk.state`` -> "blk"; ``self.apps[x].state`` -> None (not a pure
    chain — facts only track pure chains)."""
    chain = attr_chain(node)
    if chain and len(chain) >= 2 and chain[-1] == "state":
        return ".".join(chain[:-1])
    return None


def _parse_guard(test: ast.AST, consts: Dict[str, FrozenSet[str]]
                 ) -> Optional[Tuple[str, bool, FrozenSet[str]]]:
    """(owner, positive?, states) for a state-membership test, else None.

    positive=True: the test holds when owner.state IS in states.
    """
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        got = _parse_guard(test.operand, consts)
        if got:
            return (got[0], not got[1], got[2])
        return None
    if not isinstance(test, ast.Compare) or len(test.ops) != 1:
        return None
    owner = _state_owner(test.left)
    if owner is None:
        return None
    states = _state_ref(test.comparators[0], consts)
    if states is None:
        return None
    op = test.ops[0]
    if isinstance(op, (ast.Eq, ast.Is, ast.In)):
        return (owner, True, states)
    if isinstance(op, (ast.NotEq, ast.IsNot, ast.NotIn)):
        return (owner, False, states)
    return None


def _terminates(stmts: List[ast.stmt]) -> bool:
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, (ast.Raise, ast.Return, ast.Continue, ast.Break)):
        return True
    if isinstance(last, ast.If):
        return (_terminates(last.body)
                and bool(last.orelse) and _terminates(last.orelse))
    return False


class _FunctionChecker:
    def __init__(self, path: str, qual: str, consts: Dict[str, FrozenSet[str]],
                 legal: Set[Tuple[str, str]], targets: Set[str],
                 report: Report, allow_state_assign: bool):
        self.path = path
        self.qual = qual
        self.consts = consts
        self.legal = legal
        self.targets = targets
        self.report = report
        self.allow_state_assign = allow_state_assign

    # ------------------------------------------------------------- statements
    def walk_body(self, stmts: List[ast.stmt], facts: Facts) -> Facts:
        for stmt in stmts:
            facts = self.walk_stmt(stmt, facts)
        return facts

    def walk_stmt(self, stmt: ast.stmt, facts: Facts) -> Facts:
        if isinstance(stmt, ast.Assert):
            guard = _parse_guard(stmt.test, self.consts)
            if guard and guard[1]:
                facts = dict(facts)
                facts[guard[0]] = guard[2]
            return facts
        if isinstance(stmt, ast.If):
            return self._walk_if(stmt, facts)
        if isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
            # fresh fact scope per iteration: guards inside the loop re-pin
            # each pass; nothing survives the loop
            self.walk_body(stmt.body, {})
            self.walk_body(stmt.orelse, {})
            return {}
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self.walk_body(stmt.body, facts)
        if isinstance(stmt, ast.Try):
            self.walk_body(stmt.body, dict(facts))
            for h in stmt.handlers:
                self.walk_body(h.body, {})
            self.walk_body(stmt.orelse, {})
            self.walk_body(stmt.finalbody, {})
            return {}
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return facts            # nested defs are checked separately
        # leaf statement: process calls/stores in evaluation order
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                facts = self._handle_call(node, facts)
        if isinstance(stmt, ast.Assign):
            for target in stmt.targets:
                facts = self._handle_store(target, stmt.value, facts,
                                           stmt.lineno)
        return facts

    def _walk_if(self, stmt: ast.If, facts: Facts) -> Facts:
        guard = _parse_guard(stmt.test, self.consts)
        body_facts = dict(facts)
        else_facts = dict(facts)
        if guard:
            owner, positive, states = guard
            if positive:
                body_facts[owner] = states
            else:
                else_facts[owner] = states
        out_body = self.walk_body(stmt.body, body_facts)
        out_else = self.walk_body(stmt.orelse, else_facts) \
            if stmt.orelse else else_facts
        outs = []
        if not _terminates(stmt.body):
            outs.append(out_body)
        if not (stmt.orelse and _terminates(stmt.orelse)):
            outs.append(out_else)
        if not outs:
            return {}
        merged: Facts = {}
        for owner in outs[0]:
            if all(owner in o for o in outs):
                acc: Set[str] = set()
                for o in outs:
                    acc |= o[owner]
                merged[owner] = frozenset(acc)
        return merged

    # ------------------------------------------------------------------ sites
    def _handle_store(self, target: ast.AST, value: ast.AST, facts: Facts,
                      lineno: int) -> Facts:
        owner = _state_owner(target)
        if owner is None:
            return facts
        states = _state_ref(value, self.consts)
        if states is None and not isinstance(value, ast.Name):
            return facts            # not a state store we understand
        if not self.allow_state_assign:
            self.report.add(
                "state-assign-bypass", self.path, lineno,
                f"{self.qual}:{owner}.state",
                f"{self.qual} assigns {owner}.state directly — bypasses "
                f"Block.transition (no TRANSITIONS validation, no history "
                f"entry); call transition()/set_state() instead")
        facts = dict(facts)
        if states is not None:
            facts[owner] = states
        else:
            facts.pop(owner, None)
        return facts

    def _handle_call(self, call: ast.Call, facts: Facts) -> Facts:
        name = call_name(call)
        owner: Optional[str] = None
        target_node: Optional[ast.AST] = None
        if name == "transition":
            if isinstance(call.func, ast.Attribute):
                chain = attr_chain(call.func.value)
                owner = ".".join(chain) if chain else None
            target_node = call.args[0] if call.args else None
        elif name == "set_state":
            target_node = call.args[1] if len(call.args) > 1 else None
            if target_node is None:
                for kw in call.keywords:
                    if kw.arg == "state":
                        target_node = kw.value
        elif name == "mark_preempted":
            targets = frozenset({"PREEMPTED"})
            return self._check(call, owner, targets, facts)
        else:
            return facts
        if target_node is None:
            return facts
        targets = _state_ref(target_node, self.consts)
        if targets is None:
            # non-literal target (e.g. Registry.set_state forwarding its
            # parameter): state becomes unknown
            facts = dict(facts)
            if owner is not None:
                facts.pop(owner, None)
            else:
                facts = {}
            return facts
        return self._check(call, owner, targets, facts)

    def _check(self, call: ast.Call, owner: Optional[str],
               targets: FrozenSet[str], facts: Facts) -> Facts:
        for t in sorted(targets):
            if t not in self.targets:
                self.report.add(
                    "illegal-transition-target", self.path, call.lineno,
                    f"{self.qual}:{t}",
                    f"{self.qual} transitions to {t}, which is not a "
                    f"target of any legal transition in TRANSITIONS")
        src: Optional[FrozenSet[str]] = None
        src_owner = owner
        if owner is not None:
            src = facts.get(owner)
        elif len(facts) == 1:
            # set_state(app_id, ...) names the app, not the block object;
            # with exactly one pinned object in scope, attribute the call
            # to it (the repo's guard-then-transition convention)
            src_owner, src = next(iter(facts.items()))
        if src:
            for s in sorted(src):
                if not any((s, t) in self.legal for t in targets):
                    tnames = "/".join(sorted(targets))
                    self.report.add(
                        "illegal-transition-edge", self.path, call.lineno,
                        f"{self.qual}:{s}->{tnames}",
                        f"{self.qual}: a dominating guard pins the state "
                        f"to {s}, but {s} -> {tnames} is not in "
                        f"TRANSITIONS — this call can only raise")
        facts = dict(facts)
        if src_owner is not None:
            facts[src_owner] = targets
        else:
            facts = {}
        return facts


def run(modules: Dict[str, ast.Module], report: Report) -> Dict[str, object]:
    legal, states, targets, terminal = _table()
    for path, tree in modules.items():
        consts = _module_state_consts(tree)
        for cls, func in _iter_functions(tree):
            qual = f"{cls}.{func.name}" if cls else func.name
            allow = (cls == "Block" and func.name == "transition")
            checker = _FunctionChecker(path, qual, consts, legal, targets,
                                       report, allow)
            checker.walk_body(func.body, {})
    return {
        "states": sorted(states),
        "terminal": sorted(terminal),
        "transitions": sorted(f"{s} -> {t}" for s, t in legal),
    }


def _iter_functions(tree: ast.Module):
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield None, node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield node.name, item
