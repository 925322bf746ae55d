"""Lock-discipline linter + cross-module lock-order graph.

Discipline (per class):
  * every attribute that is ever mutated inside ``with self._lock:`` is
    *learned* as guarded by that lock (``threading.Condition(self._lock)``
    aliases back to the lock it wraps);
  * any mutation of a learned attribute outside the lock — except in
    ``__init__``/``__new__``, and except in helpers annotated with a
    ``# lock: caller`` marker whose callers hold the lock — is a finding;
  * an attribute mutated under two *disjoint* lock sets is "inconsistently
    guarded" (no single lock protects it);
  * a store through a helper-call result (``self._get(x).attr = ...``) in a
    lock-owning class, outside any lock, is a finding: the helper's lock was
    already released when the store lands.

Order (global):
  * a lock is identified as ``Class.attr``; acquiring B (directly or via
    any resolvable call chain) while holding A adds edge A->B;
  * receiver types resolve through ``self.x = ClassName(...)`` assignments,
    local aliases, and a global attr-name fallback (an attr name constructed
    as exactly one class anywhere, e.g. ``bus`` -> EventBus, covers
    dependency-injected ``self.bus = bus``);
  * any cycle in the edge set is a deadlock-by-convention finding; nested
    acquisition of a *non-reentrant* ``threading.Lock`` with itself is a
    self-deadlock finding.
"""
from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from repro_torch.analysis._astutil import (attr_chain, call_name, ctor_class,
                                     has_caller_lock_marker, store_root)
from repro_torch.analysis.report import Report

_LOCK_CTORS = {"Lock", "RLock"}
_EXEMPT_METHODS = {"__init__", "__new__"}
# method names that mutate their receiver (list/dict/set/deque mutators)
_MUTATORS = {"append", "appendleft", "extend", "insert", "remove", "pop",
             "popleft", "popitem", "clear", "update", "setdefault", "add",
             "discard", "sort", "reverse", "put", "put_nowait"}

LockId = Tuple[str, str]            # (ClassName, lock attr)


class MutationSite:
    __slots__ = ("attr", "held", "func", "lineno", "through_call")

    def __init__(self, attr: str, held: FrozenSet[str], func: str,
                 lineno: int, through_call: bool = False):
        self.attr = attr
        self.held = held
        self.func = func
        self.lineno = lineno
        self.through_call = through_call


class ClassModel:
    def __init__(self, name: str, path: str, node: ast.ClassDef):
        self.name = name
        self.path = path
        self.node = node
        self.methods: Dict[str, ast.FunctionDef] = {}
        self.lock_attrs: Dict[str, str] = {}      # attr -> "Lock"|"RLock"
        self.aliases: Dict[str, str] = {}         # Condition attr -> lock attr
        self.attr_types: Dict[str, str] = {}      # attr -> constructed class
        self.mutations: List[MutationSite] = []
        self.marked_caller_locked: Set[str] = set()

    def canon(self, attr: str) -> str:
        return self.aliases.get(attr, attr)


def _collect_methods(cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    out: Dict[str, ast.FunctionDef] = {}
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[item.name] = item
    return out


def _scan_class_decls(model: ClassModel) -> None:
    """Find lock attributes, Condition aliases and constructed attr types."""
    for meth in model.methods.values():
        for node in ast.walk(meth):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            chain = attr_chain(node.targets[0])
            if not chain or len(chain) != 2 or chain[0] != "self":
                continue
            attr = chain[1]
            if isinstance(node.value, ast.Call):
                fname = call_name(node.value)
                if fname in _LOCK_CTORS:
                    model.lock_attrs[attr] = fname
                    continue
                if fname == "Condition":
                    if node.value.args:
                        inner = attr_chain(node.value.args[0])
                        if inner and len(inner) == 2 and inner[0] == "self":
                            model.aliases[attr] = inner[1]
                            continue
                    # a Condition owning its private lock is itself a lock
                    model.lock_attrs[attr] = "RLock"
                    continue
            ctor = ctor_class(node.value)
            if ctor:
                model.attr_types[attr] = ctor


class _MutationScanner(ast.NodeVisitor):
    """Walks one method body tracking the lexical ``with self.<lock>`` stack
    and recording every mutation rooted at a ``self`` attribute."""

    def __init__(self, model: ClassModel, func_name: str):
        self.model = model
        self.func = func_name
        self.held: List[str] = []

    # ---- held-lock tracking
    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            chain = attr_chain(item.context_expr)
            if chain and len(chain) == 2 and chain[0] == "self":
                attr = self.model.canon(chain[1])
                if attr in self.model.lock_attrs:
                    acquired.append(attr)
        self.held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        if acquired:
            del self.held[len(self.held) - len(acquired):]

    # ---- mutation forms
    def _record_target(self, target: ast.AST, lineno: int) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_target(elt, lineno)
            return
        chain, through_call = store_root(target)
        if not chain or chain[0] != "self" or len(chain) < 2:
            return
        attr = chain[1]
        if not through_call and attr in self.model.lock_attrs:
            return                   # assigning the lock object itself
        if not through_call and attr in self.model.aliases:
            return
        self.model.mutations.append(MutationSite(
            attr, frozenset(self.held), self.func, lineno, through_call))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record_target(t, node.lineno)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_target(node.target, node.lineno)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_target(node.target, node.lineno)
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._record_target(t, node.lineno)

    def visit_Call(self, node: ast.Call) -> None:
        name = call_name(node)
        if name in _MUTATORS and isinstance(node.func, ast.Attribute):
            chain, through_call = store_root(node.func.value)
            if (chain and chain[0] == "self" and len(chain) >= 2
                    and not through_call):
                attr = chain[1]
                if (attr not in self.model.lock_attrs
                        and attr not in self.model.aliases):
                    self.model.mutations.append(MutationSite(
                        attr, frozenset(self.held), self.func, node.lineno))
        self.generic_visit(node)

    # nested defs inherit the lexical held stack (closures run where called,
    # but in this codebase nested defs are jit'd step fns, not lock users)
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        for stmt in node.body:
            self.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef


def build_class_models(modules: Dict[str, ast.Module],
                       sources: Dict[str, List[str]]
                       ) -> Dict[str, ClassModel]:
    models: Dict[str, ClassModel] = {}
    for path, tree in modules.items():
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            model = ClassModel(node.name, path, node)
            model.methods = _collect_methods(node)
            _scan_class_decls(model)
            lines = sources.get(path, [])
            for mname, meth in model.methods.items():
                if has_caller_lock_marker(lines, meth):
                    model.marked_caller_locked.add(mname)
                sc = _MutationScanner(model, mname)
                for stmt in meth.body:
                    sc.visit(stmt)
            models[node.name] = model
    return models


def check_discipline(models: Dict[str, ClassModel], report: Report) -> Dict:
    """Learn guarded attrs, flag unguarded mutations.  Returns the learned
    model (class -> attr -> guard set) for --describe / docs."""
    learned_all: Dict[str, Dict[str, List[str]]] = {}
    for model in models.values():
        if not model.lock_attrs:
            continue
        guards: Dict[str, Optional[FrozenSet[str]]] = {}
        for m in model.mutations:
            if m.through_call or not m.held:
                continue
            prev = guards.get(m.attr)
            guards[m.attr] = m.held if prev is None else (prev & m.held)
        learned_all[model.name] = {
            a: sorted(g) for a, g in sorted(guards.items()) if g}
        for attr, guard in sorted(guards.items()):
            if guard is not None and not guard:
                sites = sorted({(m.func, m.lineno) for m in model.mutations
                                if m.attr == attr and m.held})
                report.add(
                    "lock-inconsistent-guard", model.path, sites[0][1],
                    f"{model.name}.{attr}",
                    f"{model.name}.{attr} is mutated under disjoint lock "
                    f"sets ({', '.join(f'{f}:{l}' for f, l in sites)}) — "
                    f"no single lock protects it")
        for m in model.mutations:
            if m.func in _EXEMPT_METHODS:
                continue
            if m.func in model.marked_caller_locked:
                continue
            if m.through_call:
                if not m.held:
                    report.add(
                        "lock-discipline", model.path, m.lineno,
                        f"{model.name}.{m.func}:{m.attr}()",
                        f"{model.name}.{m.func} stores through "
                        f"self.{m.attr}(...) outside any lock — the "
                        f"helper's lock is already released when the "
                        f"store lands")
                continue
            guard = guards.get(m.attr)
            if not guard:
                continue
            if not (m.held & guard):
                locks = "/".join(sorted(f"self.{g}" for g in guard))
                report.add(
                    "lock-discipline", model.path, m.lineno,
                    f"{model.name}.{m.func}:{m.attr}",
                    f"{model.name}.{m.func} mutates self.{m.attr} without "
                    f"holding {locks} (guarded at every other mutation "
                    f"site)")
    return learned_all


# --------------------------------------------------------------- lock order
class _TypeEnv:
    """Best-effort receiver-type resolution for lock/call chains."""

    def __init__(self, models: Dict[str, ClassModel]):
        self.models = models
        # attr-name fallback: attr constructed as exactly one class anywhere
        counts: Dict[str, Set[str]] = {}
        for m in models.values():
            for attr, cls in m.attr_types.items():
                if cls in models:
                    counts.setdefault(attr, set()).add(cls)
        self.fallback = {a: next(iter(cs)) for a, cs in counts.items()
                         if len(cs) == 1}

    def resolve_chain(self, chain: Tuple[str, ...], cls: Optional[str],
                      local_types: Dict[str, str]) -> Optional[str]:
        """Type of the object the chain denotes, or None."""
        if not chain:
            return None
        head, rest = chain[0], chain[1:]
        if head == "self" and cls:
            cur: Optional[str] = cls
        else:
            cur = local_types.get(head) or self.fallback.get(head)
        for attr in rest:
            if cur is None:
                return None
            model = self.models.get(cur)
            nxt = model.attr_types.get(attr) if model else None
            cur = nxt or self.fallback.get(attr)
        return cur

    def lock_at(self, chain: Tuple[str, ...], cls: Optional[str],
                local_types: Dict[str, str]) -> Optional[LockId]:
        """If the chain denotes a lock attribute, its global id."""
        if len(chain) < 2:
            return None
        owner = self.resolve_chain(chain[:-1], cls, local_types)
        model = self.models.get(owner) if owner else None
        if model is None:
            return None
        attr = model.canon(chain[-1])
        if attr in model.lock_attrs:
            return (owner, attr)
        return None


def _local_types(func: ast.FunctionDef, cls: Optional[str],
                 env: _TypeEnv) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            ctor = ctor_class(node.value)
            if ctor and ctor in env.models:
                out[name] = ctor
                continue
            chain = attr_chain(node.value)
            if chain:
                t = env.resolve_chain(chain, cls, out)
                if t:
                    out[name] = t
    # parameters fall back by name (e.g. ``ctl`` -> ClusterController)
    for arg in func.args.args + func.args.kwonlyargs:
        if arg.arg != "self" and arg.arg not in out:
            t = env.fallback.get(arg.arg)
            if t:
                out[arg.arg] = t
    return out


class _FuncInfo:
    __slots__ = ("node", "cls", "path", "local_types")

    def __init__(self, node, cls, path, local_types):
        self.node = node
        self.cls = cls
        self.path = path
        self.local_types = local_types


def _collect_functions(modules: Dict[str, ast.Module],
                       models: Dict[str, ClassModel], env: _TypeEnv
                       ) -> Dict[Tuple[Optional[str], str], _FuncInfo]:
    funcs: Dict[Tuple[Optional[str], str], _FuncInfo] = {}
    for path, tree in modules.items():
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs[(None, node.name)] = _FuncInfo(
                    node, None, path, _local_types(node, None, env))
    for model in models.values():
        for mname, meth in model.methods.items():
            funcs[(model.name, mname)] = _FuncInfo(
                meth, model.name, model.path,
                _local_types(meth, model.name, env))
    return funcs


def _callees(info: _FuncInfo, env: _TypeEnv,
             funcs: Dict[Tuple[Optional[str], str], _FuncInfo]
             ) -> List[Tuple[Optional[str], str]]:
    out = []
    for node in ast.walk(info.node):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute):
            recv = attr_chain(node.func.value)
            if recv is None:
                continue
            owner = env.resolve_chain(recv, info.cls, info.local_types)
            if owner and (owner, node.func.attr) in funcs:
                out.append((owner, node.func.attr))
        elif isinstance(node.func, ast.Name):
            if (None, node.func.id) in funcs:
                out.append((None, node.func.id))
    return out


def build_lock_order(modules: Dict[str, ast.Module],
                     models: Dict[str, ClassModel], report: Report
                     ) -> Dict[str, object]:
    env = _TypeEnv(models)
    funcs = _collect_functions(modules, models, env)
    call_graph = {k: _callees(info, env, funcs)
                  for k, info in funcs.items()}

    # fixpoint: locks each function may acquire (directly or transitively)
    summary: Dict[Tuple[Optional[str], str], Set[LockId]] = {
        k: set() for k in funcs}
    for k, info in funcs.items():
        for node in ast.walk(info.node):
            if isinstance(node, ast.With):
                for item in node.items:
                    chain = attr_chain(item.context_expr)
                    if chain:
                        lk = env.lock_at(chain, info.cls, info.local_types)
                        if lk:
                            summary[k].add(lk)
    changed = True
    while changed:
        changed = False
        for k in funcs:
            for callee in call_graph[k]:
                before = len(summary[k])
                summary[k] |= summary[callee]
                if len(summary[k]) != before:
                    changed = True

    # edge pass: while holding H, every direct with + resolvable call
    edges: Dict[Tuple[LockId, LockId], Tuple[str, int]] = {}

    def walk(node: ast.AST, held: List[LockId], info: _FuncInfo) -> None:
        if isinstance(node, ast.With):
            acquired = []
            for item in node.items:
                chain = attr_chain(item.context_expr)
                lk = (env.lock_at(chain, info.cls, info.local_types)
                      if chain else None)
                if lk:
                    for h in held:
                        if h != lk:
                            edges.setdefault((h, lk),
                                             (info.path, node.lineno))
                        elif _kind(models, lk) == "Lock":
                            report.add(
                                "lock-self-deadlock", info.path, node.lineno,
                                f"{lk[0]}.{lk[1]}",
                                f"nested acquisition of non-reentrant "
                                f"{lk[0]}.{lk[1]} deadlocks")
                    acquired.append(lk)
            held = held + acquired
            for stmt in node.body:
                walk(stmt, held, info)
            return
        if isinstance(node, ast.Call) and held:
            target = None
            if isinstance(node.func, ast.Attribute):
                recv = attr_chain(node.func.value)
                if recv is not None:
                    owner = env.resolve_chain(recv, info.cls,
                                              info.local_types)
                    if owner and (owner, node.func.attr) in funcs:
                        target = (owner, node.func.attr)
            elif isinstance(node.func, ast.Name):
                if (None, node.func.id) in funcs:
                    target = (None, node.func.id)
            if target:
                for lk in summary[target]:
                    for h in held:
                        if h != lk:
                            edges.setdefault((h, lk),
                                             (info.path, node.lineno))
                        elif _kind(models, lk) == "Lock":
                            report.add(
                                "lock-self-deadlock", info.path,
                                node.lineno, f"{lk[0]}.{lk[1]}",
                                f"{target[0]}.{target[1]} re-acquires "
                                f"non-reentrant {lk[0]}.{lk[1]} already "
                                f"held here — deadlocks")
        for child in ast.iter_child_nodes(node):
            walk(child, held, info)

    for info in funcs.values():
        for stmt in info.node.body:
            walk(stmt, [], info)

    _report_cycles(edges, report)
    return {
        "locks": sorted(f"{c}.{a}" for c, m in models.items()
                        for a in m.lock_attrs),
        "edges": sorted(f"{a[0]}.{a[1]} -> {b[0]}.{b[1]}"
                        for (a, b) in edges),
    }


def _kind(models: Dict[str, ClassModel], lk: LockId) -> str:
    m = models.get(lk[0])
    return m.lock_attrs.get(lk[1], "RLock") if m else "RLock"


def _report_cycles(edges: Dict[Tuple[LockId, LockId], Tuple[str, int]],
                   report: Report) -> None:
    adj: Dict[LockId, List[LockId]] = {}
    for (a, b) in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    seen_cycles: Set[Tuple[LockId, ...]] = set()
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in adj}
    stack: List[LockId] = []

    def dfs(n: LockId) -> None:
        color[n] = GREY
        stack.append(n)
        for m in sorted(adj[n]):
            if color[m] == GREY:
                cyc = tuple(stack[stack.index(m):])
                i = cyc.index(min(cyc))
                canon = cyc[i:] + cyc[:i]
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    path, line = edges[(n, m)]
                    names = " -> ".join(f"{c}.{a}" for c, a in canon)
                    report.add(
                        "lock-order-cycle", path, line,
                        "->".join(f"{c}.{a}" for c, a in canon),
                        f"lock-order cycle: {names} -> {canon[0][0]}."
                        f"{canon[0][1]} — threads taking these locks in "
                        f"different orders can deadlock")
            elif color[m] == WHITE:
                dfs(m)
        stack.pop()
        color[n] = BLACK

    for n in sorted(adj):
        if color[n] == WHITE:
            dfs(n)


def run(modules: Dict[str, ast.Module], sources: Dict[str, List[str]],
        report: Report) -> Dict[str, object]:
    models = build_class_models(modules, sources)
    learned = check_discipline(models, report)
    order = build_lock_order(modules, models, report)
    return {"guarded": learned, **order}
