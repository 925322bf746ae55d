"""Small shared AST helpers for the analysis passes (stdlib only)."""
from __future__ import annotations

import ast
import os
import re
from typing import Iterator, List, Optional, Tuple

# marker comment on (or one line above) a ``def`` whose body mutates
# lock-guarded state on behalf of callers that already hold the lock
CALLER_LOCK_MARKER = re.compile(r"#\s*lock:\s*caller")


def iter_py_files(paths: List[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def parse_module(path: str) -> Tuple[Optional[ast.Module], List[str]]:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        return ast.parse(src, filename=path), src.splitlines()
    except SyntaxError:
        return None, src.splitlines()


def attr_chain(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """``self.ctl.registry._lock`` -> ("self","ctl","registry","_lock").

    Returns None for anything that is not a pure Name/Attribute chain
    (calls, subscripts, literals...).
    """
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def store_root(node: ast.AST) -> Tuple[Optional[Tuple[str, ...]], bool]:
    """Resolve an assignment *target* down to its rooted chain.

    Peels Subscript/Attribute layers: ``self.chips[c].owner`` roots at
    ``("self", "chips")``.  Second element is True when the chain passes
    through a Call (``self._get(x).attr = ...`` — a store through a helper
    call's result), in which case the returned chain is the *callee* chain
    (``("self", "_get")``).
    """
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Call):
                return attr_chain(node.value.func), True
            chain = attr_chain(node)
            if chain is not None:
                return chain, False      # pure chain from here down
            node = node.value            # impure (subscript below): peel
        else:
            break
    return attr_chain(node), False


def call_name(node: ast.Call) -> Optional[str]:
    """Last path component of the called function, if statically nameable."""
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return None


def ctor_class(node: ast.AST) -> Optional[str]:
    """``ClassName(...)`` (possibly inside ``x or ClassName(...)``) -> name."""
    if isinstance(node, ast.BoolOp):
        for v in node.values:
            got = ctor_class(v)
            if got:
                return got
        return None
    if isinstance(node, ast.Call):
        chain = attr_chain(node.func)
        if chain:
            return chain[-1]
    return None


def has_caller_lock_marker(lines: List[str], node: ast.AST) -> bool:
    """True if the def line or the line above carries ``# lock: caller``."""
    lineno = getattr(node, "lineno", 0)
    for i in (lineno - 1, lineno - 2):          # 0-indexed def line, line above
        if 0 <= i < len(lines) and CALLER_LOCK_MARKER.search(lines[i]):
            return True
    return False


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
