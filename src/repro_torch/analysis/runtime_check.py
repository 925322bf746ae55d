"""Runtime race detection: lock-order recording + serialized-section
ownership assertions.

Activated by ``REPRO_RACE_CHECK=1`` (tests/conftest.py installs it for the
whole pytest session), so every existing daemon/engine/gateway test doubles
as a race-detection corpus:

* :func:`install` replaces ``threading.Lock``/``threading.RLock`` with
  instrumented factories.  Each lock is named by its *creation site*
  (module:function:line), so every ``Registry.__init__`` lock aggregates to
  one node no matter how many registries a test builds.  Per-thread
  acquisition stacks record an order edge A->B whenever B is acquired while
  A is held; an edge that closes a cycle in the global order graph is a
  violation (two threads taking those locks in opposite orders can
  deadlock), as is re-acquiring a held *non-reentrant* lock (self-deadlock).
* :func:`serialized` marks the daemon-serialized sections (scheduler pump,
  engine round, daemon command execution).  The daemon architecture
  guarantees at most one thread inside any of them at a time; two distinct
  threads concurrently inside the same named section means some mutation
  path bypassed the command queue — a violation.

Everything records and keeps going (the suite should finish and report all
violations, not die at the first), and the fixture in conftest asserts the
session ended clean.  Unit tests exercise a private :class:`Recorder`, so
deliberately-seeded violations never pollute the session gate.

Condition-variable note: the instrumented lock forwards ``_is_owned`` /
``_release_save`` / ``_acquire_restore`` straight to the real lock, so
``threading.Condition(instrumented)`` works; during a ``wait()`` the
bookkeeping still shows the waiter holding the lock, which is harmless — a
blocked thread records no new edges.
"""
from __future__ import annotations

import functools
import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

_real_Lock = threading.Lock
_real_RLock = threading.RLock

ENV_FLAG = "REPRO_RACE_CHECK"


def enabled() -> bool:
    return os.environ.get(ENV_FLAG) == "1"


class Recorder:
    """Order graph + violation log.  One global instance backs install();
    tests build private ones via :func:`make_lock` / :func:`serialized`."""

    def __init__(self) -> None:
        self._meta = _real_Lock()           # guards everything below
        self.edges: Dict[str, Set[str]] = {}
        self.edge_sites: Dict[Tuple[str, str], str] = {}
        self.violations: List[str] = []
        self._tls = threading.local()
        self._sections: Dict[str, Tuple[int, int]] = {}  # name->(owner,depth)

    # ------------------------------------------------------------- held stack
    def _stack(self) -> List["InstrumentedLock"]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # ------------------------------------------------------------ acquisition
    def before_acquire(self, lock: "InstrumentedLock") -> None:
        stack = self._stack()
        if any(h is lock for h in stack):
            if not lock.reentrant:
                self.record(
                    f"self-deadlock: thread "
                    f"{threading.current_thread().name!r} re-acquired "
                    f"non-reentrant lock {lock.name} it already holds")
            return
        if not stack:
            return
        with self._meta:
            for held in stack:
                a, b = held.name, lock.name
                if a == b:
                    continue
                if b not in self.edges.setdefault(a, set()):
                    # adding a->b: a path b ~> a would close a cycle
                    path = self._path(b, a)
                    self.edges[a].add(b)
                    self.edge_sites[(a, b)] = threading.current_thread().name
                    if path is not None:
                        chain = " -> ".join(path + [b])
                        self.record(
                            f"lock-order inversion: acquiring {b} while "
                            f"holding {a}, but the reverse order "
                            f"{chain} was also observed — threads taking "
                            f"these locks in opposite orders can deadlock",
                            locked=True)

    def after_acquire(self, lock: "InstrumentedLock") -> None:
        self._stack().append(lock)

    def after_release(self, lock: "InstrumentedLock") -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lock:
                del stack[i]
                break

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src ~> dst in the current edge graph (caller holds
        _meta).  Returns the node list or None."""
        seen = {src}
        todo: List[Tuple[str, List[str]]] = [(src, [src])]
        while todo:
            node, path = todo.pop()
            if node == dst:
                return path
            for nxt in self.edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    todo.append((nxt, path + [nxt]))
        return None

    # -------------------------------------------------------------- sections
    def enter_section(self, name: str) -> bool:
        me = threading.get_ident()
        with self._meta:
            owner, depth = self._sections.get(name, (0, 0))
            if depth == 0 or owner == me:
                self._sections[name] = (me, depth + 1)
                return True
            self.record(
                f"serialized-section violation: thread "
                f"{threading.current_thread().name!r} entered "
                f"{name!r} while another thread holds it — a mutation "
                f"path bypassed the daemon command queue", locked=True)
            return False

    def exit_section(self, name: str) -> None:
        with self._meta:
            owner, depth = self._sections.get(name, (0, 0))
            if depth > 0:
                self._sections[name] = (owner, depth - 1)

    # ------------------------------------------------------------- reporting
    def record(self, msg: str, locked: bool = False) -> None:
        if locked:                       # caller already holds _meta
            self.violations.append(msg)
            return
        with self._meta:
            self.violations.append(msg)

    def snapshot(self) -> List[str]:
        with self._meta:
            return list(self.violations)

    def order_edges(self) -> List[str]:
        with self._meta:
            return sorted(f"{a} -> {b}" for a, bs in self.edges.items()
                          for b in bs)


class InstrumentedLock:
    """Wraps a real Lock/RLock; Condition-compatible (see module doc)."""

    def __init__(self, inner, name: str, reentrant: bool,
                 recorder: Recorder):
        self._inner = inner
        self.name = name
        self.reentrant = reentrant
        self._recorder = recorder

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._recorder.before_acquire(self)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._recorder.after_acquire(self)
        return got

    def release(self) -> None:
        self._inner.release()
        self._recorder.after_release(self)

    def locked(self) -> bool:
        inner_locked = getattr(self._inner, "locked", None)
        return inner_locked() if inner_locked is not None else False

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # --- threading.Condition compatibility: delegate to the real lock so
    # wait() can release/restore without tripping the bookkeeping
    def _is_owned(self):
        inner = getattr(self._inner, "_is_owned", None)
        if inner is not None:
            return inner()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        inner = getattr(self._inner, "_release_save", None)
        if inner is not None:
            return inner()
        self._inner.release()

    def _acquire_restore(self, state):
        inner = getattr(self._inner, "_acquire_restore", None)
        if inner is not None:
            return inner(state)
        self._inner.acquire()

    def __getattr__(self, attr):
        # CPython internals poke extra methods on lock objects
        # (e.g. concurrent.futures registers _at_fork_reinit at-fork
        # handlers); forward anything we don't wrap to the real lock.
        try:
            inner = object.__getattribute__(self, "_inner")
        except AttributeError:
            raise AttributeError(attr)
        return getattr(inner, attr)

    def __repr__(self) -> str:
        return f"<InstrumentedLock {self.name} {self._inner!r}>"


_recorder = Recorder()            # the session-global recorder
_installed = False


def _creation_site(depth: int = 2) -> str:
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return "unknown:0"
    fn = os.path.basename(frame.f_code.co_filename)
    if fn.endswith(".py"):
        fn = fn[:-3]
    return f"{fn}:{frame.f_code.co_name}:{frame.f_lineno}"


def make_lock(name: Optional[str] = None, reentrant: bool = False,
              recorder: Optional[Recorder] = None) -> InstrumentedLock:
    """Explicitly-wrapped lock (unit tests / ad-hoc instrumentation)."""
    inner = _real_RLock() if reentrant else _real_Lock()
    return InstrumentedLock(inner, name or _creation_site(),
                            reentrant, recorder or _recorder)


def _lock_factory():
    return InstrumentedLock(_real_Lock(), _creation_site(), False, _recorder)


def _rlock_factory():
    return InstrumentedLock(_real_RLock(), _creation_site(), True, _recorder)


def install() -> None:
    """Monkeypatch ``threading.Lock``/``RLock``.  Locks created *before*
    install (module import time, interpreter internals) stay untracked."""
    global _installed
    if _installed:
        return
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    _installed = True


def uninstall() -> None:
    global _installed
    threading.Lock = _real_Lock
    threading.RLock = _real_RLock
    _installed = False


def installed() -> bool:
    return _installed


def violations() -> List[str]:
    return _recorder.snapshot()


def order_edges() -> List[str]:
    return _recorder.order_edges()


# ----------------------------------------------------------- serialized guard
class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class _SectionCtx:
    __slots__ = ("name", "recorder", "_entered")

    def __init__(self, name: str, recorder: Recorder):
        self.name = name
        self.recorder = recorder
        self._entered = False

    def __enter__(self):
        self._entered = self.recorder.enter_section(self.name)
        return self

    def __exit__(self, *exc):
        if self._entered:
            self.recorder.exit_section(self.name)
        return False


def serialized(name: str, recorder: Optional[Recorder] = None):
    """Single-entrancy assertion for daemon-serialized state.  Free when
    the checker is not installed (returns a shared no-op context)."""
    if recorder is None:
        if not _installed:
            return _NULL
        recorder = _recorder
    return _SectionCtx(name, recorder)


def guard_serialized(name: str):
    """Decorator form of :func:`serialized` for the control-plane mutators
    (scheduler pump, engine round, controller tick).  Near-free when the
    checker is not installed."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _installed:
                return fn(*args, **kwargs)
            with _SectionCtx(name, _recorder):
                return fn(*args, **kwargs)
        return wrapper
    return deco
