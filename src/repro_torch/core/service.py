"""The daemon's service mode across ranks: one leader and its followers.

``ClusterDaemon``'s background mode serialises every mutation (a
command, the periodic ``tick()``, a pod worker's engine round) under one
lock, ``_serial``, on one process.  Under a process group every rank is
a process of its own and runs the same control plane, so that lock's
order becomes a log: rank 0's daemon (the leader) owns the command
queue, the pump thread, the pod workers and the gateway, and writes one
entry per mutation; every other rank (a follower) runs ``follow()``, a
loop with no thread, no queue and no clock of its own, which executes
the entries in the leader's order.

An entry (``Entry``) holds the operation (a command name, ``"tick"``,
``"round"`` for ``run_round(pod=...)``, or ``"stop"``), its args and
kwargs and the leader's ``now``: the leader reads ``time.time()`` once
an entry and gives it as ``now=`` to every body that takes one and was
given none (``tick``, ``run_round``, ``expire``, ``preempt``,
``fail_pod``, ``pod_heartbeat``, ``attach_pod``, ``resize`` ...), so the
ranks never decide on two clocks (expiry, waitlist order, slack, health,
pacing allowance).  The wall-clock reads an op can reach, by what they
decide:

* decision, given the leader's ``now`` by the entry:
  ``registry.expired`` (expiry), ``registry.enqueue`` and
  ``mark_preempted``'s ``queued_at``, ``scheduler.submit``,
  ``submit_gang``, ``_pump_body``, ``_preempt_for_waiters`` and
  ``_select_victims`` (waitlist order, wait, slack, victims),
  ``federation.health``'s ``beat`` and ``check`` and ``pods``'s
  ``attach`` and ``beat`` (health), the engine's ``run_round``
  (run-until time, pacing allowance); ``resize`` takes a ``now`` for
  its pump (``controller.resize_block``);
* decision, rank 0's by a broadcast: a grant's ``expires_at``
  (``BlockGrant.new``, agreed in ``controller._new_grant``);
* display: ``Block.transition``'s and ``registry.register``'s history
  text, ``Block.record_preemption``'s ``t``, an event's ``t`` where its
  op passes no ``now``, ``monitor.record_step``'s and ``heartbeat``'s
  ``last_heartbeat`` (read by ``dead_blocks`` only, which no op calls)
  and ``dead_blocks``'s own default, a paged scheduler's TTFT clock.

The entry goes out over the control channel
(``device.to_ranks``: a gloo group over every rank) *before* the op
runs, so every rank enters the op's collectives (a grant's broadcast, a
block's mesh, a step's record, a round's emissions) at the same time.
Args that do not pickle raise on the leader, naming the command, before
any rank waits.  A tick is an entry too, so between ops a follower
hears from the leader at least every ``tick_interval_s`` and never
waits out the collective timeout.  ``stop()`` sends a last entry that
ends ``follow()``.

Tripwires: each entry carries the leader's count of bus events before
the op (``tally``: every event but the rank-local kinds, a compile
cache's hits and misses and a recorder's postmortems) and the outcome of
the previous op (``"ok"`` or the exception's type).  A follower compares
both with its own and raises ``Divergence`` at once, naming the entry,
so ranks that part show as an error, not as a collective that hangs
later; an op that raised on the leader must raise alike on a follower,
which swallows it only then.

A call made inside an entry (an event subscriber reacting on the
executing thread) is part of that entry: it runs inline and is not
logged, and a follower makes it where its own subscriber does.  Reads
(status, events, ``wait_events``) stay local to each rank; the gateway
runs on rank 0 over the leader.  Under a process group the leader path
is taken at world 1 too: every entry is pickled and passed through the
control group (counted in ``log_entries`` and ``log_bytes``).  Without
a process group there is no leader: ``ClusterDaemon`` is the daemon.
"""
from __future__ import annotations

import dataclasses
import inspect
import threading
import time
from typing import Any, Dict, Optional, Tuple

import torch.distributed as dist

from repro_torch import device
from repro_torch.analysis import runtime_check
from repro_torch.core.daemon import ClusterDaemon

#: event kinds a rank publishes on its own: its compile cache's hits and
#: misses (a block's ranks build its steps, the others do not) and its
#: flight recorder's postmortems
RANK_LOCAL = frozenset({"compile", "postmortem"})


class Divergence(RuntimeError):
    """A follower's control plane parted from the leader's."""


@dataclasses.dataclass
class Entry:
    """One mutation of the leader's, as every follower replays it."""
    index: int
    op: str                 # a command name, "tick", "round" or "stop"
    args: Tuple = ()
    kwargs: Dict = dataclasses.field(default_factory=dict)
    now: float = 0.0        # the leader's clock when it wrote the entry
    tally: int = 0          # the leader's bus events before the op
    prev: str = "ok"        # the previous op's outcome on the leader

    def describe(self) -> str:
        args = ", ".join([repr(a)[:60] for a in self.args] + [
            f"{k}={v!r:.60}" for k, v in self.kwargs.items()])
        return f"entry {self.index} ({self.op}({args}))"


def _takes_now(fn) -> Optional[inspect.Signature]:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return sig if "now" in sig.parameters else None


class ServiceDaemon(ClusterDaemon):
    """``ClusterDaemon`` under a process group: rank 0's is the leader
    (``background=True`` starts its pump), every other rank's
    ``follow()``s it.  Built on every rank at the same point (it makes
    the control group when the world was begun without it).

    The leader keeps ``ClusterDaemon``'s pump, pod workers and ``call``
    as they are: each path they take to a mutation, the command table,
    the controller's ``tick`` and the engine's ``run_round``, is that op
    logged (``_run``), while ``_ops`` keeps the bodies the followers
    replay."""

    def __init__(self, topo, devices=None, background: bool = False,
                 **kw):
        if not dist.is_initialized():
            raise RuntimeError(
                "a ServiceDaemon orders the ranks of a process group; "
                "without one, ClusterDaemon is the daemon")
        device.control_group()
        self.leader = device.rank() == 0
        self.log_entries = 0
        self.log_bytes = 0
        self.log_send_s = 0.0       # the leader's pickle and broadcast
        self.diverged: Optional[str] = None
        self._index = 0
        self._prev = "ok"
        self._local = 0             # rank-local events on this bus
        self._closed = False
        self._broken: Optional[BaseException] = None
        self._inside = threading.local()
        super().__init__(topo, devices=devices, background=False, **kw)
        self._table["wait_saves"] = self._wait_saves
        self.bus.subscribe(self._count_local, kinds=set(RANK_LOCAL))
        self._ops = dict(self._table, tick=self.ctl.tick,
                         round=self.engine.run_round)
        self._now_sigs = {op: _takes_now(fn) for op, fn in self._ops.items()}
        self._table = {op: self._logged(op) for op in self._table}
        self.ctl.tick = self._logged("tick")
        self.engine.run_round = self._logged("round")
        if background:
            self.start()

    # ---------------------------------------------------------------- log
    def _count_local(self, ev) -> None:
        self._local += 1

    @property
    def tally(self) -> int:
        """Bus events so far but the rank-local kinds: the same on every
        rank while the ranks agree."""
        return self.bus.latest_seq - self._local

    def _logged(self, op: str):
        return lambda *args, **kwargs: self._run(op, args, kwargs)

    def _stamp(self, op: str, args: Tuple, kwargs: Dict,
               now: float) -> Tuple[Tuple, Dict]:
        """``now`` given to a body that takes one and was given none."""
        sig = self._now_sigs.get(op)
        if sig is None:
            return args, kwargs
        bound = sig.bind_partial(*args, **kwargs)
        if bound.arguments.get("now") is not None:
            return args, kwargs
        bound.arguments["now"] = now
        return tuple(bound.args), dict(bound.kwargs)

    def _send(self, entry: Entry) -> None:
        t0 = time.perf_counter()
        before = dict(device.CONTROL)
        try:
            device.to_ranks(entry, what=f"the {entry.op!r} command's "
                                        f"arguments")
        except TypeError:
            raise                     # did not pickle: nothing was sent
        except BaseException as e:
            # the channel failed: no more entries, and the pump and the
            # pod workers end
            self._broken = e
            self._stop.set()
            raise
        self.log_send_s += time.perf_counter() - t0
        self._counted(before)
        self._index += 1

    def _counted(self, before: Dict[str, int]) -> None:
        self.log_entries += device.CONTROL["entries"] - before["entries"]
        self.log_bytes += device.CONTROL["bytes"] - before["bytes"]

    def _run(self, op: str, args: Tuple, kwargs: Dict):
        """The leader's mutation ``op`` (its caller holds ``_serial``):
        one entry, sent, then the op.  A call made inside an entry runs
        inline, as part of it."""
        fn = self._ops[op]
        if getattr(self._inside, "entry", False):
            return fn(*args, **kwargs)
        if not self.leader:
            raise RuntimeError(
                f"{op}: rank {device.rank()} follows rank 0's daemon, "
                f"which takes every command")
        if self._broken is not None:
            raise RuntimeError(f"the control channel failed: "
                               f"{self._broken!r}")
        if self._closed:
            raise RuntimeError(f"{op}: the leader's log is closed (the "
                               f"daemon stopped)")
        now = time.time()
        args, kwargs = self._stamp(op, args, kwargs, now)
        self._send(Entry(self._index, op, args, kwargs, now, self.tally,
                         self._prev))
        return self._apply(fn, args, kwargs)

    def _apply(self, fn, args: Tuple, kwargs: Dict):
        self._inside.entry = True
        try:
            with runtime_check.serialized("control-plane"):
                out = fn(*args, **kwargs)
        except BaseException as e:
            self._prev = type(e).__name__
            raise
        finally:
            self._inside.entry = False
        self._prev = "ok"
        return out

    def _wait_saves(self, app_id: str) -> None:
        rt = self.ctl.runtimes.get(app_id)
        if getattr(rt, "ckpt", None) is not None:
            rt.ckpt.wait()

    def wait_saves(self, app_id: str) -> None:
        """The block's async save landed, on every rank: a command of its
        own, since a sharded save's ranks meet at a barrier as it lands
        (a caller on the leader alone would wait there for ever)."""
        return self.call("wait_saves", app_id)

    # ------------------------------------------------------------ leader
    def start(self) -> "ServiceDaemon":
        if not self.leader:
            raise RuntimeError(
                f"rank {device.rank()} follows rank 0's daemon: call "
                f"follow(), and send commands to rank 0")
        if self._closed:
            raise RuntimeError("the leader's log is closed: a stopped "
                               "ServiceDaemon does not start again")
        return super().start()

    def stop(self, timeout: float = 10.0) -> None:
        """The leader's pump and workers stopped, then the last entry,
        which ends every follower's ``follow()``; a follower's stop does
        nothing (its loop ends with that entry)."""
        if not self.leader:
            return
        super().stop(timeout)
        with self._serial:
            if not self._closed and self._broken is None:
                self._send(Entry(self._index, "stop", (), {}, time.time(),
                                 self.tally, self._prev))
            self._closed = True

    # ---------------------------------------------------------- follower
    def follow(self) -> int:
        """A follower's loop: every entry of the leader's log checked and
        replayed, in order, until the leader's last.  Returns the entries
        followed; raises ``Divergence`` at the first entry after the ranks
        parted."""
        if self.leader:
            raise RuntimeError("rank 0 leads: start() its pump, and the "
                               "other ranks follow()")
        while True:
            before = dict(device.CONTROL)
            entry = device.to_ranks(None)
            self._counted(before)
            self._check(entry)
            self._index += 1
            if entry.op == "stop":
                self._closed = True
                return self.log_entries
            self.replay(entry)

    def _check(self, entry: Entry) -> None:
        """The tripwires: this rank's entry count, bus events and last
        outcome against the leader's."""
        mine = (self._index, self.tally, self._prev)
        theirs = (entry.index, entry.tally, entry.prev)
        if mine != theirs:
            self.diverged = (
                f"rank {device.rank()} diverged from rank 0 before "
                f"{entry.describe()}: (entries, bus events, last outcome) "
                f"here {mine}, on rank 0 {theirs}")
            raise Divergence(self.diverged)

    def replay(self, entry: Entry) -> None:
        """One entry's op on this rank, at the leader's ``now``; an error
        is swallowed and its type compared at the next entry."""
        with self._serial:
            try:
                self._apply(self._ops[entry.op], entry.args, entry.kwargs)
            except Exception:
                pass

    def log_stats(self) -> Dict[str, Any]:
        """The log's traffic on this rank: entries, pickled bytes and,
        on the leader, the host seconds its sends took."""
        return {"log_entries": self.log_entries,
                "log_bytes": self.log_bytes,
                "send_s": self.log_send_s,
                "diverged": self.diverged}
