"""Compiled-step cache and captured steps (the port of
``repro.train.compile_cache``).

The reference keys the *logical* build signature of a step — (step
family, model config, shape, optimizer config, mesh geometry + device
ids, donate signature) — and hands back the previously built ``jax.jit``
wrapper, so a block resumed on the same chips recompiles nothing.
``freeze``, ``mesh_fingerprint``, ``CompileCache`` and ``GLOBAL`` are the
reference's, unchanged: hits and misses are announced as kind="compile"
events on the bus attached via ``set_bus``.  The port's keys carry this
rank's ``device_fingerprint`` where the reference's carry the mesh's.

What the port caches is the step function; what ``jax.jit`` gives the
reference beyond the cache is a ``CapturedStep``: the step captured once
as a CUDA graph and replayed on every later call, so that the host
launches one graph a step instead of every kernel of it.  A graph binds
the addresses of the tensors it was captured with (one block's params,
cache and inputs), so the cache entry is shared and the graphs are per
block: each block wraps the cached function in a ``CapturedStep`` of its
own, and a resumed block captures again.

On a block's mesh a step's params are DTensors: a graph binds each one's
local shard, and the gathers of a dense decode step (the params a group
at a time, the next tokens over ``data``) are captured inside its graph.
The keys of a block on a mesh carry its mesh shape beside its device's
fingerprint (the runtime's ``_cache_key``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

from repro_torch.kernels import (decode_attention, flash_attention,
                                 fused_adamw, paged_attention, rmsnorm,
                                 slstm, ssd_scan)


def freeze(obj) -> Any:
    """Recursively convert configs (dataclasses / dicts / lists / sets)
    into hashable nested tuples for cache keys."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, freeze(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return tuple(sorted((k, freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(freeze(v) for v in obj)
    if isinstance(obj, (set, frozenset)):
        return tuple(sorted(freeze(v) for v in obj))
    return obj


def mesh_fingerprint(mesh) -> Tuple:
    """(axis layout, device ids): two meshes with the same fingerprint can
    share a built step.  The port has no meshes until the multi-GPU
    slice, so its blocks pass None."""
    if mesh is None:
        return ("default",)
    return (tuple(zip(mesh.axis_names, mesh.devices.shape)),
            tuple(int(d.id) for d in mesh.devices.flat))


def device_fingerprint(device) -> Tuple:
    """(type, index) of a one-device block's device: the port's keys
    carry it where the reference's carry ``mesh_fingerprint``."""
    device = torch.device(device)
    return (device.type, device.index)


class CompileCache:
    """Thread-safe keyed store of built step callables."""

    def __init__(self, bus=None):
        self._lock = threading.Lock()
        self._entries: Dict[Any, Any] = {}
        self.hits = 0
        self.misses = 0
        self._bus = bus

    def set_bus(self, bus) -> None:
        """Attach the event bus hit/miss events are published on (the
        controller attaches its own at construction)."""
        self._bus = bus

    def get(self, key, builder: Callable[[], Any], *,
            label: str = "step", block_id: Optional[str] = None,
            app_id: Optional[str] = None, now: Optional[float] = None) -> Any:
        """Return the cached artifact for ``key``, building (and caching)
        it with ``builder()`` on a miss.  Publishes a kind="compile" event
        either way."""
        with self._lock:
            hit = key in self._entries
            if hit:
                self.hits += 1
                out = self._entries[key]
        if not hit:
            out = builder()          # build outside the lock
            with self._lock:
                # a racing builder may have landed first; keep the winner
                # so every caller shares one entry
                out = self._entries.setdefault(key, out)
                self.misses += 1
        bus = self._bus
        if bus is not None:
            bus.publish("compile", block_id=block_id, app_id=app_id,
                        now=now, action="hit" if hit else "miss",
                        label=label)
        return out

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._entries)}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0


#: process-wide default — BlockRuntime and DecodeScheduler build through
#: this so any rebuild anywhere in the process can reuse prior work
GLOBAL = CompileCache()


# ===========================================================================
# Captured steps
# ===========================================================================

#: the kernel modules whose launch counters (every module-level int named
#: ``*LAUNCHES*``) a replay advances as the captured step's Python did
COUNTED = (decode_attention, flash_attention, fused_adamw, paged_attention,
           rmsnorm, slstm, ssd_scan)

#: a capture's error mode: ``thread_local`` refuses an unsafe CUDA call
#: from the capturing thread and lets other threads (a checkpoint's I/O
#: threads, another block's) make theirs without invalidating the capture
CAPTURE_ERROR_MODE = "thread_local"

#: CapturedStep calls that ran their step eagerly (on the CPU, or with
#: ``capture=False``); a run resets it to 0 and reads it after
EAGER_CALLS = 0


def counters() -> Dict[Tuple[str, str], int]:
    return {(m.__name__, k): v for m in COUNTED
            for k, v in vars(m).items()
            if "LAUNCHES" in k and type(v) is int}


def set_counters(values: Dict[Tuple[str, str], int]) -> None:
    mods = {m.__name__: m for m in COUNTED}
    for (mod, attr), v in values.items():
        setattr(mods[mod], attr, v)


def _on_card(leaves) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves)


#: one capture stream per device, shared by every block of the process:
#: cuBLAS keeps a workspace per stream for the life of the process, so a
#: stream per block would leave one behind at each suspend
_STREAMS: Dict[torch.device, Any] = {}
_CAPTURE_LOCK = threading.Lock()


class _CudaGraphs:
    """Warm-up and capture on the device's side stream, as PyTorch's
    CUDA-graph rules ask: the warm-up creates what the step needs on that
    stream (cuBLAS handles and workspaces, the kernel library) before the
    capture, which must create nothing.  Captures take turns on it."""

    def __init__(self, device: torch.device):
        self.device = device
        with _CAPTURE_LOCK:
            if device not in _STREAMS:
                _STREAMS[device] = torch.cuda.Stream(device)
            self.stream = _STREAMS[device]

    def warmup(self, fn, args) -> None:
        current = torch.cuda.current_stream(self.device)
        with _CAPTURE_LOCK:
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                fn(*args)
            current.wait_stream(self.stream)

    def capture(self, fn, args, generators=()):
        """(graph, the step's outputs, bytes the graph's pool took).  The
        ``generators`` the step draws from are registered on the graph:
        each replay then draws the numbers an eager call would, and
        advances the generator as one does."""
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        with _CAPTURE_LOCK, torch.cuda.graph(
                graph, stream=self.stream,
                capture_error_mode=CAPTURE_ERROR_MODE):
            # read inside: entering the capture empties the allocator's
            # cache
            before = torch.cuda.memory_reserved(self.device)
            out = fn(*args)
        return graph, out, torch.cuda.memory_reserved(self.device) - before


def _backend(device: torch.device):
    return _CudaGraphs(device)


class CapturedStep:
    """The port's counterpart of the reference's ``jax.jit`` wrapper.

    ``fn(*args)`` is captured on its first call on the card: the step runs
    once on a side stream (its warm-up, on copies of the ``donate``
    arguments, so the state is left as it was), is captured into a
    ``torch.cuda.CUDAGraph`` on that stream, and the graph is replayed for
    this and every later call.  Tensors of the ``static`` argument
    positions (params, a cache updated in place, position scalars the
    caller refills) are bound as they are: the caller passes the same
    ones every call.  Every other tensor argument gets a buffer of the
    graph's own, which each call copies the new value into.  A
    ``torch.Generator`` argument is registered on the graph, and the
    warm-up's and the capture's draws are put back, so the replays draw
    what eager calls from the same state would.  Outputs that are static
    tensors come back as themselves; other outputs are copied out of the
    graph's memory, so the caller owns what it gets.

    A call whose static tensors are not the bound ones, or whose other
    arguments change shape or value, releases the graph and captures
    again (``captures`` counts them).  Kernel launch counters run in
    Python, which a replay skips: the change a capture makes to each is
    recorded, taken back (the warm-up's and the capture's kernels are not
    steps) and added again on every replay.

    ``warm_inplace(t)``, when given, names the donated tensors the
    warm-up may write in place instead of on a copy: a leaf the step
    writes only where what it writes does not depend on what was there,
    so the replay after the warm-up writes the same values over the
    warm-up's and reads what it would have read (a decode cache's K/V,
    written at row ``cache_len`` from the step's other inputs; a
    recurrent state, read before it is written, is copied).  A long
    context's cache is then held once, not twice, while the step is
    captured.

    On the CPU, or with ``capture=False`` (a check's eager reference),
    the step runs eagerly (``eager_calls``, and the module's
    ``EAGER_CALLS``).  On the card a capture or replay that fails raises:
    there is no eager fallback.
    """

    def __init__(self, fn, *, static: Sequence[int] = (),
                 donate: Sequence[int] = (), capture: bool = True,
                 warm_inplace=None):
        assert set(donate) <= set(static), (donate, static)
        self.fn = fn
        self.warm_inplace = warm_inplace
        self.static, self.donate = tuple(static), tuple(donate)
        self.capture = capture
        self.captures = self.replays = self.eager_calls = 0
        self.capture_ms = 0.0        # the last capture, warm-up included
        self.pool_bytes = 0          # what the last graph's pool took
        self.launches_per_replay: Dict[str, int] = {}   # the last graph's
        self._backend = None
        self._clear()

    def _clear(self) -> None:
        self._graph = None
        self._sig = None
        self._bound: list = []       # the static arguments' tensors
        self._inputs: list = []      # (leaf index, graph-owned buffer)
        self._out = None             # (treespec, leaves, leaf kinds)
        self._delta: Dict = {}

    def release(self) -> None:
        """Drop the graph, its memory pool and every buffer it bound: a
        suspended block gives all of it back."""
        if self._graph is not None:
            self._graph.reset()
        self._clear()

    def stats(self) -> Dict[str, Any]:
        return {"captures": self.captures, "replays": self.replays,
                "eager_calls": self.eager_calls,
                "capture_ms": self.capture_ms,
                "pool_mb": self.pool_bytes / 2 ** 20,
                "launches_per_replay": dict(self.launches_per_replay)}

    # ----------------------------------------------------------------- call
    def __call__(self, *args):
        global EAGER_CALLS
        leaves, spec = pytree.tree_flatten(args)
        if not (self.capture and _on_card(leaves)):
            self.eager_calls += 1
            EAGER_CALLS += 1
            return self.fn(*args)
        sig = self._signature(args, leaves, spec)
        if self._graph is None or sig != self._sig:
            self.release()
            self._record(args, leaves, spec, sig)
        else:
            for i, buf in self._inputs:
                if leaves[i] is not buf:
                    buf.copy_(leaves[i])
        self._graph.replay()
        self.replays += 1
        now = counters()
        set_counters({k: now[k] + d for k, d in self._delta.items()})
        return self._result()

    @staticmethod
    def _positions(args, positions) -> set:
        """Flat leaf indices of the given argument positions, as
        ``tree_flatten`` of the argument tuple lays them out."""
        out, start = set(), 0
        for pos, arg in enumerate(args):
            n = len(pytree.tree_leaves(arg))
            if pos in positions:
                out.update(range(start, start + n))
            start += n
        return out

    def _signature(self, args, leaves, spec):
        static = self._positions(args, self.static)
        sig = []
        for i, t in enumerate(leaves):
            if not isinstance(t, torch.Tensor):
                sig.append(("value", t))
            elif i in static:
                # a DTensor (a block's param on a mesh) binds its shard
                loc = t.to_local() if isinstance(t, DTensor) else t
                sig.append(("bound", loc.data_ptr(), tuple(loc.shape),
                            loc.stride(), t.dtype, t.device))
            else:
                sig.append(("input", tuple(t.shape), t.stride(), t.dtype,
                            t.device))
        return spec, tuple(sig)

    def _record(self, args, leaves, spec, sig) -> None:
        """Warm up, capture, and keep what the replays need."""
        static = self._positions(args, self.static)
        donate = self._positions(args, self.donate)
        if self._backend is None:
            self._backend = _backend(next(
                t.device for t in leaves if isinstance(t, torch.Tensor)))
        t0 = time.perf_counter()
        cap = list(leaves)
        for i, t in enumerate(leaves):
            if isinstance(t, torch.Tensor) and i not in static:
                cap[i] = t.clone()
                self._inputs.append((i, cap[i]))
            elif isinstance(t, torch.Tensor):
                self._bound.append(t)
        inplace = self.warm_inplace or (lambda t: False)
        warm = [t.clone() if i in donate and not inplace(t) else t
                for i, t in enumerate(cap)]
        gens = [g for g in leaves if isinstance(g, torch.Generator)]
        gen_states = [g.get_state() for g in gens]
        before = counters()
        self._backend.warmup(self.fn, pytree.tree_unflatten(warm, spec))
        del warm
        for g, st in zip(gens, gen_states):
            g.set_state(st)
        mid = counters()
        graph, out, pool = self._backend.capture(
            self.fn, pytree.tree_unflatten(cap, spec), gens)
        after = counters()
        set_counters(before)
        for g, st in zip(gens, gen_states):
            g.set_state(st)
        self._delta = {k: after[k] - mid[k] for k in after
                       if after[k] != mid[k]}
        self.launches_per_replay = {
            f"{mod.rsplit('.', 1)[-1]}.{attr}": d
            for (mod, attr), d in self._delta.items()}
        out_leaves, out_spec = pytree.tree_flatten(out)
        kinds = []
        for t in out_leaves:
            if not isinstance(t, torch.Tensor):
                kinds.append("value")
            elif any(t is b for b in self._bound):
                kinds.append("bound")
            else:
                kinds.append("graph")
        self._out = (out_spec, out_leaves, kinds)
        self._graph = graph
        self._sig = sig
        self.captures += 1
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = pool

    def _result(self):
        spec, leaves, kinds = self._out
        return pytree.tree_unflatten(
            [t.clone() if k == "graph" else t
             for t, k in zip(leaves, kinds)], spec)
