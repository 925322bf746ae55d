"""Fault-tolerant checkpointing: atomic, async, namespaced, self-describing
(the port of ``repro.checkpoint.manager``, in its on-disk format: a
checkpoint written by either package restores in the other).

Layout (one directory per step, per block namespace):

    <root>/<namespace>/step_<n>/
        manifest.json      # tree structure, shapes, dtypes, crc32 per leaf
        leaf_00000.npy ...

Leaves are numbered in ``jax.tree`` flattening order: dict keys sorted,
lists and tuples in order, a ``None`` subtree gives no leaf, anything else
(a tensor, a numpy array, a Python scalar) is one leaf.  The manifest's
``"treedef"`` is that structure written as ``jax`` prints a tree
definition; restore matches leaves by order, count and shape, as the
reference does.  numpy cannot store bf16 or fp8, so such a leaf is written
as its bytes, a uint8 array of shape ``(*shape, itemsize)``, under its
logical dtype, and read back through the same byte view of the tensor
(no ``ml_dtypes``).

Writes go to ``step_<n>.tmp`` and are renamed, so a crash mid-save never
corrupts the latest checkpoint.  ``save_async`` copies every leaf to the
host before it returns (the optimizer and the paged decode update their
tensors in place, so a copy still in flight would save a later state) and
writes the files on a background thread.  Copies from the card go
through a pinned staging buffer; files are written, read and checksummed
one leaf per I/O thread.

A block of several devices holds DTensor leaves, and its checkpoint is
the same whole leaves.  Every rank of the block runs ``save`` (the
ranks' programs are the same): each DTensor leaf is gathered whole in
turn, and the first rank of the block's mesh copies it to the host and
writes the files, so the ``keep`` rotation and the rename of
``step_<n>.tmp`` happen once; it starts after a barrier on the block's
own group (every rank done reading what the save may replace), and the
block's other ranks wait at a second one until the directory is renamed
(at ``save``, or at ``wait`` after ``save_async``).  Ranks outside the block take no
part, and a block that does not hold world rank 0 writes its own.
``restore(..., shardings=)`` reads each leaf on every rank of the block
and keeps the rank's slice of it (``plans.Layout``): no collective, and
any mesh shape, so a block can move onto ranks that never held it.  A
serve block's decode context is such leaves too: its cache's rows and,
where the attention computes sharded over ``model``, kv heads (each
rank's, as DTensors of ``plans.cache_layouts``) gathered whole, in the
reference's format, and its token (the whole batch's on every rank) and
pool written as they are by the first rank; a restore on any mesh gives
each rank its rows and heads of them.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.device import is_block_writer
from repro_torch.launch.mesh import block_group

# numpy can't serialize bf16/fp8 natively: store a byte view + logical dtype
_EXOTIC = {"bfloat16", "float8_e4m3fn", "float8_e5m2"}

#: bytes of the pinned buffer that copies from the card are staged through
STAGE_BYTES = 256 << 20
#: threads that write, read and checksum leaf files
IO_WORKERS = 8


def _describe(t, leaves: List[Any]) -> str:
    if t is None:
        return "None"
    if isinstance(t, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(t[k], leaves)}"
                               for k in sorted(t)) + "}"
    if isinstance(t, (list, tuple)):
        inner = ", ".join(_describe(x, leaves) for x in t)
        if isinstance(t, list):
            return f"[{inner}]"
        return f"({inner},)" if len(t) == 1 else f"({inner})"
    leaves.append(t)
    return "*"


def _flatten(tree) -> Tuple[List[Any], str]:
    """(leaves, structure) in ``jax.tree`` order; the structure reads as
    ``str(jax.tree_util.tree_structure(tree))`` does for dicts, lists,
    tuples and ``None``.  (Module-level recursion: a recursive closure is
    a reference cycle that would keep the leaves, a device state, alive
    until the next garbage collection.)"""
    leaves: List[Any] = []
    return leaves, f"PyTreeDef({_describe(tree, leaves)})"


def _rebuild(t, it):
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _rebuild(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_rebuild(x, it) for x in t)
    return next(it)


def _leaves_up_to(like, shardings):
    """``shardings``' node at each leaf of ``like``, in ``_flatten``'s
    order (None where ``shardings`` has none)."""
    if like is None:
        return
    if isinstance(like, dict):
        for k in sorted(like):
            yield from _leaves_up_to(
                like[k], None if shardings is None else shardings.get(k))
        return
    if isinstance(like, (list, tuple)):
        for i, x in enumerate(like):
            yield from _leaves_up_to(
                x, None if shardings is None else shardings[i])
        return
    yield shardings


def _unflatten(like, leaves) -> Any:
    """``like``'s structure with its leaves replaced, in order."""
    return _rebuild(like, iter(leaves))


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


class CheckpointManager:
    def __init__(self, root: str, namespace: str = "default", keep: int = 3):
        self.root = root
        self.namespace = namespace
        self.keep = keep
        self.dir = os.path.join(root, namespace)
        os.makedirs(self.dir, exist_ok=True)
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._io = cf.ThreadPoolExecutor(max_workers=IO_WORKERS)
        self._pending: Optional[cf.Future] = None
        self._barrier_due = None     # a sharded async save: the block's
                                     # group, whose other ranks wait()
                                     # meets after it lands
        self._stage: Optional[torch.Tensor] = None
        #: seconds of the last save's and restore's stages: ``copy_s``
        #: (device to host), ``write_s`` (files and crc32, wall),
        #: ``read_s`` (files and crc32 not yet done when placing needs
        #: them, wall), ``place_s`` (host to device), and ``crc_s``
        #: (crc32, summed over the I/O threads)
        self.timings: Dict[str, float] = {}

    # ------------------------------------------------------------ transfers
    def _staging(self) -> torch.Tensor:
        if self._stage is None:
            self._stage = torch.empty(STAGE_BYTES, dtype=torch.uint8,
                                      pin_memory=True)
        return self._stage

    def _to_host(self, t: torch.Tensor, copy: bool) -> torch.Tensor:
        """A contiguous host copy of ``t`` (on the host already: ``t``
        itself unless ``copy``)."""
        t = t.detach()
        if t.device.type == "cpu":
            return t.clone() if copy else t.contiguous()
        out = torch.empty(t.shape, dtype=t.dtype)
        src, dst, stage = _bytes(t.contiguous()), _bytes(out), \
            self._staging()
        for o in range(0, src.numel(), STAGE_BYTES):
            n = min(STAGE_BYTES, src.numel() - o)
            stage[:n].copy_(src[o:o + n], non_blocking=True)
            torch.cuda.current_stream(t.device).synchronize()
            dst[o:o + n].copy_(stage[:n])
        return out

    def _host_leaves(self, tree, copy: bool):
        """(structure, [(array to write, logical shape, logical dtype)],
        the block's mesh or None for a tree of no DTensor); a rank that
        does not write gets no arrays."""
        leaves, desc = _flatten(tree)
        mesh = next((x.device_mesh for x in leaves
                     if isinstance(x, DTensor)), None)
        writer = mesh is None or is_block_writer(mesh)
        out = []
        for leaf in leaves:
            if isinstance(leaf, DTensor):
                whole = leaf.detach().full_tensor()
                if writer:
                    out.append(self._host_leaf(whole, copy))
                del whole
            elif writer:
                out.append(self._host_leaf(leaf, copy))
        return desc, out, mesh

    def _host_leaf(self, leaf, copy: bool):
        """(array to write, logical shape, logical dtype) of one leaf."""
        if isinstance(leaf, torch.Tensor):
            name = _dtype_name(leaf)
            host = self._to_host(leaf, copy)
            arr = (_bytes(host).reshape(*leaf.shape, leaf.element_size())
                   if name in _EXOTIC else host).numpy()
            return arr, list(leaf.shape), name
        arr = np.array(leaf) if copy else np.asarray(leaf)
        name = str(arr.dtype)
        shape = list(arr.shape)
        if name in _EXOTIC:
            arr = arr.view(np.uint8).reshape(*arr.shape, -1)
        return arr, shape, name

    # ------------------------------------------------------------------ save
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def save(self, step: int, tree) -> str:
        """Synchronous atomic save.  Returns the checkpoint path."""
        t0 = time.perf_counter()
        desc, host, mesh = self._host_leaves(tree, copy=False)
        self.timings = {"copy_s": time.perf_counter() - t0}
        self._all_here(mesh)
        path = (self._write(step, desc, host)
                if mesh is None or is_block_writer(mesh)
                else self._step_dir(step))
        if mesh is not None:
            dist.barrier(group=block_group(mesh))
        return path

    def save_async(self, step: int, tree) -> None:
        """Async save: device->host copy happens now; file IO in background."""
        self.wait()
        t0 = time.perf_counter()
        desc, host, mesh = self._host_leaves(tree, copy=True)
        self.timings = {"copy_s": time.perf_counter() - t0}
        self._all_here(mesh)
        if mesh is None or is_block_writer(mesh):
            self._pending = self._pool.submit(self._write, step, desc, host)
        self._barrier_due = None if mesh is None else block_group(mesh)

    @staticmethod
    def _all_here(mesh) -> None:
        """A sharded save's ranks all reach it before its writer touches
        the block's directory: a rank still reading the step this save
        rewrites (a restore just before, as a resize's, on a block whose
        leaves are all replicated, so that the save gathers nothing that
        would wait for it) finishes first."""
        if mesh is not None:
            dist.barrier(group=block_group(mesh))

    def wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()
        if self._barrier_due is not None:
            group, self._barrier_due = self._barrier_due, None
            dist.barrier(group=group)

    def _write_leaf(self, tmp: str, i: int, arr: np.ndarray):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        t0 = time.perf_counter()
        crc = _crc(arr)
        return fname, crc, time.perf_counter() - t0

    def _write(self, step: int, desc: str, host) -> str:
        t0 = time.perf_counter()
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        futs = [self._io.submit(self._write_leaf, tmp, i, arr)
                for i, (arr, _, _) in enumerate(host)]
        manifest = {"step": step, "treedef": desc, "leaves": []}
        crc_s = 0.0
        for fut, (_, shape, name) in zip(futs, host):
            fname, crc, dt = fut.result()
            crc_s += dt
            manifest["leaves"].append({"file": fname, "shape": shape,
                                       "dtype": name, "crc32": crc})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        self.timings.update(write_s=time.perf_counter() - t0, crc_s=crc_s)
        return final

    # --------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    @staticmethod
    def _read_leaf(path: str, meta: Dict[str, Any], verify: bool):
        """Read and verify one leaf: (array, crc seconds)."""
        arr = np.load(os.path.join(path, meta["file"]))
        t0 = time.perf_counter()
        if verify and _crc(arr) != meta["crc32"]:
            raise IOError(f"crc mismatch in {meta['file']} "
                          f"(corrupt checkpoint {path})")
        return arr, time.perf_counter() - t0

    def restore(self, like_tree, step: Optional[int] = None, device=None,
                verify: bool = True, shardings=None):
        """Restore into the structure of ``like_tree``; returns (tree,
        step).

        A tensor leaf of ``like_tree`` gives the restored leaf's shape and
        dtype (the stored values are cast to it, as the reference casts),
        and its device unless ``device`` is given; a leaf on ``meta``
        needs ``device``.  A numpy leaf restores as numpy, a Python scalar
        as one.  Logical leaf shapes must match the manifest.
        ``shardings``: a tree of ``like_tree``'s structure whose leaves are
        ``plans.Layout`` (or None); such a leaf restores as this rank's
        DTensor shard of the whole leaf."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, _ = _flatten(like_tree)
        layouts = (list(_leaves_up_to(like_tree, shardings))
                   if shardings is not None else [None] * len(leaves))
        if len(manifest["leaves"]) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, "
                f"expected {len(leaves)}")
        device = torch.device(device) if device is not None else None
        for meta, like in zip(manifest["leaves"], leaves):
            like_shape = list(getattr(like, "shape", []) or [])
            if like_shape != meta["shape"]:
                raise ValueError(
                    f"{meta['file']}: checkpoint leaf shape {meta['shape']} "
                    f"!= target shape {like_shape} — cross-geometry restore "
                    f"reshards placement onto a new mesh, it cannot change "
                    f"logical shapes (did the model config change?)")
            if (isinstance(like, torch.Tensor) and device is None
                    and like.device.type == "meta"):
                raise ValueError(f"{meta['file']}: a meta target leaf needs "
                                 f"device=")
            if not isinstance(like, torch.Tensor) and \
                    meta["dtype"] in _EXOTIC:
                raise TypeError(f"{meta['file']}: a {meta['dtype']} leaf "
                                f"restores into a tensor target only")
        t0 = time.perf_counter()
        futs = [self._io.submit(self._read_leaf, path, meta, verify)
                for meta in manifest["leaves"]]
        out, crc_s, place_s = [], 0.0, 0.0
        try:
            for fut, meta, like, lay in zip(futs, manifest["leaves"],
                                            leaves, layouts):
                arr, dt = fut.result()
                crc_s += dt
                t1 = time.perf_counter()
                out.append(self._place(arr, meta, like, device, lay))
                place_s += time.perf_counter() - t1
        finally:
            for fut in futs:
                fut.cancel()
        self.timings = {"read_s": time.perf_counter() - t0 - place_s,
                        "place_s": place_s, "crc_s": crc_s}
        return _unflatten(like_tree, out), step

    def _place(self, arr: np.ndarray, meta: Dict[str, Any], like, device,
               layout=None):
        if isinstance(like, torch.Tensor):
            t = torch.from_numpy(arr)
            if meta["dtype"] in _EXOTIC:
                t = t.view(getattr(torch, meta["dtype"])).reshape(
                    meta["shape"])
            if layout is not None:
                t = t[layout.index(tuple(t.shape))].contiguous()
                return layout.wrap(t.to(device if device is not None
                                        else like.device, like.dtype))
            return t.to(device if device is not None else like.device,
                        like.dtype)
        if hasattr(like, "dtype"):          # numpy
            return np.asarray(arr, dtype=like.dtype)
        # python scalar leaf (e.g. step counters)
        return arr.item() if getattr(arr, "ndim", 0) == 0 else arr

    # -------------------------------------------------------------------- gc
    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
