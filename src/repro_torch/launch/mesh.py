"""Mesh builders (the port of ``repro.launch.mesh``).

Functions, not module constants: importing this module never touches a
process group.  Each builds a ``torch.distributed`` DeviceMesh over
ranks of the running process group (``device.init_distributed``), one
rank per device.

A tenant block's mesh covers its grant's ranks only, and several blocks
run at once on disjoint subsets of the ranks.  Creating a process group
is a call every rank of the world makes, in the same order on each (the
groups are named by a counter in each process), so every rank enters
``make_block_mesh`` for every block, in grant order: a member gets the
block's mesh and its groups, a rank outside gets a mesh without groups
(``get_coordinate()`` is None) and holds nothing of the block.  Each
block has its own groups: one per row and column of its mesh and one
over all its ranks (``block_group``, for the checkpoint writer's
barrier), never the world group, even where a mesh dimension spans the
world.

A block's mesh goes back to a pool when the block moves or ends
(``release_block_mesh``, which every rank calls at the same point as
well), and the next block over the same ranks and shape takes it up
again: two blocks at once on the same ranks each have their own, and
the live groups are bounded by the most blocks ever held at once on one
subset, so repeated migrations over the same subsets create none.
(Destroying a block's groups would not be safe: a DeviceMesh compares
equal to any other over the same ranks, so DTensor's
sharding-propagation cache could hand a later block's tensors an
earlier mesh, and its groups must stay alive.)  A new world group (the
old one destroyed) starts an empty pool.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

_Key = Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[str, ...]]


class _Pool:
    """The block meshes of one world group: every one built (with its
    block-wide group, None on a rank outside it) and, by (ranks, shape,
    axis names), the ones no block holds."""

    def __init__(self, world):
        self.world = world
        self.groups: Dict[int, object] = {}      # id(mesh) -> block group
        self.meshes: List[DeviceMesh] = []
        self.free: Dict[_Key, List[DeviceMesh]] = {}


_POOL = _Pool(None)


def _pool() -> _Pool:
    global _POOL
    world = dist.group.WORLD
    if _POOL.world is not world:
        _POOL = _Pool(world)
    return _POOL


def _key(ranks, shape, axis_names) -> _Key:
    return (tuple(int(r) for r in ranks), tuple(int(s) for s in shape),
            tuple(axis_names))


def _key_of(mesh: DeviceMesh) -> _Key:
    return _key(mesh.mesh.flatten().tolist(), mesh.mesh.shape,
                mesh.mesh_dim_names)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 single pod (256 ranks) or 2x16x16 two-pod (512 ranks) mesh
    over every rank of the process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"the production mesh {shape} needs a process "
                           f"group of {n} ranks, have {have}")
    return make_block_mesh(list(range(n)), shape, axes)


def make_block_mesh(ranks: Sequence[int], shape,
                    axis_names=("data", "model")) -> DeviceMesh:
    """Mesh over an explicit subset of the ranks (a tenant block's
    sub-mesh), laid out row-major in ``shape``.  Every rank of the world
    calls it for every block, in the same order (see the module
    docstring)."""
    if not dist.is_initialized():
        raise RuntimeError("a block mesh needs a process group "
                           "(device.init_distributed)")
    pool = _pool()
    key = _key(ranks, shape, axis_names)
    free = pool.free.get(key)
    if free:
        return free.pop()
    mesh, group = _build(key)
    pool.meshes.append(mesh)
    pool.groups[id(mesh)] = group
    return mesh


def release_block_mesh(mesh: DeviceMesh) -> None:
    """A block moved or ended: its mesh back to the pool, for the next
    block over its ranks.  Every rank calls it for the block at the same
    point (a rank outside the block too); a mesh already back is left."""
    pool = _pool()
    if id(mesh) not in pool.groups:
        return                  # an earlier world's, or not a block mesh
    free = pool.free.setdefault(_key_of(mesh), [])
    if not any(m is mesh for m in free):
        free.append(mesh)


def _build(key: _Key):
    ranks, shape, names = key
    if len(set(ranks)) != len(ranks) or any(
            not 0 <= r < dist.get_world_size() for r in ranks):
        raise ValueError(f"a block mesh needs distinct ranks of the world, "
                         f"got {list(ranks)}")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(shape)
    me = dist.get_rank()
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dim_groups = []
    for dim in range(grid.ndim):
        # the groups along ``dim``: one per line of the grid through it
        lines = grid.movedim(dim, -1).reshape(-1, grid.shape[dim])
        mine = None
        for line in lines.tolist():
            g = dist.new_group(ranks=line)
            if me in line:
                mine = g
        dim_groups.append(mine)
    block = dist.new_group(ranks=list(ranks))
    if me not in ranks:
        return DeviceMesh(device_type, grid, mesh_dim_names=names,
                          _init_backend=False), None
    return DeviceMesh.from_group(dim_groups, device_type, mesh=grid,
                                 mesh_dim_names=names), block


def block_group(mesh: DeviceMesh):
    """The group over all of a block mesh's ranks (this rank must be one
    of them).  A mesh equal to a pooled one (a DTensor's, which DTensor
    may have taken from an equal mesh) gets the first such one's: the
    pools are the same on every rank, so its ranks all pick the same."""
    pool = _pool()
    group = pool.groups.get(id(mesh))
    if group is None:
        key = _key_of(mesh)
        group = next((pool.groups[id(m)] for m in pool.meshes
                      if _key_of(m) == key), None)
    if group is None:
        raise ValueError(f"no block group of this rank for the mesh over "
                         f"ranks {mesh.mesh.flatten().tolist()}: a block "
                         f"mesh comes from make_block_mesh, and its groups "
                         f"are its members'")
    return group
