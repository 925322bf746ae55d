"""Mesh builders (the port of ``repro.launch.mesh``).

Functions, not module constants: importing this module never touches a
process group.  Each builds a ``torch.distributed`` DeviceMesh over
ranks of the running process group (``device.init_distributed``), one
rank per device.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


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
    sub-mesh), laid out row-major in ``shape``."""
    if not dist.is_initialized():
        raise RuntimeError("a block mesh needs a process group "
                           "(device.init_distributed)")
    mesh = torch.tensor(list(ranks), dtype=torch.int64).reshape(tuple(shape))
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, mesh, mesh_dim_names=tuple(axis_names))
