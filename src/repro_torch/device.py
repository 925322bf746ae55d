"""Device resolution shared by the port's entry points, and the process
group a block of several devices runs in.

Entry points default to ``cuda``.  Without a card they raise instead of
running on the host: the CPU path (the kernels' plain PyTorch versions)
runs only when the caller asks for it with ``device="cpu"``.

A block of several devices runs SPMD: one process (rank) per device,
each running the same launcher, joined in one ``torch.distributed``
process group (NCCL for the card, gloo for the CPU).  On the card a rank
drives ``cuda:<LOCAL_RANK>``.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist


def resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            f"device='cpu' to run the plain PyTorch path on the host")
    return dev


def cuda_devices() -> List[torch.device]:
    """One CUDA device per chip of a control plane's topology: under a
    process group, each rank's (``cuda:<rank>``, one host), else every
    CUDA device of the host; raises without a card."""
    resolve("cuda")
    if dist.is_initialized():
        return [torch.device("cuda", r) for r in range(dist.get_world_size())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK>`` for ``cuda``, else the
    device itself (``cpu``)."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


#: seconds a collective (and the group's rendezvous) waits before it
#: raises, so a rank that dies does not hang the others
DEFAULT_TIMEOUT_S = 600.0


def init_distributed(device="cuda", *, timeout_s: float = DEFAULT_TIMEOUT_S,
                     store: Optional[dist.Store] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Start or join the process group and return this rank's device.

    NCCL for a CUDA device (the rank's card made current), gloo for the
    CPU.  Without ``store`` the rendezvous comes from the environment
    ``torch.distributed.run`` sets (``MASTER_ADDR``, ``RANK``,
    ``WORLD_SIZE``); a caller with a ``HashStore`` or ``FileStore`` gives
    ``rank`` and ``world_size``.  A group already running is joined as it
    is."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = dict(backend=backend,
              timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kw.update(store=store, rank=rank, world_size=world_size)
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return dev


def world_size() -> int:
    """Ranks of the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer() -> bool:
    """Rank 0 of the process group (the only rank without one)."""
    return not dist.is_initialized() or dist.get_rank() == 0
