"""Device resolution shared by the port's entry points, and the process
group a block of several devices runs in.

Entry points default to ``cuda``.  Without a card they raise instead of
running on the host: the CPU path (the kernels' plain PyTorch versions)
runs only when the caller asks for it with ``device="cpu"``.

A block of several devices runs SPMD: one process (rank) per device,
each running the same launcher, joined in one ``torch.distributed``
process group (NCCL for the card, gloo for the CPU).  On the card a rank
drives ``cuda:<LOCAL_RANK>``.

Under a process group every rank runs the same control plane, and each
chip of its topology belongs to one rank (``Chip``; by default chip *i*
is rank *i*, and with more chips than ranks the chips wrap round onto
the ranks, as a card phase maps three chips onto its one rank).  A
block runs on the ranks of its chips (``block_ranks``), at most one chip
of each, and writes its checkpoints from the first of them
(``is_block_writer``); what the whole control plane writes comes from
world rank 0 (``is_writer``).

The daemon's service mode across ranks (``core.service``) orders every
mutation on rank 0 and sends it to the other ranks over a control
channel: a gloo group over every rank (``control_group``), made beside
the world group, so its entries stay on the host even where the world
group is NCCL, and ``to_ranks``, a ``broadcast_object_list`` over it,
counted in entries and bytes (``CONTROL``).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
from typing import Any, List, Optional, Sequence

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
    control_group(timeout_s)
    return dev


def world_size() -> int:
    """Ranks of the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """Rank 0 of the process group (the only rank without one): the
    writer of what the whole control plane writes, such as the registry's
    state file."""
    return rank() == 0


@dataclasses.dataclass(frozen=True)
class Chip:
    """One chip of a control plane's topology under a process group: the
    rank that drives it and the device it names (a rank runs a block on
    ``rank_device(device.type)``, its own card)."""
    rank: int
    device: Any

    def __str__(self) -> str:
        return f"{self.device}@rank{self.rank}"


def chips(devices: Sequence) -> List:
    """The control plane's chips: under a process group each entry as a
    ``Chip`` (given ones kept, chip *i* of the rest on rank *i* modulo
    the world size); without one, ``devices`` as they are."""
    if not dist.is_initialized():
        return list(devices)
    world = dist.get_world_size()
    return [d if isinstance(d, Chip) else Chip(i % world, d)
            for i, d in enumerate(devices)]


def block_ranks(devices: Sequence) -> List[int]:
    """The ranks of a block's chips, in the block's order (a plain device
    at position *i* is rank *i* modulo the world size, as ``chips``).
    Raises if two of them are one rank's: a rank drives one device of a
    block."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = [d.rank if isinstance(d, Chip) else i % world
             for i, d in enumerate(devices)]
    if len(set(ranks)) != len(ranks):
        raise ValueError(
            f"a block holds at most one chip of each rank: its chips "
            f"{[str(d) for d in devices]} map onto ranks {ranks}")
    return ranks


def device_of(d) -> torch.device:
    """The device a chip entry names (a ``Chip``'s, or the entry)."""
    return resolve(d.device if isinstance(d, Chip) else d)


def is_block_writer(mesh) -> bool:
    """The first rank of a block's mesh: the rank that writes the block's
    checkpoints."""
    return int(mesh.mesh.flatten()[0]) == rank()


def from_rank(src: int, value):
    """``value`` as rank ``src`` has it, on every rank (a broadcast over
    the world group, which every rank enters in the same order); the
    value itself without a process group of several ranks."""
    if world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src)
    return box[0]


#: the control channel's traffic in this process: entries and pickled
#: bytes sent (rank 0) or received (every other rank) by ``to_ranks``
CONTROL = {"entries": 0, "bytes": 0}

_CONTROL = (None, None)      # (the world group it was made beside, it)


def control_group(timeout_s: float = DEFAULT_TIMEOUT_S):
    """The control channel's group: gloo over every rank, made once beside
    the world group (``init_distributed`` makes it as it starts the world;
    a world begun elsewhere gets it at the first call, which every rank
    makes at the same point, as every group's creation)."""
    global _CONTROL
    world = dist.group.WORLD
    if _CONTROL[0] is not world:
        _CONTROL = (world, dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=timeout_s)))
    return _CONTROL[1]


def to_ranks(value=None, src: int = 0, what: str = "the value"):
    """``value`` from rank ``src`` on every rank, over the control group
    (a ``broadcast_object_list`` of its pickle, which ``src`` makes
    first, so ``what`` that does not pickle raises a ``TypeError`` there
    before any rank waits); counted in ``CONTROL``.  Also at world 1,
    where it passes through the group all the same."""
    data = None
    if rank() == src:
        try:
            data = pickle.dumps(value)
        except Exception as e:
            raise TypeError(f"{what} do not pickle, so rank {src} cannot "
                            f"send them to the other ranks: {e!r}") from e
    box = [data]
    dist.broadcast_object_list(box, src=src, group=control_group())
    CONTROL["entries"] += 1
    CONTROL["bytes"] += len(box[0])
    return pickle.loads(box[0])
