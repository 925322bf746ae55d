"""Device resolution shared by the port's entry points.

Entry points default to ``cuda``.  Without a card they raise instead of
running on the host: the CPU path (the kernels' plain PyTorch versions)
runs only when the caller asks for it with ``device="cpu"``.
"""
from __future__ import annotations

from typing import List

import torch


def resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            f"device='cpu' to run the plain PyTorch path on the host")
    return dev


def cuda_devices() -> List[torch.device]:
    """Every CUDA device of the host, one per chip of a control plane's
    topology; raises without a card."""
    resolve("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
