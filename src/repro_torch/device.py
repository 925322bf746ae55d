"""Device resolution shared by the port's entry points.

Entry points default to ``cuda``.  Without a card they raise instead of
running on the host: the CPU path (the kernels' plain PyTorch versions)
runs only when the caller asks for it with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            f"device='cpu' to run the plain PyTorch path on the host")
    return dev
