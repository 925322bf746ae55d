"""Block-wise int8 quantization for optimizer state (8-bit Adam); the
port of ``repro.train.quantized_state``, bit for bit.

m and v are stored as int8 codes with fp32 absmax scales per 256-element
block along the last dim: ``{"q": int8 of the leaf's shape, "s": f32
(..., ceil(L / 256))}``, a scalar leaf as one 1-element block.  A block's
scale is ``amax / 127`` (1 where amax is 0) and its codes ``round(x /
scale)`` half to even, clipped to +-127; the ragged last block is padded
with zeros.

The fused AdamW kernel and its plain version (``kernels/fused_adamw.py``)
read and write this format, and the optimizer builds its state from it,
as the reference's kernels import ``repro.train.quantized_state``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

BLOCK = 256


def _pad_to_block(x):
    last = x.shape[-1]
    pad = (-last) % BLOCK
    if pad:
        x = F.pad(x, (0, pad))
    return x, pad


def quantize(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """x: fp tensor -> {"q": int8 same shape, "s": f32 (..., nblocks)}."""
    if x.ndim == 0:     # scalar leaf: one 1-element block, shape preserved
        st = quantize(x.reshape(1))
        return {"q": st["q"].reshape(()), "s": st["s"]}
    xf = x.float()
    orig_last = xf.shape[-1]
    xp, _ = _pad_to_block(xf)
    nb = xp.shape[-1] // BLOCK
    blocks = xp.reshape(*xp.shape[:-1], nb, BLOCK)
    amax = blocks.abs().amax(-1)
    # divide by a tensor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which is not IEEE division and can land
    # one ulp off the reference's amax / 127
    scale = torch.where(amax > 0, amax / torch.tensor(127.0,
                                                      device=amax.device),
                        1.0)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127
                    ).to(torch.int8)
    q = q.reshape(xp.shape)[..., :orig_last].contiguous()
    return {"q": q, "s": scale}


def dequantize(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    q, s = state["q"], state["s"]
    if q.ndim == 0:
        return dequantize({"q": q.reshape(1), "s": s}).reshape(())
    orig_last = q.shape[-1]
    qp, _ = _pad_to_block(q.float())
    nb = qp.shape[-1] // BLOCK
    blocks = qp.reshape(*qp.shape[:-1], nb, BLOCK)
    x = blocks * s[..., None]
    return x.reshape(qp.shape)[..., :orig_last]


def zeros_like_quantized(p: torch.Tensor) -> Dict[str, torch.Tensor]:
    last = p.shape[-1] if p.ndim else 1
    nb = -(-last // BLOCK)
    scale_shape = (*p.shape[:-1], nb) if p.ndim else (nb,)
    return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
            "s": torch.ones(scale_shape, dtype=torch.float32,
                            device=p.device)}


def copy_(dst, src) -> None:
    """Copy a moment leaf (an fp32 tensor or a {"q", "s"} dict) into
    another of the same format, in place."""
    if isinstance(dst, dict):
        for k in dst:
            dst[k].copy_(src[k])
    else:
        dst.copy_(src)
