"""RMSNorm: the CUDA kernel (``csrc/rmsnorm.cu``) and its plain version.

``rmsnorm_cuda`` replaces the Pallas kernel ``repro.kernels.rmsnorm``;
``rmsnorm_torch`` is the same arithmetic in plain PyTorch, used on CPU
tensors and as the kernel's yardstick on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: kernel launches so far (a run resets it to 0 and reads it afterwards)
LAUNCHES = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 8192


def rmsnorm_torch(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) contiguous bf16/f32 on the card; scale: (d,), same
    dtype.  Returns a new tensor of x's shape and dtype."""
    global LAUNCHES
    d = x.shape[-1]
    if not (x.is_cuda and scale.is_cuda and x.device == scale.device):
        raise ValueError("rmsnorm_cuda needs x and scale on one CUDA device")
    if x.dtype not in DTYPE_CODES or scale.dtype != x.dtype:
        raise ValueError(f"rmsnorm_cuda takes bf16/f32 x with a scale of "
                         f"the same dtype, got {x.dtype}, {scale.dtype}")
    if scale.shape != (d,) or not 1 <= d <= MAX_D:
        raise ValueError(f"rmsnorm_cuda: scale {tuple(scale.shape)} must be "
                         f"({d},) with 1 <= d <= {MAX_D}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_cuda needs contiguous x and scale")
    lib = _build.load()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_launch(
            x.data_ptr(), scale.data_ptr(), y.data_ptr(), x.numel() // d, d,
            float(eps), DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rmsnorm_launch")
    LAUNCHES += 1
    return y
