"""Fused AdamW: the CUDA kernel (``csrc/fused_adamw.cu``) and its plain
version.

``fused_adamw_cuda`` replaces the Pallas kernels
``repro.kernels.fused_adamw._kernel_f32`` and ``_kernel_i8``: one launch
per leaf updates p and the fp32 moments, or p and the int8 moment codes
and their per-256 scales, IN PLACE (the JAX kernel returns fresh arrays;
the port saves the memory of a second copy).  ``fused_adamw_torch`` is the
plain version, ``repro.kernels.ops._fused_adamw_jnp``'s op sequence in
PyTorch, and returns new tensors.

On the card the kernel has two routes, chosen here from the leaf's shape
and alignment (``vector_route``), never by the caller: the vector route
(16-byte loads, a half-warp per quantization block) for a last dim that is
a multiple of 16 on 16-byte aligned buffers, the scalar route (one element
a load) for anything else.  Both give the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.train import quantized_state as qs

#: kernel launches so far by moment format (a run resets them to 0 and
#: reads them afterwards)
LAUNCHES_F32 = 0
LAUNCHES_I8 = 0
#: of those, the launches that took the scalar route
LAUNCHES_SCALAR = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_adamw_torch(p, g, m, v, *, lr, scale, bc1, bc2, b1: float,
                      b2: float, eps: float, weight_decay: float,
                      apply_wd: bool):
    """One leaf's AdamW update; m/v are fp32 tensors or ``quantized_state``
    {"q", "s"} dicts.  Returns (new p, new m, new v) in the inputs'
    formats."""
    quantized = isinstance(m, dict)
    g = g.float() * scale
    m_f = qs.dequantize(m) if quantized else m
    v_f = qs.dequantize(v) if quantized else v
    m_f = b1 * m_f + (1 - b1) * g
    v_f = b2 * v_f + (1 - b2) * g * g
    delta = (m_f / bc1) / (torch.sqrt(v_f / bc2) + eps)
    if apply_wd:
        delta = delta + weight_decay * p.float()
    new_p = (p.float() - lr * delta).to(p.dtype)
    if quantized:
        return new_p, qs.quantize(m_f), qs.quantize(v_f)
    return new_p, m_f, v_f


def _f32(x: float) -> float:
    """A Python double rounded to fp32, as JAX rounds a weak constant."""
    return float(torch.tensor(x, dtype=torch.float32))


def vector_route(p, g, m, v) -> bool:
    """Whether the kernel takes its vector route for this leaf: the last
    dim a multiple of 16 and every buffer 16-byte aligned."""
    bufs = (p, g, m["q"], m["s"], v["q"], v["s"]) if isinstance(m, dict) \
        else (p, g, m, v)
    return (p.ndim >= 1 and p.shape[-1] % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in bufs))


def fused_adamw_cuda(p, g, m, v, scalars, *, b1: float, b2: float,
                     eps: float, weight_decay: float, apply_wd: bool):
    """The kernel, in place on p, m and v.  ``scalars``: 4 fp32 values on
    p's device, (lr, clip scale, bc1, bc2).  p bf16/f32, g bf16/f32 of p's
    shape; m, v fp32 of p's shape or {"q": int8 of p's shape, "s": fp32
    (..., ceil(L / 256))}.  All contiguous on one CUDA device."""
    global LAUNCHES_F32, LAUNCHES_I8, LAUNCHES_SCALAR
    quant = isinstance(m, dict)
    L = p.shape[-1] if p.ndim else 1
    rows = p.numel() // L if L else 0
    if quant:
        nb = -(-L // qs.BLOCK)
        s_shape = (*p.shape[:-1], nb) if p.ndim else (nb,)
        moments = (("m.q", m["q"], p.shape, torch.int8),
                   ("m.s", m["s"], s_shape, torch.float32),
                   ("v.q", v["q"], p.shape, torch.int8),
                   ("v.s", v["s"], s_shape, torch.float32))
    else:
        moments = (("m", m, p.shape, torch.float32),
                   ("v", v, p.shape, torch.float32))
    if not p.is_cuda or p.dtype not in DTYPE_CODES:
        raise ValueError(f"fused_adamw_cuda takes a bf16/f32 p on a CUDA "
                         f"device, got {p.dtype} on {p.device}")
    for name, t, shape, dtype in (("g", g, p.shape, g.dtype),
                                  ("scalars", scalars, (4,), torch.float32),
                                  *moments):
        if (t.device != p.device or t.dtype != dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(f"fused_adamw_cuda: {name} must be a contiguous "
                             f"{dtype} {tuple(shape)} on {p.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if g.dtype not in DTYPE_CODES or not p.is_contiguous():
        raise ValueError("fused_adamw_cuda needs a contiguous p and a "
                         "bf16/f32 g")
    vector = vector_route(p, g, m, v)
    lib = _build.load()
    if quant:
        ptrs = (m["q"].data_ptr(), m["s"].data_ptr(), v["q"].data_ptr(),
                v["s"].data_ptr())
    else:
        ptrs = (m.data_ptr(), None, v.data_ptr(), None)
    with torch.cuda.device(p.device):
        err = lib.fused_adamw_launch(
            p.data_ptr(), g.data_ptr(), *ptrs, scalars.data_ptr(), rows, L,
            _f32(b1), _f32(1 - b1), _f32(b2), _f32(1 - b2), _f32(eps),
            _f32(weight_decay), int(bool(apply_wd)), DTYPE_CODES[p.dtype],
            DTYPE_CODES[g.dtype], int(quant), int(vector),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_adamw_launch")
    if quant:
        LAUNCHES_I8 += 1
    else:
        LAUNCHES_F32 += 1
    if not vector:
        LAUNCHES_SCALAR += 1
    return p, m, v
