"""RMSNorm: the CUDA kernels (``csrc/rmsnorm.cu``) and their plain
versions.

``rmsnorm_cuda`` replaces the Pallas kernel ``repro.kernels.rmsnorm``;
``rmsnorm_torch`` is the same arithmetic in plain PyTorch, used on CPU
tensors and as the kernel's yardstick on the card.  ``rmsnorm_bwd_cuda``
is the backward, the counterpart of autodiff of ``repro.kernels.ops.
rmsnorm``; its plain version ``rmsnorm_bwd_torch`` is autograd of
``rmsnorm_torch``.

Each direction has two routes, chosen from dtype, width, alignment and
(forward) row stride, never by the caller, with no fallback from one to
the other.  The forward (``fwd_route``): the vector route (each row read
once into registers, a warp per row up to 256 16-byte vectors and a block
per row past that, the next row in flight) and the scalar route (the first
design: a block per row, two passes).  Both read x's rows at a stride
(``row_stride``), so a slice of wider rows needs no copy.  The backward
(``bwd_vector_route``): the vector route (rows held in registers, 16-byte
loads, the next row in flight, a wide ordered sum of the dscale partials)
and the scalar route (one element a thread at a time, the design before).
``LAUNCHES_SCALAR`` and ``BWD_LAUNCHES_SCALAR`` count the calls that took
a scalar route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: forward and backward kernel launches so far (a run resets them to 0
#: and reads them afterwards)
LAUNCHES = 0
BWD_LAUNCHES = 0
#: the forward and backward calls that took the scalar route
LAUNCHES_SCALAR = 0
BWD_LAUNCHES_SCALAR = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 8192
#: the backward's row chunks: at most two blocks for each of the H100's
#: 132 SMs, each writing one fp32 partial row of dscale
MAX_BWD_BLOCKS = 264


def rmsnorm_torch(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


def row_stride(x: torch.Tensor):
    """The stride, in elements, between consecutive rows of x's (..., d)
    rows taken as one run, or None when there is none: the last dimension
    not contiguous, or leading dimensions that do not collapse into one
    (a slice ``kv_a[..., :R]`` of contiguous rows has one, ``x[:, :k]`` of
    a (B, S, d) tensor with 1 < k < S and B > 1 has none)."""
    if x.dim() == 0 or (x.shape[-1] > 1 and x.stride(-1) != 1):
        return None
    stride = span = None
    for size, st in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
        if size == 1:
            continue
        if stride is None:
            stride = st
        elif st != span:
            return None
        span = st * size
    return x.shape[-1] if stride is None else stride


def fwd_route(x: torch.Tensor, scale: torch.Tensor) -> str:
    """The route the forward kernel takes: ``"vector"`` for rows of whole
    16-byte words (d a multiple of 8 bf16 or 4 f32, up to ``MAX_D``) at a
    row stride of whole 16-byte words, on 16-byte aligned x and scale (y
    is allocated aligned); ``"scalar"`` for anything else."""
    vec = 16 // x.element_size()
    stride = row_stride(x)
    ok = (x.shape[-1] % vec == 0 and x.shape[-1] <= MAX_D
          and stride is not None and stride % vec == 0
          and x.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0)
    return "vector" if ok else "scalar"


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) bf16/f32 on the card, its rows at one stride
    (``row_stride``: contiguous, or a slice of wider contiguous rows);
    scale: (d,), same dtype, contiguous.  Returns a new contiguous tensor
    of x's shape and dtype, by the route ``fwd_route`` names."""
    d = x.shape[-1]
    if not (x.is_cuda and scale.is_cuda and x.device == scale.device):
        raise ValueError("rmsnorm_cuda needs x and scale on one CUDA device")
    if x.dtype not in DTYPE_CODES or scale.dtype != x.dtype:
        raise ValueError(f"rmsnorm_cuda takes bf16/f32 x with a scale of "
                         f"the same dtype, got {x.dtype}, {scale.dtype}")
    if scale.shape != (d,) or not 1 <= d <= MAX_D:
        raise ValueError(f"rmsnorm_cuda: scale {tuple(scale.shape)} must be "
                         f"({d},) with 1 <= d <= {MAX_D}")
    if row_stride(x) is None or not scale.is_contiguous():
        raise ValueError("rmsnorm_cuda needs x's rows at one stride (its "
                         "last dimension contiguous) and a contiguous scale")
    return _launch(x, scale, eps, fwd_route(x, scale))


def _launch(x, scale, eps, route):
    """One launch of the forward kernel by ``route`` on checked inputs.
    ``rmsnorm_cuda`` passes ``fwd_route``'s choice; the vector route
    refuses (raises on) inputs it does not take."""
    global LAUNCHES, LAUNCHES_SCALAR
    d = x.shape[-1]
    lib = _build.load()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_launch(
            x.data_ptr(), scale.data_ptr(), y.data_ptr(), x.numel() // d, d,
            row_stride(x), float(eps), DTYPE_CODES[x.dtype],
            int(route == "vector"), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rmsnorm_launch")
    LAUNCHES += 1
    LAUNCHES_SCALAR += route == "scalar"
    return y


def bwd_vector_route(x: torch.Tensor, scale: torch.Tensor,
                     g: torch.Tensor) -> bool:
    """Whether the backward kernel takes its vector route: rows of whole
    16-byte words (d a multiple of 8 bf16 or 4 f32) on 16-byte aligned x,
    scale and g (dx is allocated aligned)."""
    vec = 16 // x.element_size()
    return (x.shape[-1] % vec == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, scale, g)))


def rmsnorm_bwd_torch(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                      eps: float = 1e-6):
    """(dx, dscale) of ``rmsnorm_torch`` by autograd, for the incoming
    gradient ``g`` of the output."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        sr = scale.detach().requires_grad_(True)
        dx, ds = torch.autograd.grad(rmsnorm_torch(xr, sr, eps), (xr, sr), g)
    return dx, ds


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-6):
    """The backward kernel: same arguments and result as
    ``rmsnorm_bwd_torch``; x and g contiguous, of x's shape and dtype, on
    the card."""
    global BWD_LAUNCHES, BWD_LAUNCHES_SCALAR
    d = x.shape[-1]
    if not (x.is_cuda and scale.device == x.device and g.device == x.device):
        raise ValueError("rmsnorm_bwd_cuda needs x, scale and g on one CUDA "
                         "device")
    if (x.dtype not in DTYPE_CODES or scale.dtype != x.dtype
            or g.dtype != x.dtype):
        raise ValueError(f"rmsnorm_bwd_cuda takes bf16/f32 x, scale, g of "
                         f"one dtype, got {x.dtype}, {scale.dtype}, "
                         f"{g.dtype}")
    if (scale.shape != (d,) or g.shape != x.shape or not 1 <= d <= MAX_D):
        raise ValueError(f"rmsnorm_bwd_cuda: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}, g {tuple(g.shape)} disagree "
                         f"or d > {MAX_D}")
    if not (x.is_contiguous() and scale.is_contiguous()
            and g.is_contiguous()):
        raise ValueError("rmsnorm_bwd_cuda needs contiguous x, scale, g")
    rows = x.numel() // d
    blocks = max(1, min(rows, MAX_BWD_BLOCKS))
    lib = _build.load()
    dx = torch.empty_like(x)
    ds = torch.empty_like(scale)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    vector = bwd_vector_route(x, scale, g)
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_bwd_launch(
            x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
            ds.data_ptr(), partial.data_ptr(), rows, d, float(eps), blocks,
            DTYPE_CODES[x.dtype], int(vector),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rmsnorm_bwd_launch")
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_SCALAR += not vector
    return dx, ds
