"""int8 gradient compression with error feedback for the cross-pod axis
(the port of ``repro.train.grad_compression``).

Per-tensor absmax int8 quantization; the quantization error is fed back
into the next microbatch's gradients (EF-SGD).  The functions work on
this rank's pod-local tensors, or on the local shards of DTensors, and
reduce over the ``pod`` group of a ``torch.distributed`` DeviceMesh.

The shared scale is each *whole* leaf's absmax, taken over every pod
(the reference's ``pmax`` over pods of a leaf GSPMD holds sharded over
``data`` and ``model``): the local absmaxes of all leaves go into one
vector and one MAX all-reduce over every rank of the block agrees on
them.  The codes' sum over the pods gives the reference's integers
exactly: the int8 codes are all-gathered over the pods and summed
locally in int32, so a rank receives (n - 1) bytes an element.  The
reference's own ``psum`` widens the codes to int32 first, and a ring
all-reduce of those receives 2 (n - 1) / n x 4 bytes an element: as many
as fp32, so its "4x fewer bytes" does not hold for its code as written.

The reference's numbers differ by how they run: called eagerly, its
``quantize`` divides the absmax by 127 and ``compress_residual`` rounds
the product and the difference apart; jitted, as its reduce always runs,
XLA multiplies by the fp32 reciprocal of 127 and fuses the residual into
one multiply-add.  ``quantize``, ``dequantize`` and ``compress_residual``
give the eager numbers, ``start_pod_reduce`` (and the functions on it)
the jitted ones, each bit for bit.  Every other division is by a tensor
on the data's device: CUDA divides by a Python scalar through its
reciprocal, and the codes would then part from the reference's.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

#: the largest code (``bits=8``)
QMAX = 127


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _scale_of(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """amax / qmax where amax > 0, else 1.0 (fp32, amax's shape)."""
    return torch.where(amax > 0, amax / _f32(qmax, amax), _f32(1.0, amax))


def _codes(gf: torch.Tensor, scale: torch.Tensor, qmax: float):
    """round(gf / scale), half to even, clamped to +-qmax: fp32 values
    that are the codes exactly (one temporary, rounded and clamped in
    place)."""
    return torch.div(gf, scale).round_().clamp_(-qmax, qmax)


def quantize(g, *, bits: int = 8):
    """Per-tensor symmetric absmax quantization -> (int8 codes, scale)."""
    gf = g.to(torch.float32)
    qmax = 2.0 ** (bits - 1) - 1
    scale = _scale_of(torch.amax(torch.abs(gf)), qmax)
    return _codes(gf, scale, qmax).to(torch.int8), scale


def dequantize(codes, scale):
    return codes.to(torch.float32) * scale


def compress_residual(g, err):
    """Apply error feedback, quantize, return (codes, scale, new_err)."""
    gf = g.to(torch.float32) + err
    codes, scale = quantize(gf)
    new_err = gf - dequantize(codes, scale)
    return codes, scale, new_err


def init_error_feedback(params):
    """fp32 zeros shaped as each leaf (a DTensor's local shard)."""
    return pytree.tree_map(
        lambda p: torch.zeros(_local(p).shape, dtype=torch.float32,
                              device=_local(p).device), params)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _sizes(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


class PodReduce:
    """A compressed pod reduce in flight: ``wait()`` gives the pod-mean
    leaves (fp32, this rank's local shapes) once its collective ended."""

    def __init__(self, work, gathered, scales, shapes, n_pods):
        self._work = work
        self._gathered = gathered     # (n_pods, n_elems) int8: every pod's
        self.scales = scales          # (n_leaves,) fp32: the shared scales
        self._shapes = shapes
        self.n_pods = n_pods

    def wait(self, into=None) -> Optional[List[torch.Tensor]]:
        """The pod-mean leaves; with ``into``, each handed to
        ``into(i, leaf)`` as it is made (one leaf's fp32 at a time) and
        None returned."""
        self._work.wait()
        buf = self._gathered
        n = _f32(float(self.n_pods), self.scales)
        out, off = [], 0
        for i, shape in enumerate(self._shapes):
            k = 1
            for d in shape:
                k *= d
            # the pods' codes summed, a leaf at a time: exact integers
            # (|sum| <= 127 n), held in int32 as the reference's psum
            # holds them
            t = (buf[:, off:off + k].sum(0, dtype=torch.int32)
                 .to(torch.float32).reshape(shape))
            t.mul_(self.scales[i]).div_(n)
            if into is None:
                out.append(t)
            else:
                into(i, t)
            off += k
        self._gathered = None
        return out if into is None else None


def _pod_group(mesh, pod_axis: str):
    names = tuple(mesh.mesh_dim_names or ())
    if pod_axis not in names:
        raise ValueError(f"the mesh {names} has no axis {pod_axis!r}")
    return mesh.get_group(pod_axis)


def _block_group(mesh):
    from repro_torch.launch.mesh import block_group
    return block_group(mesh)


#: elements of a leaf whose residual is taken at a time (its float64
#: temporaries stay at 512 MB each)
RESIDUAL_CHUNK = 1 << 26


def pod_scales(amax: torch.Tensor) -> torch.Tensor:
    """The shared scales of the pod reduce from the leaves' absmaxes:
    amax / 127 as the jitted reference computes it, XLA having turned
    the division by the constant into a product with its fp32
    reciprocal (eager, ``quantize`` divides); 1.0 where amax is 0."""
    return torch.where(amax > 0, amax * _f32(1.0 / QMAX, amax),
                       _f32(1.0, amax))


def pod_quantize_(e: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """One leaf of the pod reduce: the codes of gf (``e`` on entry, fp32)
    at ``scale``, as fp32 values, and e = gf - codes * scale in place
    (``_residual``)."""
    q = _codes(e, scale, float(QMAX))
    _residual(e, q, scale)
    return q


def _residual(e: torch.Tensor, q: torch.Tensor, scale: torch.Tensor):
    """e = gf - codes * scale in place, rounded once, as the reference's
    jitted reduce gives it: XLA fuses the product into the subtraction
    (a fused multiply-add).  The product of a code (7 bits) and the
    scale (24) and its difference with gf are exact in float64, so the
    one rounding is the cast back."""
    s = scale.to(torch.float64)
    for ec, qc in zip(e.view(-1).split(RESIDUAL_CHUNK),
                      q.view(-1).split(RESIDUAL_CHUNK)):
        ec.copy_(ec.to(torch.float64).addcmul_(qc, s, value=-1))


def start_pod_reduce(grads: List[torch.Tensor], errs: List[torch.Tensor],
                     mesh, pod_axis: str = "pod") -> PodReduce:
    """Issue the compressed pod reduce of ``grads`` (this rank's local
    tensors) with the error feedback ``errs`` (fp32, the same shapes),
    and return it in flight.  ``errs`` become the new error feedback in
    place: gf = g + e, the shared scale of each leaf from one MAX
    all-reduce of the leaves' absmaxes over every rank of the block,
    the int8 codes of gf, and e = gf - codes * scale (``_residual``).
    The codes' all-gather over the pods runs asynchronously; the leaves
    travel in one buffer, in order."""
    n_pods = _sizes(mesh)[pod_axis]
    pod_group = _pod_group(mesh, pod_axis)
    device = errs[0].device if errs else torch.device("cpu")
    amax = []
    for g, e in zip(grads, errs):
        e.add_(g)                                   # gf, in place
        # max |gf| in one pass (no |gf| temporary)
        amax.append(torch.linalg.vector_norm(e, float("inf")) if e.numel()
                    else torch.zeros((), device=device))
    amax = torch.stack(amax) if amax else torch.zeros(0, device=device)
    if dist.is_initialized():
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=_block_group(mesh))
    scales = pod_scales(amax)
    total = sum(e.numel() for e in errs)
    codes = torch.empty(total, dtype=torch.int8, device=device)
    off = 0
    for i, e in enumerate(errs):
        q = pod_quantize_(e, scales[i])
        codes[off:off + e.numel()].view(e.shape).copy_(q)
        off += e.numel()
        del q
    shapes = [tuple(e.shape) for e in errs]
    flat = torch.empty(n_pods * total, dtype=torch.int8, device=device)
    work = dist.all_gather_into_tensor(flat, codes, group=pod_group,
                                       async_op=True)
    return PodReduce(work, flat.view(n_pods, total), scales, shapes, n_pods)


def compressed_psum_pod(grads, err, mesh,
                        pod_axis: str = "pod") -> Tuple[Any, Any]:
    """Mean-reduce ``grads`` over the pod axis in int8 with error feedback.

    grads/err: pytrees whose leaves are *pod-local* gradients (tensors,
    or DTensors whose local shards are this rank's) and fp32 error
    feedback of the same local shapes.  Returns the pod-mean gradients
    (fp32, this rank's local shards) and the new error-feedback tree (a
    new tree; ``err`` is not changed)."""
    flat_g, _ = pytree.tree_flatten(grads)
    flat_e, spec = pytree.tree_flatten(err)
    new = [_local(e).to(torch.float32).clone() for e in flat_e]
    red = start_pod_reduce([_local(g) for g in flat_g], new, mesh,
                           pod_axis).wait()
    return (pytree.tree_unflatten(red, pytree.tree_flatten(grads)[1]),
            pytree.tree_unflatten(new, spec))


def compressed_allreduce(grads, err, mesh, pod_axis: str = "pod"):
    """``compressed_psum_pod`` with each DTensor leaf's result placed as
    the leaf is (its local shard of the pod mean, on every pod the
    same), other leaves as local tensors."""
    red, new = compressed_psum_pod(grads, err, mesh, pod_axis)
    flat_g, spec = pytree.tree_flatten(grads)
    out = [DTensor.from_local(r, g.device_mesh, g.placements,
                              run_check=False) if isinstance(g, DTensor)
           else r for g, r in zip(flat_g, pytree.tree_leaves(red))]
    return pytree.tree_unflatten(out, spec), new


def pod_bytes(n_elems: int, n_leaves: int, n_pods: int,
              block_ranks: int) -> dict:
    """Computed, not measured: the bytes one rank sends and receives for
    one compressed pod reduce of ``n_elems`` local elements in
    ``n_leaves`` leaves: the int8 all-gather's (n - 1) bytes an element
    over the pod group, and the scales' ring MAX all-reduce (4 bytes a
    leaf) over the block's ``block_ranks``."""
    payload = (n_pods - 1) * n_elems
    scales = 2 * (block_ranks - 1) * 4 * n_leaves // block_ranks
    return {"payload": int(payload), "scales": int(scales)}
