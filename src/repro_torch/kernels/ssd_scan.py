"""Mamba2 SSD chunked scan: the CUDA kernels (``csrc/ssd_scan.cu``) and
their plain versions.

``ssd_scan_cuda`` replaces the Pallas kernel ``repro.kernels.ssd_scan``
and, unlike it, takes an initial state and returns the final state from
its own carry.  ``ssd_scan_torch`` is the arithmetic of
``repro.kernels.ops._ssd_jnp_body`` in plain PyTorch: the sequence cut
into chunks of ``Q = min(chunk, S)`` positions (the tail padded with
``dt = 0``), an fp32 ``(P, N)`` state per (batch, head) carried from chunk
to chunk, and in each chunk the inter-chunk term ``C_t . exp(a_t) h``, the
intra-chunk term ``sum_{j<=t} (C_t . B_j) exp(a_t - a_j) dt_j x_j`` and the
``D`` skip, where ``a`` is the within-chunk cumulative sum of ``dt * A``.
It is used on CPU tensors and as the kernel's yardstick on the card.

The kernel has two routes, chosen from dtype, shape and alignment
(``chunked_route``), never by the caller: the chunked route (bf16; four
device kernels a call: C.B^T once per (batch, chunk), each chunk's
cumulative decay and state from zero, the state passing across chunks,
the outputs; products on the tensor cores with the fp32 operands split
into two or three bf16 parts) and, for anything else, the scalar route (one device
kernel: a block per (batch, head) sweeps the chunks in order on the CUDA
cores).  ``ssd_scan_passes_torch`` is the chunked route's pass structure
in plain PyTorch, for the tests and ``chip_smoke.py``.

Shapes, as ``repro.kernels.ref.ssd_scan``: x (Bt, S, H, P); dt (Bt, S, H)
fp32; A, D (H,) fp32; B, C (Bt, S, N) in x's dtype, shared across heads;
h0 (Bt, H, P, N) fp32 or None (zeros).  Both return y (Bt, S, H, P) in
x's dtype and the fp32 final state (Bt, H, P, N).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: calls of the kernel so far, and those of them that took the scalar
#: route (a run resets them to 0 and reads them afterwards)
LAUNCHES = 0
LAUNCHES_SCALAR = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel keeps a (P, N) state and 64-row tiles of x, B and C in
#: shared memory, P and N each at most 64 wide
MAX_PN = 64
MAX_CHUNK = 4096
#: the chunked route's limits: a chunk's rows, x, B and C in shared memory
#: as bf16, P and N whole 16-wide tensor-core tiles
MAX_CHUNK_CHUNKED = 256


def chunked_route(x, B, C, chunk: int) -> bool:
    """Whether the kernel takes its chunked route: bf16 x, B and C; P and N
    multiples of 16 up to 64; chunks of at most 256 positions; 16-byte
    aligned bases and (batch, sequence) strides of whole 16-byte words (the
    Mamba2 conv output's slices have them)."""
    P, N = x.shape[-1], B.shape[-1]
    if not (x.dtype == B.dtype == C.dtype == torch.bfloat16
            and P % 16 == 0 and N % 16 == 0 and P <= MAX_PN
            and N <= MAX_PN and min(chunk, x.shape[1]) <= MAX_CHUNK_CHUNKED):
        return False
    return all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0
               and t.stride(1) % 8 == 0 for t in (x, B, C))


def ssd_scan_torch(x, dt, A, B, C, D, *, chunk: int = 256, h0=None):
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t, *tail):
        t = F.pad(t.float(), (0, 0) * (t.ndim - 2) + (0, pad))
        return t.reshape(Bt, nc, Q, *tail)

    xc, dtc = chunks(x, H, P), chunks(dt, H)
    Bc, Cc = chunks(B, N), chunks(C, N)
    Af = A.float()
    h = (torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(nc):
        x_c, dt_c, B_c, C_c = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        a = torch.cumsum(dt_c * Af, dim=1)           # (Bt, Q, H)
        # inter-chunk: y_inter[t] = C_t . (exp(a_t) h)
        y_inter = (torch.einsum("bqn,bhpn->bqhp", C_c, h)
                   * torch.exp(a)[..., None])
        # intra-chunk: L[t, j] = exp(a_t - a_j) for t >= j; the exponent
        # overflows above the diagonal, where the mask picks 0
        seg = a[:, :, None, :] - a[:, None, :, :]    # (Bt, Q, Q, H)
        L = torch.where(tri[None, :, :, None], torch.exp(seg), 0.0)
        cb = torch.einsum("bqn,bjn->bqj", C_c, B_c)  # (Bt, Q, Q)
        w = cb[..., None] * L * dt_c[:, None]        # (Bt, Q, Q, H)
        y_intra = torch.einsum("bqjh,bjhp->bqhp", w, x_c)
        # carry: h' = exp(a_Q) h + sum_j exp(a_Q - a_j) dt_j x_j B_j^T
        wj = torch.exp(a[:, -1:] - a) * dt_c         # (Bt, Q, H)
        h = (h * torch.exp(a[:, -1])[..., None, None]
             + torch.einsum("bqhp,bqn->bhpn", x_c * wj[..., None], B_c))
        ys.append(y_inter + y_intra)
    y = torch.stack(ys, 1).reshape(Bt, nc * Q, H, P)[:, :S]
    y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def _parts(t, n: int):
    """An fp32 operand as the chunked route gives it to the tensor cores:
    the sum (in fp32) of ``n`` bf16 parts, each the bf16 rounding of what
    the parts before it leave (1: one bf16 value; 0: t as it is)."""
    if n == 0:
        return t
    out, rest = torch.zeros_like(t), t
    for _ in range(n):
        part = rest.to(torch.bfloat16).float()
        out, rest = out + part, rest - part
    return out


#: bf16 parts of the chunked route's fp32 operands: the decay weights and
#: w_j x_j in three (their rounding drives the outputs' and the final
#: state's distance from the plain version), the entering state in two
KERNEL_PARTS = {"weights": 3, "state_update": 3, "state": 2}


def ssd_scan_passes_torch(x, dt, A, B, C, D, *, chunk: int = 256, h0=None,
                          parts=None):
    """The chunked route's passes in plain PyTorch, same arguments and
    results as ``ssd_scan_torch``: (1) the within-chunk cumulative sums of
    dt * A in sequence order, each product and sum rounded on its own; (2)
    C.B^T once per (batch, chunk); (3) each chunk's state from zero; (4)
    the states passed across chunks from h0; (5) the outputs.  The three
    fp32 operands of the tensor-core products (w_j x_j of the state
    update, the entering state h of C.h, the weights CB exp(a_t - a_j)
    dt_j) are sums of bf16 parts (``_parts``), as many as ``parts``
    gives for each ({"weights", "state_update", "state"}: n, or one n
    for all; ``KERNEL_PARTS`` by default); the bf16 inputs are exact."""
    if parts is None:
        parts = KERNEL_PARTS
    elif isinstance(parts, int):
        parts = dict.fromkeys(KERNEL_PARTS, parts)
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t, *tail):
        t = F.pad(t.float(), (0, 0) * (t.ndim - 2) + (0, pad))
        return t.reshape(Bt, nc, Q, *tail)

    xc, dtc = chunks(x, H, P), chunks(dt, H)
    Bc, Cc = chunks(B, N), chunks(C, N)
    # 1. cumulative sums: a[:, :, r] = (... (dt_0 A + dt_1 A) + ...) + dt_r A
    dA = dtc * A.float()
    a = torch.empty_like(dA)
    run = torch.zeros_like(dA[:, :, 0])
    for r in range(Q):
        run = run + dA[:, :, r]
        a[:, :, r] = run
    # 2. C.B^T, shared by the heads (products of bf16 values are exact)
    cb = torch.einsum("bcqn,bcjn->bcqj", Cc, Bc)
    # 3. each chunk's state from zero: sum_j (w_j x_j) B_j^T
    w = torch.exp(a[:, :, -1:] - a) * dtc                    # (Bt,nc,Q,H)
    local = torch.einsum("bcqhp,bcqn->bchpn",
                         _parts(xc * w[..., None], parts["state_update"]),
                         Bc)
    # 4. the state entering each chunk, and the final state
    h = (torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * torch.exp(a[:, c, -1])[..., None, None] + local[:, c]
    h_in = torch.stack(h_in, 1)                              # (Bt,nc,H,P,N)
    # 5. outputs: exp(a_t) (C_t . h_in) + sum_{j<=t} W[t, j] x_j
    y_inter = (torch.einsum("bcqn,bchpn->bcqhp", Cc,
                            _parts(h_in, parts["state"]))
               * torch.exp(a)[..., None])
    seg = a[:, :, :, None, :] - a[:, :, None, :, :]          # (Bt,nc,Q,Q,H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.where(tri[:, :, None], torch.exp(seg), 0.0)
    W = cb[..., None] * L * dtc[:, :, None]
    y_intra = torch.einsum("bcqjh,bcjhp->bcqhp", _parts(W, parts["weights"]),
                           xc)
    y = (y_inter + y_intra).reshape(Bt, nc * Q, H, P)[:, :S]
    y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def _row_strides(name: str, t: torch.Tensor):
    """(batch, sequence) strides of a (Bt, S, ...) tensor whose values of
    each position are contiguous."""
    tail = 1
    for size, stride in zip(reversed(t.shape[2:]), reversed(t.stride()[2:])):
        if size > 1 and stride != tail:
            raise ValueError(f"ssd_scan_cuda: {name}'s trailing dims must "
                             f"be contiguous, got strides {t.stride()}")
        tail *= size
    return t.stride(0), t.stride(1)


def ssd_scan_cuda(x, dt, A, B, C, D, *, chunk: int = 256, h0=None):
    """The kernel: same arguments and results as ``ssd_scan_torch``, all
    on one CUDA device.  x, B and C may be strided along batch and
    sequence (slices of the Mamba2 conv output) with each position's
    values contiguous; dt, A, D and h0 are contiguous.  The route follows
    from the inputs (``chunked_route``)."""
    global LAUNCHES, LAUNCHES_SCALAR
    if x.ndim != 4:
        raise ValueError(f"ssd_scan_cuda: x must be (Bt, S, H, P), got "
                         f"{tuple(x.shape)}")
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    f32s = [dt, A, D] + ([] if h0 is None else [h0])
    if not (x.is_cuda and all(t.device == x.device for t in [B, C] + f32s)):
        raise ValueError("ssd_scan_cuda needs every tensor on one CUDA "
                         "device")
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan_cuda takes bf16/f32 x with B and C of "
                         f"its dtype, got {x.dtype}, {B.dtype}, {C.dtype}")
    if any(t.dtype != torch.float32 for t in f32s):
        raise ValueError("ssd_scan_cuda takes fp32 dt, A, D and h0")
    shapes = {"dt": (dt, (Bt, S, H)), "A": (A, (H,)), "B": (B, (Bt, S, N)),
              "C": (C, (Bt, S, N)), "D": (D, (H,))}
    if h0 is not None:
        shapes["h0"] = (h0, (Bt, H, P, N))
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"ssd_scan_cuda: {name} {tuple(t.shape)} must "
                             f"be {want}")
    # the grid is (H, Bt): its y dimension holds at most 65535 blocks
    if not (1 <= P <= MAX_PN and 1 <= N <= MAX_PN and S >= 1 and H >= 1
            and 1 <= Bt <= 65535 and 1 <= chunk):
        raise ValueError(f"ssd_scan_cuda: P {P} and N {N} must be in "
                         f"[1, {MAX_PN}], Bt in [1, 65535], S, H and chunk "
                         f"positive")
    Q = min(chunk, S)
    if Q > MAX_CHUNK:
        raise ValueError(f"ssd_scan_cuda: chunk {Q} > {MAX_CHUNK}")
    if not all(t.is_contiguous() for t in f32s):
        raise ValueError("ssd_scan_cuda needs contiguous dt, A, D and h0")
    x_sb, x_ss = _row_strides("x", x)
    b_sb, b_ss = _row_strides("B", B)
    c_sb, c_ss = _row_strides("C", C)
    lib = _build.load()
    y = torch.empty((Bt, S, H, P), dtype=x.dtype, device=x.device)
    h_final = torch.empty((Bt, H, P, N), dtype=torch.float32,
                          device=x.device)
    h0_ptr = None if h0 is None else h0.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if chunked_route(x, B, C, chunk):
            # scratch the passes hand on (and the SSD backward would read):
            # the cumulative sums, C.B^T per (batch, chunk), and each
            # chunk's state from zero, then the state entering it
            nc, Qp = -(-S // Q), -(-Q // 16) * 16
            f32 = dict(dtype=torch.float32, device=x.device)
            acum = torch.empty((Bt, H, nc, Qp), **f32)
            cb = torch.empty((Bt, nc, Qp, Qp), **f32)
            states = torch.empty((Bt, nc, H, P, N), **f32)
            err = lib.ssd_scan_chunked_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), h0_ptr, y.data_ptr(),
                h_final.data_ptr(), acum.data_ptr(), cb.data_ptr(),
                states.data_ptr(), Bt, S, H, P, N, Q, x_sb, x_ss, b_sb,
                b_ss, c_sb, c_ss, stream)
            _build.check(err, "ssd_scan_chunked_launch")
        else:
            err = lib.ssd_scan_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), h0_ptr, y.data_ptr(),
                h_final.data_ptr(), Bt, S, H, P, N, Q, x_sb, x_ss, b_sb,
                b_ss, c_sb, c_ss, DTYPE_CODES[x.dtype], stream)
            _build.check(err, "ssd_scan_launch")
            LAUNCHES_SCALAR += 1
    LAUNCHES += 1
    return y, h_final
