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

The backward (``ssd_scan_bwd_cuda``, ``csrc/ssd_scan_bwd.cu``; plain
version ``ssd_scan_bwd_torch``) is the counterpart of autodiff of
``repro.kernels.ops._ssd_jnp``: from the cotangents of y and of the final
state, those of x, dt, A, B, C, D and h0.  It recomputes the cumulative
sums, C.B^T and the entering states from the inputs, whichever forward
route ran.  It too has two routes, chosen from dtype, shape and alignment
(``bwd_chunked_route``): the tensor-core route (bf16; nine device
kernels, the products on ``mma.sync`` with the fp32 operands split into
bf16 parts, the heads of dCB spread over groups of blocks whose partials
are summed in order) and the scalar route (any dtype; seven device
kernels, fp32 tile products on the CUDA cores).
``ssd_scan_bwd_passes_torch`` is the tensor-core route's pass structure
in plain PyTorch.

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
#: route; the same two for the backward kernel (a run resets them to 0
#: and reads them afterwards)
LAUNCHES = 0
LAUNCHES_SCALAR = 0
BWD_LAUNCHES = 0
BWD_LAUNCHES_SCALAR = 0

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


def bwd_chunked_route(x, B, C, dy, chunk: int) -> bool:
    """Whether the backward kernel takes its tensor-core route: where the
    forward takes its chunked route (``chunked_route``), with a 16-byte
    aligned dy beside it."""
    return chunked_route(x, B, C, chunk) and dy.data_ptr() % 16 == 0


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
        # intra-chunk: L[t, j] = exp(a_t - a_j) for t >= j, 0 above the
        # diagonal; the mask goes on the exponent (-inf), where the
        # exponent would overflow and its gradient there would be inf * 0
        seg = a[:, :, None, :] - a[:, None, :, :]    # (Bt, Q, Q, H)
        L = torch.exp(torch.where(tri[None, :, :, None], seg, -torch.inf))
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


def ssd_scan_bwd_torch(x, dt, A, B, C, D, dy, dh_final=None, *,
                       chunk: int = 256, h0=None):
    """The SSD scan's backward in plain PyTorch, as explicit chunk passes:
    the cotangents (dx, ddt, dA, dB, dC, dD, dh0) of ``ssd_scan_torch``'s
    inputs for the cotangents ``dy`` of y and ``dh_final`` of the final
    state (None: zeros).  dx, dB and dC come back in their inputs' dtypes;
    ddt, dA, dD and dh0 in fp32 (fp64 for fp64 inputs, to measure what
    fp32 summation alone moves).  Per (batch, head) and chunk, with a the
    within-chunk cumulative sum of dt * A:

    1. each chunk's state from zero, ``sum_j exp(a_Q - a_j) dt_j x_j
       B_j^T``, and its share of the entering state's cotangent, ``sum_t
       exp(a_t) dy_t C_t^T``;
    2. the states entering the chunks, forward from h0, and the cotangent
       G_c of the state leaving chunk c, in reverse from dh_final:
       ``G_{c-1} = exp(a_Q^c) G_c + sum_t exp(a_t) dy_t C_t^T``; dh0 is
       that sum for c = 0;
    3. within each chunk the transposed causal triangle of ``W[t, j] =
       CB[t, j] exp(a_t - a_j) dt_j`` (the exponent taken only where t >=
       j) gives dx, and its cotangent, summed over the heads, dB and dC;
       the state terms add theirs;
    4. the cotangent of a, reverse-summed within the chunk, is that of dt
       * A: ``d(dt A)_j = sum_{t >= j} da_t``, whence ddt and dA.

    Padded tail rows (dt, x, B, C and dy zero) contribute nothing."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t, *tail):
        t = F.pad(t.to(ct), (0, 0) * (t.ndim - 2) + (0, pad))
        return t.reshape(Bt, nc, Q, *tail)

    xc, dyc, dtc = chunks(x, H, P), chunks(dy, H, P), chunks(dt, H)
    Bc, Cc = chunks(B, N), chunks(C, N)
    Af = A.to(ct)
    a = torch.cumsum(dtc * Af, dim=2)                     # (Bt,nc,Q,H)
    a_last = a[:, :, -1]                                  # (Bt,nc,H)
    e = torch.exp(a)
    w = torch.exp(a_last[:, :, None] - a) * dtc           # (Bt,nc,Q,H)
    # 1. chunk-local states and the local sums of the cotangent
    local = torch.einsum("bcqh,bcqhp,bcqn->bchpn", w, xc, Bc)
    dyC = torch.einsum("bcqh,bcqhp,bcqn->bchpn", e, dyc, Cc)
    # 2. the states entering each chunk; G_c, the cotangent of the state
    # leaving chunk c
    decay = torch.exp(a_last)[..., None, None]            # (Bt,nc,H,1,1)
    h = (torch.zeros((Bt, H, P, N), dtype=ct, device=x.device)
         if h0 is None else h0.to(ct))
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * decay[:, c] + local[:, c]
    G = (torch.zeros((Bt, H, P, N), dtype=ct, device=x.device)
         if dh_final is None else dh_final.to(ct))
    Gs = [None] * nc
    for c in reversed(range(nc)):
        Gs[c] = G
        G = G * decay[:, c] + dyC[:, c]
    dh0 = G
    h_in, Gs = torch.stack(h_in, 1), torch.stack(Gs, 1)  # (Bt,nc,H,P,N)
    # 3. within each chunk: L[t, j] = exp(a_t - a_j) for t >= j
    seg = a[:, :, :, None, :] - a[:, :, None, :, :]       # (Bt,nc,Q,Q,H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.where(tri[:, :, None], torch.exp(seg), 0.0)
    del seg
    cb = torch.einsum("bcqn,bcjn->bcqj", Cc, Bc)          # (Bt,nc,Q,Q)
    dW = torch.einsum("bcqhp,bcjhp->bcqjh", dyc, xc)      # dy_t . x_j
    W = cb[..., None] * L * dtc[:, :, None]
    U = torch.einsum("bcqhp,bchpn->bcqhn", dyc, h_in)     # dy_t h_in
    V = torch.einsum("bcjhp,bchpn->bcjhn", xc, Gs)        # x_j G
    dx = (torch.einsum("bcqjh,bcqhp->bcjhp", W, dyc)
          + w[..., None] * torch.einsum("bcjn,bchpn->bcjhp", Bc, Gs)
          + dyc * D.to(ct)[:, None])
    dCB = (dW * L * dtc[:, :, None]).sum(-1)              # over the heads
    dC = (torch.einsum("bcqj,bcjn->bcqn", dCB, Bc)
          + torch.einsum("bcqh,bcqhn->bcqn", e, U))
    dB = (torch.einsum("bcqj,bcqn->bcjn", dCB, Cc)
          + torch.einsum("bcjh,bcjhn->bcjn", w, V))
    # 4. the cotangent of a: the intra-chunk weights, the inter-chunk term,
    # the state update (a_Q enters every w_j and the decay of h_in)
    M = W * dW
    dw = torch.einsum("bcjhn,bcjn->bcjh", V, Bc)
    da = (M.sum(3) - M.sum(2)
          + e * torch.einsum("bcqhn,bcqn->bcqh", U, Cc) - w * dw)
    da[:, :, -1] += (torch.exp(a_last) * (Gs * h_in).sum((-1, -2))
                     + (w * dw).sum(2))
    ddt = ((cb[..., None] * L * dW).sum(2)
           + torch.exp(a_last[:, :, None] - a) * dw)
    del L, W, dW, M
    ddA = torch.flip(torch.cumsum(torch.flip(da, [2]), 2), [2])
    ddt = ddt + Af * ddA
    dA = (ddA * dtc).sum((0, 1, 2))
    dD = (dy.to(ct) * x.to(ct)).sum((0, 1, 3))

    def rows(t, *tail):
        return t.reshape(Bt, nc * Q, *tail)[:, :S]

    return (rows(dx, H, P).to(x.dtype), rows(ddt, H), dA,
            rows(dB, N).to(B.dtype), rows(dC, N).to(C.dtype), dD, dh0)


#: bf16 parts of the backward's tensor-core operands that are fp32 (see
#: ``ssd_scan_bwd_passes_torch``): w_j x_j and exp(a_t) dy_t of the chunk
#: pass, the entering states h_in and their cotangents G (U, V and dx's
#: state term), the weights W of dx, dCB of the intra-chunk dB and dC
BWD_KERNEL_PARTS = {"chunk": 2, "state": 2, "weights": 2, "dcb": 2}


def ssd_scan_bwd_passes_torch(x, dt, A, B, C, D, dy, dh_final=None, *,
                              chunk: int = 256, h0=None, parts=None):
    """The backward's tensor-core route in plain PyTorch, same arguments
    and results as ``ssd_scan_bwd_torch``, pass by pass: (1) the
    within-chunk cumulative sums of dt * A in sequence order, each product
    and sum rounded on its own, and each chunk's state and the local sum
    of its cotangent, ``sum_j (w_j x_j)^T B_j`` and ``sum_t (exp(a_t)
    dy_t)^T C_t``; (2) the states entering the chunks and the cotangents G
    of those leaving them; (3) C.B^T and dW = dy_t . x_j, whence dCB,
    summed over the heads, and the intra-chunk shares of da and ddt; (4)
    dx; (5) U = dy_t h_in and V = x_j G, whence dC and dB with the
    intra-chunk terms dCB B and dCB^T C; (6) da, reverse-summed in the
    chunk, gives ddt and dA.  The fp32 operands of the tensor-core
    products are sums of bf16 parts (``_parts``), as many as ``parts``
    gives for each ({"chunk", "state", "weights", "dcb"}: n, or one n for
    all; ``BWD_KERNEL_PARTS`` by default); the bf16 inputs are exact, and
    the products of two of them (C.B^T, dW) are exact in fp32."""
    if parts is None:
        parts = BWD_KERNEL_PARTS
    elif isinstance(parts, int):
        parts = dict.fromkeys(BWD_KERNEL_PARTS, parts)
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t, *tail):
        t = F.pad(t.float(), (0, 0) * (t.ndim - 2) + (0, pad))
        return t.reshape(Bt, nc, Q, *tail)

    xc, dyc, dtc = chunks(x, H, P), chunks(dy, H, P), chunks(dt, H)
    Bc, Cc = chunks(B, N), chunks(C, N)
    Af = A.float()
    # 1. cumulative sums, then the chunk-local states and cotangent sums
    dA_ = dtc * Af
    a = torch.empty_like(dA_)
    run = torch.zeros_like(dA_[:, :, 0])
    for r in range(Q):
        run = run + dA_[:, :, r]
        a[:, :, r] = run
    a_last = a[:, :, -1]
    e = torch.exp(a)
    w = torch.exp(a_last[:, :, None] - a) * dtc
    local = torch.einsum("bcqhp,bcqn->bchpn",
                         _parts(xc * w[..., None], parts["chunk"]), Bc)
    dyC = torch.einsum("bcqhp,bcqn->bchpn",
                       _parts(dyc * e[..., None], parts["chunk"]), Cc)
    # 2. entering states forward from h0; G in reverse from dh_final
    decay = torch.exp(a_last)[..., None, None]
    f32 = dict(dtype=torch.float32, device=x.device)
    h = torch.zeros((Bt, H, P, N), **f32) if h0 is None else h0.float()
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * decay[:, c] + local[:, c]
    G = (torch.zeros((Bt, H, P, N), **f32) if dh_final is None
         else dh_final.float())
    Gs = [None] * nc
    for c in reversed(range(nc)):
        Gs[c] = G
        G = G * decay[:, c] + dyC[:, c]
    dh0 = G
    h_in, Gs = torch.stack(h_in, 1), torch.stack(Gs, 1)
    # 3. C.B^T, dW, and L[t, j] = exp(a_t - a_j), the exponent only where
    # t >= j
    seg = a[:, :, :, None, :] - a[:, :, None, :, :]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tri[:, :, None], seg, -torch.inf))
    del seg
    cb = torch.einsum("bcqn,bcjn->bcqj", Cc, Bc)
    dW = torch.einsum("bcqhp,bcjhp->bcqjh", dyc, xc)
    W = cb[..., None] * L * dtc[:, :, None]
    dCB = (dW * L * dtc[:, :, None]).sum(-1)
    M = W * dW
    q_ddt = (cb[..., None] * L * dW).sum(2)
    # 4. dx: the transposed causal triangle, the state term, the D skip
    Gp = _parts(Gs, parts["state"])
    dx = (torch.einsum("bcqjh,bcqhp->bcjhp", _parts(W, parts["weights"]),
                       dyc)
          + w[..., None] * torch.einsum("bcjn,bchpn->bcjhp", Bc, Gp)
          + dyc * D.float()[:, None])
    del L, W, dW
    # 5. dB and dC
    U = torch.einsum("bcqhp,bchpn->bcqhn", dyc,
                     _parts(h_in, parts["state"]))
    V = torch.einsum("bcjhp,bchpn->bcjhn", xc, Gp)
    dCBp = _parts(dCB, parts["dcb"])
    dC = (torch.einsum("bcqj,bcjn->bcqn", dCBp, Bc)
          + torch.einsum("bcqh,bcqhn->bcqn", e, U))
    dB = (torch.einsum("bcqj,bcqn->bcjn", dCBp, Cc)
          + torch.einsum("bcjh,bcjhn->bcjn", w, V))
    # 6. da from the intra-chunk weights, the inter-chunk term and the
    # state update
    dw = torch.einsum("bcjhn,bcjn->bcjh", V, Bc)
    da = (M.sum(3) - M.sum(2)
          + e * torch.einsum("bcqhn,bcqn->bcqh", U, Cc) - w * dw)
    da[:, :, -1] += (torch.exp(a_last) * (Gs * h_in).sum((-1, -2))
                     + (w * dw).sum(2))
    del M
    ddA = torch.flip(torch.cumsum(torch.flip(da, [2]), 2), [2])
    ddt = q_ddt + torch.exp(a_last[:, :, None] - a) * dw + Af * ddA
    dA = (ddA * dtc).sum((0, 1, 2))
    dD = (dy.float() * x.float()).sum((0, 1, 3))

    def rows(t, *tail):
        return t.reshape(Bt, nc * Q, *tail)[:, :S]

    return (rows(dx, H, P).to(x.dtype), rows(ddt, H), dA,
            rows(dB, N).to(B.dtype), rows(dC, N).to(C.dtype), dD, dh0)


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
            # scratch the passes hand on: the cumulative sums, C.B^T per
            # (batch, chunk), and each chunk's state from zero, then the
            # state entering it
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


def ssd_scan_bwd_cuda(x, dt, A, B, C, D, dy, dh_final=None, *,
                      chunk: int = 256, h0=None):
    """The backward kernel: same arguments and results as
    ``ssd_scan_bwd_torch``, all on one CUDA device.  x, B and C may be
    strided along batch and sequence, each position's values contiguous;
    dy (x's shape and dtype), dt, A, D, h0 and dh_final are contiguous.
    The route follows from the inputs (``bwd_chunked_route``)."""
    global BWD_LAUNCHES, BWD_LAUNCHES_SCALAR
    if x.ndim != 4:
        raise ValueError(f"ssd_scan_bwd_cuda: x must be (Bt, S, H, P), got "
                         f"{tuple(x.shape)}")
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    f32s = [dt, A, D] + [t for t in (h0, dh_final) if t is not None]
    if not (x.is_cuda and all(t.device == x.device
                              for t in [B, C, dy] + f32s)):
        raise ValueError("ssd_scan_bwd_cuda needs every tensor on one CUDA "
                         "device")
    if (x.dtype not in DTYPE_CODES
            or any(t.dtype != x.dtype for t in (B, C, dy))):
        raise ValueError(f"ssd_scan_bwd_cuda takes bf16/f32 x with B, C and "
                         f"dy of its dtype, got {x.dtype}, {B.dtype}, "
                         f"{C.dtype}, {dy.dtype}")
    if any(t.dtype != torch.float32 for t in f32s):
        raise ValueError("ssd_scan_bwd_cuda takes fp32 dt, A, D, h0 and "
                         "dh_final")
    shapes = {"dt": (dt, (Bt, S, H)), "A": (A, (H,)), "B": (B, (Bt, S, N)),
              "C": (C, (Bt, S, N)), "D": (D, (H,)), "dy": (dy, (Bt, S, H, P))}
    for name, t in (("h0", h0), ("dh_final", dh_final)):
        if t is not None:
            shapes[name] = (t, (Bt, H, P, N))
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"ssd_scan_bwd_cuda: {name} {tuple(t.shape)} "
                             f"must be {want}")
    if not (dy.is_contiguous() and all(t.is_contiguous() for t in f32s)):
        raise ValueError("ssd_scan_bwd_cuda needs contiguous dy, dt, A, D, "
                         "h0 and dh_final")
    if chunk < 1:
        raise ValueError(f"ssd_scan_bwd_cuda: chunk {chunk} must be positive")
    Q = min(chunk, S)
    x_sb, x_ss = _row_strides("x", x)
    b_sb, b_ss = _row_strides("B", B)
    c_sb, c_ss = _row_strides("C", C)
    lib = _build.load()
    tc = bwd_chunked_route(x, B, C, dy, chunk)
    n_ws = (lib.ssd_scan_bwd_tc_workspace if tc
            else lib.ssd_scan_bwd_workspace)(Bt, S, H, P, N, Q)
    if n_ws < 0:
        raise ValueError(f"ssd_scan_bwd_cuda: (Bt, S, H, P, N, chunk) = "
                         f"{(Bt, S, H, P, N, Q)} outside the "
                         f"{'tensor-core' if tc else 'scalar'} route's "
                         f"limits (P, N in [1, {MAX_PN}], chunk up to "
                         f"{MAX_CHUNK}, Bt up to 65535)")
    f32 = dict(dtype=torch.float32, device=x.device)
    ws = torch.empty((n_ws,), **f32)
    dx = torch.empty((Bt, S, H, P), dtype=x.dtype, device=x.device)
    dB = torch.empty((Bt, S, N), dtype=x.dtype, device=x.device)
    dC = torch.empty((Bt, S, N), dtype=x.dtype, device=x.device)
    ddt = torch.empty((Bt, S, H), **f32)
    dA = torch.empty((H,), **f32)
    dD = torch.empty((H,), **f32)
    dh0 = torch.empty((Bt, H, P, N), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), ptr(h0), dy.data_ptr(),
            ptr(dh_final), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), dD.data_ptr(), dh0.data_ptr(),
            ws.data_ptr(), Bt, S, H, P, N, Q, x_sb, x_ss, b_sb, b_ss, c_sb,
            c_ss)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if tc:
            err = lib.ssd_scan_bwd_tc_launch(*args, stream)
            _build.check(err, "ssd_scan_bwd_tc_launch")
        else:
            err = lib.ssd_scan_bwd_launch(*args, DTYPE_CODES[x.dtype],
                                          stream)
            _build.check(err, "ssd_scan_bwd_launch")
            BWD_LAUNCHES_SCALAR += 1
    BWD_LAUNCHES += 1
    return dx, ddt, dA, dB, dC, dD, dh0
