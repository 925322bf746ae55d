"""The mLSTM chunked scan: the CUDA kernels (``csrc/mlstm.cu``) and their
plain versions.

The reference runs the chunk recurrence as one ``jax.lax.scan`` of its
``chunk_step`` (``repro.kernels.ops._mlstm_scan_body``) inside the
``vmem_fused_mlstm`` scope, which XLA compiles into one loop on the
device; there is no TPU kernel.  ``mlstm_scan_cuda`` is that scan as
three launches a layer (the chunks' gates, the carries, the outputs),
``mlstm_scan_bwd_cuda`` its backward (the counterpart of autodiff of the
scan), six launches.

``mlstm_scan_torch`` is the port's loop of one chunk at a time, as it
stood in ``kernels/ops.py``.  It runs on CPU tensors, where autograd
differentiates it, and is the forward kernels' yardstick on the card.
``mlstm_scan_bwd_torch`` is the backward kernels' arithmetic in plain
PyTorch, a reverse-chunk loop of the same hand-derived formulas.

Shapes: q, k (B, H, S, Dk); v (B, H, S, Dv); i_gate, f_gate (B, H, S);
all five of one dtype, bf16 or fp32 (the kernels read them through
their strides, each row's last dim contiguous); ``carry`` (C (B, H, Dk,
Dv), n (B, H, Dk), m (B, H)) fp32, or None (zeros, m = -inf).  Both
directions return h (B, H, S, Dv) in q's dtype and the fp32 final carry.

What the backward reads (``mlstm_saved_torch``'s layout, all fp32, with
Q = min(chunk, S), nc chunks and Sp = nc Q): the carry entering each
chunk, C (B, H, nc, Dk, Dv), n (B, H, nc, Dk), m (B, H, nc); each
position's cumulative log forget gate G within its chunk and the row
maximum ``mloc`` = max_{j<=t} (G_t - G_j + i_j), (B, H, Sp) each; each
position's normaliser before the clamp, D' (B, H, Sp), and its h before
the cast, (B, H, Sp, Dv); the final carry's C and n.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.slstm import _logsigmoid_bwd, _maximum_bwd

#: forward and backward kernel calls so far (a run resets them to 0 and
#: reads them afterwards)
LAUNCHES = 0
BWD_LAUNCHES = 0

NEG_INF = -1.0e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest chunk and head widths the kernels take (xlstm_350m's: a
#: chunk of 256, Dk 256, Dv 512): a CTA holds a chunk's gates and a row
#: tile's whole Dk or Dv in registers
MAX_CHUNK, MAX_DK, MAX_DV = 256, 256, 512
#: the saved tensors, in order
SAVED = ("C", "n", "m", "G", "mloc", "Dp", "h32", "C_fin", "n_fin")


def mlstm_scan_torch(q, k, v, i_gate, f_gate, *, chunk, carry=None,
                     _record=None):
    """The chunk recurrence one chunk at a time.  ``_record``: a list
    that receives, chunk by chunk, ((C, n, m) entering the chunk, G,
    mloc, D', h in fp32), for ``mlstm_saved_torch``."""
    B, H, S, Dk = q.shape
    Dv = v.shape[-1]
    scale = 1.0 / math.sqrt(Dk)
    Q = min(chunk, S)
    Sp = -(-S // Q) * Q
    pad = Sp - S
    f32, dev = torch.float32, q.device

    def pad_s(t):
        return F.pad(t.float(), (0, 0, 0, pad))

    qf, kf, vf = pad_s(q), pad_s(k), pad_s(v)
    # padded positions write nothing (i = NEG_INF) and decay nothing
    # (f = 80: log f ~ 0), so the running max and the carry pass through
    igf = F.pad(i_gate.float(), (0, pad), value=NEG_INF)
    fgf = F.pad(f_gate.float(), (0, pad), value=80.0)

    if carry is None:
        C = torch.zeros((B, H, Dk, Dv), dtype=f32, device=dev)
        n = torch.zeros((B, H, Dk), dtype=f32, device=dev)
        m = torch.full((B, H), float("-inf"), dtype=f32, device=dev)
    else:
        C, n, m = (c.float() for c in carry)

    tri = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    # the chunks as ``split`` views: their backward concatenates the
    # chunks' gradients once (a slice's writes a zero tensor of the whole
    # sequence for each chunk)
    chunks = zip(*(t.split(Q, dim=2) for t in (qf, kf, vf, igf, fgf)))
    hs = []
    for q_c, k_c, v_c, i_c, f_c in chunks:               # gates (B, H, Q)
        logf = F.logsigmoid(f_c)
        G = torch.cumsum(logf, dim=-1)     # local cumulative log forget
        # D_local[t, j] = G_t - G_j + i_j for j <= t
        d_loc = G[..., :, None] - G[..., None, :] + i_c[..., None, :]
        d_loc = torch.where(tri, d_loc, float("-inf"))
        # running max m_t = max(m_prev + G_t, max_{j<=t} d_loc[t, j]): row
        # t already holds every j <= t with its decay, so the row max is
        # the whole local running max (a cummax over rows would mix in
        # stale, undecayed values).  torch.maximum and amax split the
        # gradient at ties as jnp.maximum and jnp.max do.
        mloc = d_loc.amax(dim=-1)
        m_t = torch.maximum(m[..., None] + G, mloc)
        # intra-chunk scores
        s = torch.einsum("bhqd,bhjd->bhqj", q_c, k_c) * scale
        w = torch.where(tri, torch.exp(d_loc - m_t[..., None]), 0.0)
        sw = s * w
        num_i = sw @ v_c
        den_i = sw.sum(-1)
        # inter-chunk: decay from the carry
        inter_w = torch.exp(m[..., None] + G - m_t)            # (B, H, Q)
        num_x = (q_c @ C) * scale * inter_w[..., None]
        den_x = torch.einsum("bhk,bhqk->bhq", n, q_c) * scale * inter_w
        den = torch.maximum(torch.abs(den_i + den_x), torch.exp(-m_t))
        hs.append((num_i + num_x) / den[..., None])
        if _record is not None:
            _record.append(((C, n, m), G, mloc, den_i + den_x, hs[-1]))
        # carry update at the chunk's end, with m_end
        m_end = m_t[..., -1]
        cw = torch.exp(G[..., -1:] - G + i_c - m_end[..., None])  # (B,H,Q)
        decay = torch.exp(m + G[..., -1] - m_end)
        C = (C * decay[..., None, None]
             + (k_c * cw[..., None]).transpose(-1, -2) @ v_c)
        n = n * decay[..., None] + torch.einsum("bhq,bhqk->bhk", cw, k_c)
        m = m_end
    h = torch.cat(hs, dim=2)[:, :, :S]
    return h.to(q.dtype), (C, n, m)


def mlstm_saved_torch(q, k, v, i_gate, f_gate, *, chunk, carry=None):
    """What the forward kernels save for the backward (``SAVED``), from
    the plain loop, and the final carry."""
    rec = []
    with torch.no_grad():
        _, fin = mlstm_scan_torch(q, k, v, i_gate, f_gate, chunk=chunk,
                                  carry=carry, _record=rec)
    C, n, m = (torch.stack([r[0][j] for r in rec], 2) for j in range(3))
    G, mloc, Dp, h32 = (torch.cat([r[j] for r in rec], 2)
                        for j in range(1, 5))
    return (C, n, m, G, mloc, Dp, h32, fin[0], fin[1]), fin


def mlstm_scan_bwd_torch(q, k, v, i_gate, f_gate, dh, dfinal=None, *,
                         chunk, carry=None, saved=None):
    """The backward in plain PyTorch: the cotangents of q, k, v, i_gate
    and f_gate (each in its input's dtype) and of the carry given
    ((dC, dn, dm) fp32, or None without one) for the cotangent ``dh`` of
    h and ``dfinal`` of the final carry (three, each None for zero, or
    None).  ``saved``: the forward kernels' saved tensors (``SAVED``);
    None recomputes them with the plain loop.

    Three facts shape it.  (1) h does not depend on the stabiliser m:
    num and den both carry exp(-m_t), so h = N~ / max(|D~|, 1) in the
    unscaled sums, and every m is held constant: w = exp(d - m_t), the
    inter weight exp(m0 + G_t - m_t) and the carry's decays are
    differentiated through d = G_t - G_j + i_j, G, i and m0 alone.  (2)
    A chunk's outputs with its m held constant depend on its entering
    carry only through C0 e^{m0} and n0 e^{m0}, so the carried m's own
    cotangent is sum(C0 dC0) + sum(n0 dn0), which cancels the -C1 dC1
    the stored carry C1 = C~1 e^{-m1} gives back: inside the scan only
    the final carry's m path remains, p = dm_fin - sum(C_fin dC_fin) -
    sum(n_fin dn_fin), sent back through the chain of maxima that set
    m_fin (to the i_j or m0 + G_L that won, split at ties as
    torch.maximum and amax split).  (3) Per chunk, from the row's
    normaliser D' and h: dN = dh / den, dD' = -(dh . h) / den where |D'|
    > exp(-m) (half at a tie) times sign(D'); dP = dN v^T + dD'; then
    ds = dP w scale, dd = dP P, and the products of the forward run
    backwards; the carry's cotangent runs back as dC_in = dec dC_out +
    sum_t X_t q_t dN_t^T (X_t = scale exp(m0 + G_t - m_t))."""
    B, H, S, Dk = q.shape
    Dv = v.shape[-1]
    scale = 1.0 / math.sqrt(Dk)
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if saved is None:
        saved, _ = mlstm_saved_torch(q, k, v, i_gate, f_gate, chunk=chunk,
                                     carry=carry)
    Cin, nin, minc, Gs, mlocs, Dps, h32s, C_fin, n_fin = saved
    dfinal = tuple(dfinal or (None,) * 3)
    f32, dev = torch.float32, q.device

    def pad_s(t, value=0.0):
        t = t.float()
        return F.pad(t, (0, 0, 0, pad) if t.ndim == 4 else (0, pad),
                     value=value)

    qc, kc, vc, dhc = (pad_s(t).split(Q, 2) for t in (q, k, v, dh))
    ic = pad_s(i_gate, NEG_INF).split(Q, 2)
    fc = pad_s(f_gate, 80.0).split(Q, 2)
    Gc, mlc, Dpc, hc = (t.split(Q, 2) for t in (Gs, mlocs, Dps, h32s))
    tri = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    dCf, dnf, dmf = dfinal
    dC = (torch.zeros((B, H, Dk, Dv), dtype=f32, device=dev) if dCf is None
          else dCf.float())
    dn = (torch.zeros((B, H, Dk), dtype=f32, device=dev) if dnf is None
          else dnf.float())
    # the final carry's m path
    p = torch.zeros((B, H), dtype=f32, device=dev)
    if dmf is not None:
        p = p + dmf.float()
    if dCf is not None:
        p = p - (C_fin * dCf.float()).sum((-1, -2))
    if dnf is not None:
        p = p - (n_fin * dnf.float()).sum(-1)
    dqs, dks, dvs, dis, dfs = [], [], [], [], []
    for c in reversed(range(nc)):
        q_c, k_c, v_c, dh_c = qc[c], kc[c], vc[c], dhc[c]
        i_c, f_c, G, mloc, Dp, h = ic[c], fc[c], Gc[c], mlc[c], Dpc[c], hc[c]
        C0, n0, m0 = Cin[:, :, c], nin[:, :, c], minc[:, :, c]
        m_t = torch.maximum(m0[..., None] + G, mloc)
        d_loc = G[..., :, None] - G[..., None, :] + i_c[..., None, :]
        w = torch.where(tri, torch.exp(d_loc - m_t[..., None]), 0.0)
        s = torch.einsum("bhqd,bhjd->bhqj", q_c, k_c) * scale
        P = s * w
        X = torch.exp(m0[..., None] + G - m_t) * scale
        emt = torch.exp(-m_t)
        aD = Dp.abs()
        den = torch.maximum(aD, emt)
        dN = dh_c / den[..., None]
        dden = -(dh_c * h).sum(-1) / den
        dabs, _ = _maximum_bwd(aD, emt, dden)
        dDp = dabs * torch.sign(Dp)
        dP = torch.where(tri, dN @ v_c.transpose(-1, -2) + dDp[..., None],
                         0.0)
        ds = dP * w * scale
        dd = dP * P
        dq = ds @ k_c
        dk = ds.transpose(-1, -2) @ q_c
        dv = P.transpose(-1, -2) @ dN
        # the inter-chunk terms
        dqi = X[..., None] * (dN @ C0.transpose(-1, -2)
                              + dDp[..., None] * n0[..., None, :])
        dq = dq + dqi
        dlogiw = (q_c * dqi).sum(-1)
        dC_loc = (q_c * X[..., None]).transpose(-1, -2) @ dN
        dn_loc = ((X * dDp)[..., None] * q_c).sum(-2)
        # the carry update at the chunk's end (dC, dn: the outgoing
        # carry's cotangents)
        m_L, G_L = m_t[..., -1], G[..., -1]
        cw = torch.exp(G_L[..., None] - G + i_c - m_L[..., None])
        dec = torch.exp(m0 + G_L - m_L)
        E = v_c @ dC.transpose(-1, -2) + dn[..., None, :]
        dk = dk + cw[..., None] * E
        dv = dv + cw[..., None] * (k_c @ dC)
        dlogcw = (k_c * E).sum(-1) * cw
        dlogdec = ((C0 * dC).sum((-1, -2)) + (n0 * dn).sum(-1)) * dec
        dG = dd.sum(-1) - dd.sum(-2) + dlogiw - dlogcw
        di = dd.sum(-2) + dlogcw
        # the m path at this chunk's m_L = max(m0 + G_L, mloc_L); mloc_L
        # the amax over the last row, split evenly among its ties
        pa, pb = _maximum_bwd(m0 + G_L, mloc[..., -1], p)
        won = d_loc[..., -1, :] == mloc[..., -1:]
        g = pb / won.sum(-1).clamp_min(1)
        dG = dG - won * g[..., None]
        di = di + won * g[..., None]
        dG[..., -1] += dlogcw.sum(-1) + dlogdec + pa + pb
        p = pa
        dl = dG.flip(-1).cumsum(-1).flip(-1)
        dqs.append(dq)
        dks.append(dk)
        dvs.append(dv)
        dis.append(di)
        dfs.append(_logsigmoid_bwd(f_c, dl))
        dC = dec[..., None, None] * dC + dC_loc
        dn = dec[..., None] * dn + dn_loc

    def out(parts, like):
        return torch.cat(parts[::-1], 2)[:, :, :S].to(like.dtype)

    grads = (out(dqs, q), out(dks, k), out(dvs, v), out(dis, i_gate),
             out(dfs, f_gate))
    if carry is None:
        return grads, None
    C0, n0 = carry[0].float(), carry[1].float()
    dm0 = (C0 * dC).sum((-1, -2)) + (n0 * dn).sum(-1) + p
    return grads, (dC, dn, dm0)


def _check(what, cond, msg):
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _dims(what, q, k, v, i_gate, f_gate, chunk):
    _check(what, q.ndim == 4 and k.shape == q.shape and v.ndim == 4
           and v.shape[:3] == q.shape[:3]
           and i_gate.shape == q.shape[:3] == f_gate.shape,
           f"q, k (B, H, S, Dk), v (B, H, S, Dv), gates (B, H, S); got "
           f"{[tuple(t.shape) for t in (q, k, v, i_gate, f_gate)]}")
    B, H, S, Dk = q.shape
    Dv = v.shape[-1]
    _check(what, Dk <= MAX_DK and Dv <= MAX_DV,
           f"head dims Dk {Dk}, Dv {Dv} past the kernels' {MAX_DK}, "
           f"{MAX_DV}")
    _check(what, 1 <= min(chunk, S) <= MAX_CHUNK,
           f"chunk {min(chunk, S)} not in [1, {MAX_CHUNK}]")
    _check(what, min(B, H, S, Dk, Dv) >= 1,
           f"every dimension must be positive, got {(B, H, S, Dk, Dv)}")
    ts = (q, k, v, i_gate, f_gate)
    _check(what, all(t.dtype == q.dtype for t in ts)
           and q.dtype in DTYPE_CODES,
           f"q, k, v and the gates must be one of bf16/f32, got "
           f"{[t.dtype for t in ts]}")
    _check(what, all(t.stride(-1) == 1 for t in (q, k, v)),
           "q, k and v must have their last dim contiguous")
    return B, H, S, Dk, Dv


def _on(what, dev, *ts):
    _check(what, dev.type == "cuda" and all(
        t.device == dev for t in ts if t is not None),
        "needs every tensor on one CUDA device")


def _strides(*ts):
    """(batch, head, position) strides of each tensor, in elements."""
    return [s for t in ts for s in t.stride()[:3]]


def _chunks(S, chunk):
    Q = min(chunk, S)
    return Q, -(-S // Q)


def mlstm_scan_cuda(q, k, v, i_gate, f_gate, *, chunk, carry=None,
                    save: bool = False):
    """The forward kernels: ``mlstm_scan_torch``'s results, all on one
    CUDA device.  h is returned as a (B, H, S, Dv) view of a (B, S, H,
    Dv) buffer (the layout the block reshapes it to).  ``save``: also
    return what the backward kernels read (``SAVED``, else None)."""
    global LAUNCHES
    what = "mlstm_scan_cuda"
    B, H, S, Dk, Dv = _dims(what, q, k, v, i_gate, f_gate, chunk)
    cs = [] if carry is None else list(carry)
    dev = q.device
    _on(what, dev, k, v, i_gate, f_gate, *cs)
    _check(what, all(t.dtype == torch.float32 and t.is_contiguous()
                     for t in cs)
           and (not cs or (tuple(cs[0].shape) == (B, H, Dk, Dv)
                           and tuple(cs[1].shape) == (B, H, Dk)
                           and tuple(cs[2].shape) == (B, H))),
           "the carry must be contiguous fp32 (C, n, m)")
    Q, nc = _chunks(S, chunk)
    f32 = dict(dtype=torch.float32, device=dev)
    h = torch.empty((B, S, H, Dv), dtype=q.dtype, device=dev)
    Cin = torch.empty((B, H, nc, Dk, Dv), **f32)
    nin = torch.empty((B, H, nc, Dk), **f32)
    minc = torch.empty((B, H, nc), **f32)
    G = torch.empty((B, H, nc * Q), **f32)
    mloc = torch.empty((B, H, nc * Q), **f32)
    fin = (torch.empty((B, H, Dk, Dv), **f32), torch.empty((B, H, Dk), **f32),
           torch.empty((B, H), **f32))
    Dp = torch.empty((B, H, nc * Q), **f32) if save else None
    h32 = torch.empty((B, H, nc * Q, Dv), **f32) if save else None
    C0, n0, m0 = cs or (None,) * 3
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.mlstm_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(),
            f_gate.data_ptr(), *_strides(q, k, v, i_gate, f_gate),
            _ptr(C0), _ptr(n0), _ptr(m0), h.data_ptr(),
            *_strides(h.transpose(1, 2)), Cin.data_ptr(), nin.data_ptr(),
            minc.data_ptr(), G.data_ptr(), mloc.data_ptr(),
            *(t.data_ptr() for t in fin), _ptr(Dp), _ptr(h32), B, H, S, Dk,
            Dv, Q, DTYPE_CODES[q.dtype], stream)
    _build.check(err, "mlstm_fwd_launch")
    LAUNCHES += 1
    saved = ((Cin, nin, minc, G, mloc, Dp, h32, fin[0], fin[1]) if save
             else None)
    return h.transpose(1, 2), fin, saved


def mlstm_scan_bwd_cuda(q, k, v, i_gate, f_gate, dh, dfinal=None, *,
                        chunk, saved, carry=None):
    """The backward kernels: ``mlstm_scan_bwd_torch``'s results from the
    forward kernels' ``saved``, all on one CUDA device; dq, dk, dv and
    the gates' cotangents contiguous in the inputs' dtype, the carry's
    (when one was given) fp32."""
    global BWD_LAUNCHES
    what = "mlstm_scan_bwd_cuda"
    B, H, S, Dk, Dv = _dims(what, q, k, v, i_gate, f_gate, chunk)
    Q, nc = _chunks(S, chunk)
    _check(what, len(saved) == len(SAVED) and all(
        t.dtype == torch.float32 and t.is_contiguous() for t in saved),
        "saved must be the forward kernels' saved tensors")
    Cin, nin, minc, G, mloc, Dp, h32, C_fin, n_fin = saved
    _check(what, tuple(Cin.shape) == (B, H, nc, Dk, Dv)
           and tuple(h32.shape) == (B, H, nc * Q, Dv),
           f"saved shapes {[tuple(t.shape) for t in saved]} are not this "
           f"call's")
    _check(what, tuple(dh.shape) == (B, H, S, Dv),
           f"dh must be {(B, H, S, Dv)}, got {tuple(dh.shape)}")
    dfinal = [None if d is None else d.float().contiguous()
              for d in (dfinal or (None,) * 3)]
    cs = [] if carry is None else [t.float().contiguous() for t in carry]
    dev = q.device
    _on(what, dev, k, v, i_gate, f_gate, dh, *saved, *dfinal, *cs)
    if dh.dtype != q.dtype or dh.stride(-1) != 1:
        dh = dh.to(q.dtype).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty(t.shape, dtype=q.dtype, device=dev)
                  for t in (q, k, v))
    di, df = (torch.empty((B, H, S), dtype=q.dtype, device=dev)
              for _ in range(2))
    d0 = ((torch.empty((B, H, Dk, Dv), **f32), torch.empty((B, H, Dk), **f32),
           torch.empty((B, H), **f32)) if cs else (None,) * 3)
    lib = _build.load()
    ws = torch.empty(lib.mlstm_bwd_workspace(B, H, Dk, Dv, Q, nc), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.mlstm_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(),
            f_gate.data_ptr(), *_strides(q, k, v, i_gate, f_gate),
            dh.data_ptr(), *_strides(dh), *(_ptr(d) for d in dfinal),
            *(_ptr(c) for c in (cs[:2] or (None, None))),
            *(t.data_ptr() for t in saved), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), di.data_ptr(), df.data_ptr(),
            *(_ptr(t) for t in d0), ws.data_ptr(), B, H, S, Dk, Dv, Q,
            DTYPE_CODES[q.dtype], stream)
    _build.check(err, "mlstm_bwd_launch")
    BWD_LAUNCHES += 1
    return (dq, dk, dv, di, df), (tuple(d0) if cs else None)
