"""Naive oracles for the tests (the port's counterpart of
``repro.kernels.ref``'s ``attention``, ``rmsnorm``, ``ssd_scan`` and
``mlstm_scan``): O(S^2)
memory or one step at a time, numerically straightforward, fully masked
rows give NaN as in the reference."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
              scale: Optional[float] = None, q_offset: int = 0):
    """q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if sliding_window > 0:
        mask &= (q_pos - k_pos) < sliding_window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, -1).to(q.dtype)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


def ssd_scan(x, dt, A, B, C, D, *, h0=None):
    """Sequential (ground-truth) Mamba2 recurrence, one position at a time.

    x: (Bt, S, H, P); dt: (Bt, S, H) softplus'd timestep; A: (H,) negative
    decay rate; B, C: (Bt, S, N) shared across heads; D: (H,) skip; h0:
    (Bt, H, P, N) or None.  Returns y (Bt, S, H, P) in x's dtype and the
    fp32 final state (Bt, H, P, N)."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    h = (torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A[None])                  # (Bt, H)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dtf[:, t], Bf[:, t], xf[:, t])
        h = h * decay[..., None, None] + dBx
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], h))
    y = torch.stack(ys, 1) + xf * D[None, None, :, None]
    return y.to(x.dtype), h


def mlstm_scan(q, k, v, i_gate, f_gate, *, c0=None, n0=None, m0=None):
    """Sequential (ground-truth) mLSTM recurrence with log-domain
    stabilization.

    q, k: (B, H, S, Dk); v: (B, H, S, Dv); i_gate, f_gate: (B, H, S)
    pre-activations.  C_t = f C_{t-1} + i v k^T; n_t = f n + i k;
    h = (C q) / max(|n.q|, 1), stabilized with m_t = max(log f + m_{t-1},
    log i).  Returns h (B, H, S, Dv) in q's dtype and the fp32 final
    (C, n, m)."""
    B, H, S, Dk = q.shape
    Dv = v.shape[-1]
    scale = 1.0 / math.sqrt(Dk)
    f32, dev = torch.float32, q.device
    C = (torch.zeros((B, H, Dk, Dv), dtype=f32, device=dev) if c0 is None
         else c0.float())
    n = (torch.zeros((B, H, Dk), dtype=f32, device=dev) if n0 is None
         else n0.float())
    m = (torch.full((B, H), float("-inf"), dtype=f32, device=dev)
         if m0 is None else m0.float())
    qf, kf, vf = q.float(), k.float(), v.float()
    igf, fgf = i_gate.float(), f_gate.float()
    hs = []
    for t in range(S):
        q_t, k_t, v_t = qf[:, :, t], kf[:, :, t], vf[:, :, t]
        logf = F.logsigmoid(fgf[:, :, t])                     # (B, H)
        m_new = torch.maximum(logf + m, igf[:, :, t])
        fg = torch.exp(logf + m - m_new)
        ig = torch.exp(igf[:, :, t] - m_new)
        C = (C * fg[..., None, None]
             + ig[..., None, None] * (k_t[..., :, None] * v_t[..., None, :]))
        n = n * fg[..., None] + ig[..., None] * k_t
        num = torch.einsum("bhkv,bhk->bhv", C, q_t) * scale
        den = torch.maximum(
            torch.abs(torch.einsum("bhk,bhk->bh", n, q_t)) * scale,
            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, 2).to(q.dtype), (C, n, m)
