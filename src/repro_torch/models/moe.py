"""Mixture-of-Experts layer: top-k token-choice routing with scatter/gather
dispatch (the port of ``repro.models.moe``).

Routing matches the reference's: fp32 router logits, softmax, top-k and
the gates renormalised over the k choices; a static capacity
``C = max(1, ceil(T * K / E * capacity_factor))`` per expert; each
(token, k) choice's position within its expert from a cumulative sum in
k-major order (every k = 0 choice claims its slot before any k = 1
choice); choices past the capacity go to the overflow slot ``E * C``,
which the scatter drops and the combine reads as row ``E * C - 1`` with
weight 0.  Tokens are scattered into (E, C, d) expert buffers by rows
(no one-hot einsums), the experts run as batched matrix products, and
the N shared experts are one wide gated MLP whose output is added.

Routing and capacity are per data shard, as the reference's: DP is the
sharding context's data-parallel size (1 without one, and 1 when the T
tokens do not split into DP shards), each shard of ``Tl = T / DP``
consecutive tokens routes alone with the capacity of its own ``Tl``.  A
rank that holds one shard of each microbatch (``ShardCtx.shards_batch``)
routes its local tokens as that shard; a rank that holds the whole batch
routes it as DP shards, as the reference's ``(DP, Tl, d)`` reshape does.
A serve block's dense plane runs under its block's context, so its
prefill and decode route as the reference's under the block's mesh; the
paged plane runs with none, so a round's tokens route as one group, as
the reference's context-free scheduler routes them.
The aux loss is ``E * sum(frac_tokens * frac_probs)`` over every shard's
tokens, a product of two global means, so under a data-parallel layout
both fractions are summed over the data shards (``shard_ctx.data_sum``)
before the product.

Expert parallelism over ``model`` (item 8d, where the context's
``plans.TPLayout`` computes "experts"): every rank of a model column
routes the same tokens with the replicated router, as without it,
builds the whole (E * C, d) dispatch buffer from its input after
``copy_in``, and runs the three batched products on its E/M experts'
rows with its local expert weights; ``gather_out`` puts the experts'
rows back together in expert order before the combine, whose k-order
sum is unchanged.  Where the reference's ``constrain_expert_buffers``
lays the buffers over ``model`` and GSPMD moves them, the rank reads its
own experts' rows and gathers the outputs.  The shared expert is an MLP
computed sharded over its width ("shared").

Every valid slot receives exactly one token, so the scatter is a plain
indexed write into an (E * C + 1, d) buffer whose last row takes every
overflow choice and is discarded: the kept rows do not depend on the
order of the writes, no atomics decide them, and the layer launches no
host sync, so a decode step that runs it captures as a CUDA graph.

Under autograd the layer's gradients are the reference's.  The writes
into the buffer are ``index_put_``, whose backward gathers each choice's
row of the buffer's gradient: a kept choice gets its slot's row, and a
dropped one the trash row's, which is cut off and so is zero, where the
reference's ``mode="drop"`` scatter gives it zero.  The combine's
gathers scatter-add back into the expert rows (each kept row is read by
one choice).  The router gets its gradient through the top-k gates,
renormalised over the k choices, and through ``frac_probs`` in the aux
loss; the routing itself (``idx``, the slots, ``frac_tokens``) is
integer and carries none.  The routing is a function of the layer's
input alone, so a remat recompute routes every token as the first
forward did.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import _gelu, _he, mlp_fwd, mlp_init
from repro_torch.sharding import ctx as shard_ctx


def moe_init(gen, d_model: int, cfg: MoEConfig, dtype, device):
    E, F_ = cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": _he(gen, (d_model, E), torch.float32, device),
        "w_gate": _he(gen, (E, d_model, F_), dtype, device, fan_in=d_model),
        "w_up": _he(gen, (E, d_model, F_), dtype, device, fan_in=d_model),
        "w_down": _he(gen, (E, F_, d_model), dtype, device, fan_in=F_),
    }
    if cfg.n_shared > 0:
        p["shared"] = mlp_init(gen, d_model, cfg.n_shared * cfg.shared_ff,
                               gated=True, dtype=dtype, device=device)
    return p


def capacity(T: int, cfg: MoEConfig) -> int:
    """Slots per expert for T tokens (static, as the reference's)."""
    return max(1, int(math.ceil(T * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def route(xs, router, cfg: MoEConfig):
    """xs: (T, d).  Returns (probs (T, E) fp32, idx (T, K), slots (K, T),
    weights (K, T) in xs's dtype, C): a dropped choice has slot E * C and
    weight 0."""
    T = xs.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xs.float() @ router, dim=-1)        # (T, E)
    gate_vals, idx = torch.topk(probs, K, dim=-1)             # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    C = capacity(T, cfg)
    experts = torch.arange(E, device=xs.device)
    counts = torch.zeros((1, E), dtype=torch.int64, device=xs.device)
    overflow = E * C
    slot_k, weight_k = [], []
    for j in range(K):
        oh = (idx[:, j:j + 1] == experts).long()              # (T, E)
        pos_all = torch.cumsum(oh, dim=0) - 1 + counts        # (T, E)
        pos = torch.gather(pos_all, 1, idx[:, j:j + 1])[:, 0]  # (T,)
        counts = counts + oh.sum(0, keepdim=True)
        valid = pos < C
        slot_k.append(torch.where(valid, idx[:, j] * C + pos, overflow))
        weight_k.append((gate_vals[:, j] * valid).to(xs.dtype))
    return probs, idx, torch.stack(slot_k), torch.stack(weight_k), C


def _shards(T: int):
    """(routing groups this rank computes, tokens a group, whether the
    rank holds one data shard of the tokens)."""
    ctx = shard_ctx.current()
    DP = shard_ctx.dp_size()
    if ctx is not None and ctx.shards_batch and DP > 1:
        return 1, T, True        # the local tokens are this rank's shard
    if T % DP != 0:
        DP = 1
    return DP, T // DP, False


def _experts(p, xs, cfg: MoEConfig, act: str):
    """One routing group: xs (Tl, d) -> (out (Tl, d), probs, idx).  The
    experts run are those whose weights ``p`` holds: all E, or a rank's
    E/M under expert parallelism."""
    Tl, d = xs.shape
    E, El = cfg.n_experts, p["w_gate"].shape[0]
    probs, idx, slots, weights, C = route(xs, p["router"], cfg)

    ep = shard_ctx.tp_on("experts")
    buf = _scatter_local(shard_ctx.copy_in(xs) if ep else xs, slots, E=E,
                         C=C)
    lo = shard_ctx.model_rank() * El * C if ep else 0
    ebuf = buf[lo:lo + El * C].reshape(El, C, d)
    g = torch.bmm(ebuf, p["w_gate"])                          # (El, C, F)
    u = torch.bmm(ebuf, p["w_up"])
    g = F.silu(g) if act == "silu" else _gelu(g)
    h = torch.bmm(g * u, p["w_down"]).reshape(El * C, d)
    if ep:
        h = shard_ctx.gather_out(h, 0)                        # (E * C, d)
    out = _combine_local(h, slots, weights, E=E, C=C)
    return out, probs, idx


def moe_fwd(p, x, cfg: MoEConfig, act: str = "silu"):
    """x: (B, S, d) -> (out (B, S, d), aux_loss 0-d fp32)."""
    B, S, d = x.shape
    E = cfg.n_experts
    xs = x.reshape(B * S, d)
    n, Tl, sharded = _shards(B * S)
    if n == 1:
        out, probs, idx = _experts(p, xs, cfg, act)
    else:
        parts = [_experts(p, xs[i * Tl:(i + 1) * Tl], cfg, act)
                 for i in range(n)]
        out, probs, idx = (torch.cat(t) for t in zip(*parts))

    if cfg.n_shared > 0:
        out = out + mlp_fwd(p["shared"], xs, act, gated=True,
                            tp=shard_ctx.tp_on("shared"))

    # load-balancing auxiliary loss (Switch-style)
    top1 = (idx[:, :1] == torch.arange(E, device=x.device)).float()
    if sharded:
        # means over every shard's tokens: sums over the data shards
        count = shard_ctx.data_sum(torch.tensor(
            float(B * S), device=x.device))
        frac_tokens = shard_ctx.data_sum(top1.sum(0)) / count
        frac_probs = shard_ctx.data_sum(probs.sum(0)) / count
    else:
        frac_tokens = top1.mean(0)
        frac_probs = probs.mean(0)
    aux = cfg.router_aux_coef * E * torch.sum(frac_tokens * frac_probs)
    return out.reshape(B, S, d), aux


def _scatter_local(xs, slots, *, E, C):
    """Dispatch.  xs: (T, d); slots: (K, T), overflow id E * C.  Each
    valid slot is written by exactly one (token, k) choice; the overflow
    choices all land in the trash row E * C, which is cut off.  Returns
    the (E * C, d) expert rows, zeros where no token came."""
    T, d = xs.shape
    buf = torch.zeros((E * C + 1, d), dtype=xs.dtype, device=xs.device)
    for j in range(slots.shape[0]):
        buf[slots[j]] = xs
    return buf[:E * C]


def _combine_local(hflat, slots, weights, *, E, C):
    """Combine.  hflat: (E * C, d).  Each choice reads its slot's row (an
    overflow choice reads row E * C - 1, weighted 0) times its weight; the
    K contributions add in k order.  Returns (T, d)."""
    out = None
    for j in range(slots.shape[0]):
        rows = hflat[torch.clamp(slots[j], max=E * C - 1)]
        contrib = rows * weights[j][:, None]
        out = contrib if out is None else out + contrib
    return out
