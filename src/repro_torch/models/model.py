"""Model facade: the public API the runtime layers consume (the port of
``repro.models.model``).

  init_params(cfg, seed=, device=)       -> params tree
  abstract_params(cfg)                   -> the same tree on ``meta``
  loss_fn(params, cfg, batch)            -> (loss, metrics)
  prefill(params, cfg, batch, cache)     -> (logits_last, filled_cache)
  decode_step(params, cfg, token, cache, cache_len) -> (logits, cache)
  decode_step_paged(params, cfg, token, pool, page_table, seq_lens)
  write_prefill_to_pages(pool, dense_cache, page_ids, page_size)

Caches and pools are updated in place and returned.  ``impl`` selects the
kernels or their plain versions for the whole stack (``kernels.ops``).

On a block's mesh the params are DTensors (``place_params``) and every
function here gathers them a group at a time, forward only on the serve
paths (``sharding.ctx.full``); the dense serve plane runs under the
block's sharding context on this rank's rows of the batch and cache,
the paged plane with no context on every slot.  Under vocab parallelism
(item 8d) the loss reads the rank's vocabulary's logits
(``_xent``'s vocab-parallel form) and the serve functions return the
whole vocabulary's (``transformer.vocab_whole``).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.models.transformer import (Transformer,  # re-export
                                            embed_inputs, forward,
                                            init_cache, init_paged_cache,
                                            vocab_whole)

init_params = transformer.init_params
place_params = transformer.place_params
check_paged_support = transformer.check_paged_support


def abstract_params(cfg: ModelConfig):
    return transformer.init_params(cfg, device="meta")


def count_params(tree) -> int:
    return sum(math.prod(leaf.shape) for _, leaf in transformer.flatten(tree))


def count_active_params(cfg: ModelConfig) -> int:
    """Params touched per token: the full count minus the inactive routed
    experts (the E - K a MoE sublayer does not route a token to; one MoE
    sublayer per group), as in the reference.  The hybrid's shared
    attention block counts once, though every group applies it; the
    frontends' projections count, and the frame frontend has no embedding
    table."""
    total = count_params(abstract_params(cfg))
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    n_moe_layers = transformer.n_groups(cfg)   # one moe sublayer per group
    return total - n_moe_layers * (m.n_experts - m.top_k) * per_expert


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _xent(logits, labels, mask):
    """Cross-entropy in fp32 with a validity mask.  logits: (B, S, V).

    A masked mean over the *global* batch: under a data-parallel layout
    each rank's term is its own ``nll.sum()`` over the count of every
    shard's valid positions (the shards' counts differ under hubert's
    random masks), and the terms are summed over the data shards, each
    rank's gradient flowing through its own term
    (``shard_ctx.data_sum``).

    Vocab-parallel where ``logits`` are a rank's vocabulary's (the
    context's layout computes "vocab" over a model axis of M > 1): the
    shift is the column's maximum (no gradient: it cancels), and the sum
    of the exponentials and the gold logit (zero on the ranks whose
    vocabulary does not hold the label) are each summed over the column
    (``reduce_out``), all in fp32."""
    lf = logits.float()
    if shard_ctx.tp_on("vocab") and shard_ctx.model_size() > 1:
        V = lf.shape[-1]
        m = shard_ctx.max_over_model(lf.detach().amax(-1))
        s = shard_ctx.reduce_out(torch.exp(lf - m[..., None]).sum(-1))
        lse = torch.log(s) + m
        local = labels.long() - shard_ctx.model_rank() * V
        mine = (local >= 0) & (local < V)
        g = torch.gather(lf, -1, torch.where(mine, local, 0)[..., None])
        gold = shard_ctx.reduce_out(torch.where(mine, g[..., 0], 0.0))
    else:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = (lse - gold) * mask
    denom = torch.clamp(shard_ctx.data_sum(mask.sum()), min=1.0)
    return shard_ctx.data_sum(nll.sum() / denom)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            impl: str = "auto"):
    """The reference's losses: masked-frame cross-entropy (HuBERT-style,
    only the masked frames count) for the frame frontend, next-token loss
    on the text segment (the patches occupy the prefix) for the patch
    frontend, next-token loss for the token frontend.  Returns (total
    loss, {"loss", "aux_loss"}) as 0-d fp32 tensors."""
    x = embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    logits, aux, _ = forward(params, cfg, x, positions=positions, impl=impl)
    if cfg.frontend == "frame":
        loss = _xent(logits, batch["labels"], batch["mask"].float())
    elif cfg.frontend == "patch":
        n_p = batch["patches"].shape[1]
        loss = _next_token_loss(logits[:, n_p:], batch["labels"])
    else:
        loss = _next_token_loss(logits, batch["labels"])
    total = loss + aux
    return total, {"loss": loss, "aux_loss": aux}


def _next_token_loss(logits, labels):
    """Standard causal LM loss: logits[t] predicts labels[t]."""
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=logits.device)
    return _xent(logits, labels, mask)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def embedded_len(cfg: ModelConfig, batch: Dict[str, Any]) -> int:
    """The sequence length ``embed_inputs`` gives ``batch``: its tokens,
    plus the patches in front of them for the patch frontend."""
    n = int(batch["tokens"].shape[1])
    if cfg.frontend == "patch" and "patches" in batch:
        n += int(batch["patches"].shape[1])
    return n


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: Dict[str, Any], cache, *,
            impl: str = "auto"):
    """Run the prompt through the stack, filling ``cache``.

    Returns (logits_last (B, V), cache)."""
    x = embed_inputs(params, cfg, batch)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    logits, _, cache = forward(params, cfg, x, positions=positions,
                               cache=cache, cache_len=0, impl=impl)
    return vocab_whole(logits[:, -1]), cache


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, cache, cache_len, *,
                impl: str = "auto"):
    """One autoregressive step.  token: (B, 1) int; cache_len: scalar
    int32, a 0-d tensor on the model's device as in the reference (a
    Python int is taken too).  The position stays on the device, so a
    captured step reads it at every replay.

    Returns (logits (B, V), cache)."""
    x = embed_inputs(params, cfg, {"tokens": token})
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32,
                                device=x.device)
    positions = cache_len + torch.arange(1, device=x.device)
    logits, _, cache = forward(params, cfg, x, positions=positions,
                               cache=cache, cache_len=cache_len, impl=impl)
    return vocab_whole(logits[:, -1]), cache


# ---------------------------------------------------------------------------
# paged serving (continuous batching)
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_step_paged(params, cfg: ModelConfig, token, cache, page_table,
                      seq_lens, *, impl: str = "auto"):
    """One decode step for every slot of a continuous batch.

    token: (B, 1) int — each slot's last token (garbage for idle slots);
    cache: stacked paged pool from ``init_paged_cache``;
    page_table: (B, maxp) int32; seq_lens: (B,) int32 per-slot cache fill
    (idle slots: 0 with a trash-page table row).
    Returns (logits (B, V), cache)."""
    x = embed_inputs(params, cfg, {"tokens": token})
    logits, _, cache = forward(params, cfg, x, positions=seq_lens[:, None],
                               cache=cache, cache_len=None,
                               page_table=page_table, seq_lens=seq_lens,
                               impl=impl)
    return vocab_whole(logits[:, -1]), cache


def write_prefill_to_pages(pool, dense_cache, page_ids, page_size: int):
    """Scatter a freshly prefilled dense cache (batch=1, smax a multiple of
    ``page_size``) into the paged pool at the allocated ``page_ids``, in
    place.

    Leaf shapes: dense (ng, 1, smax, Hkv, D) -> pool (ng, n_pages, page,
    Hkv, D), leaf for leaf of the two trees (llama4's pool is
    {"dense": {k, v}, "moe": {k, v}}).  Page row ``p`` receives exactly
    dense row ``p``."""
    leaves = transformer.flatten(pool)
    ids = torch.as_tensor(page_ids, dtype=torch.long,
                          device=leaves[0][1].device)
    npg = ids.shape[0]
    dense = dict(transformer.flatten(dense_cache))
    for name, p in leaves:
        d = dense[name]
        ng, _, smax = d.shape[:3]
        assert smax == npg * page_size, (smax, npg, page_size)
        p[:, ids] = d[:, 0].reshape((ng, npg, page_size) + tuple(d.shape[3:])
                                    ).to(p.dtype)
    return pool
