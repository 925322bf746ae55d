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
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Transformer,  # re-export
                                            embed_inputs, forward,
                                            init_cache, init_paged_cache)

init_params = transformer.init_params
check_paged_support = transformer.check_paged_support


def abstract_params(cfg: ModelConfig):
    return transformer.init_params(cfg, device="meta")


def count_params(tree) -> int:
    return sum(math.prod(leaf.shape) for _, leaf in transformer.flatten(tree))


def count_active_params(cfg: ModelConfig) -> int:
    """Params touched per token: every param in the dense family (the
    routed-expert discount comes with the MoE family)."""
    return count_params(abstract_params(cfg))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _xent(logits, labels, mask):
    """Cross-entropy in fp32 with a validity mask.  logits: (B, S, V)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = (lse - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    return nll.sum() / denom


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            impl: str = "auto"):
    """Next-token loss of the token frontend (the dense family).  Returns
    (total loss, {"loss", "aux_loss"}) as 0-d fp32 tensors."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"frontend {cfg.frontend!r} is not yet ported (its family comes "
            f"with a later slice)")
    x = embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    logits, aux, _ = forward(params, cfg, x, positions=positions, impl=impl)
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
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, cache, cache_len: int, *,
                impl: str = "auto"):
    """One autoregressive step.  token: (B, 1) int; cache_len: int.

    Returns (logits (B, V), cache)."""
    x = embed_inputs(params, cfg, {"tokens": token})
    positions = int(cache_len) + torch.arange(1, device=x.device)
    logits, _, cache = forward(params, cfg, x, positions=positions,
                               cache=cache, cache_len=cache_len, impl=impl)
    return logits[:, -1], cache


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
    return logits[:, -1], cache


def write_prefill_to_pages(pool, dense_cache, page_ids, page_size: int):
    """Scatter a freshly prefilled dense cache (batch=1, smax a multiple of
    ``page_size``) into the paged pool at the allocated ``page_ids``, in
    place.

    Leaf shapes: dense (ng, 1, smax, Hkv, D) -> pool (ng, n_pages, page,
    Hkv, D).  Page row ``p`` receives exactly dense row ``p``."""
    some = next(iter(pool.values()))
    ids = torch.as_tensor(page_ids, dtype=torch.long, device=some.device)
    npg = ids.shape[0]
    for name, p in pool.items():
        d = dense_cache[name]
        ng, _, smax = d.shape[:3]
        assert smax == npg * page_size, (smax, npg, page_size)
        p[:, ids] = d[:, 0].reshape((ng, npg, page_size) + tuple(d.shape[3:])
                                    ).to(p.dtype)
    return pool
