"""Serving step factories: batched prefill and single-token decode (the
port of ``repro.serve.serve_step``).  Sampling draws from an explicit
``torch.Generator``.  ``abstract_cache`` is a decode cache's restore target
on the ``meta`` device."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch, cache):
        return model_lib.prefill(params, cfg, batch, cache)
    return prefill_step


def pick(logits, *, sample: bool, gen: Optional[torch.Generator] = None,
         temperature: float = 1.0):
    """Next token per row of ``logits`` (B, V): greedy argmax (first
    maximum on ties, as ``jnp.argmax``) or a draw from the softmax.  The
    draw is ``torch.multinomial``'s one-sample path written out (the
    argmax of p / q, q ~ Exp(1) from ``gen``): the same draws and tokens,
    without the host-side checks of p that keep a graph from capturing
    it."""
    if sample:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        q = torch.empty_like(probs).exponential_(1.0, generator=gen)
        nxt = torch.argmax(probs / q, dim=-1)
    else:
        nxt = torch.argmax(logits, dim=-1)
    return nxt.to(torch.int32)


def make_decode_step(cfg: ModelConfig, *, sample: bool = False,
                     temperature: float = 1.0):
    """``decode_step(params, token, cache, cache_len, gen=None)`` ->
    (next token (B, 1) int32, cache): ``cache_len`` a 0-d int32 tensor on
    the device, the cache updated in place.  A step launches no host
    sync, so a block captures it (``compile_cache.CapturedStep``)."""
    def decode_step(params, token, cache, cache_len,
                    gen: Optional[torch.Generator] = None):
        logits, cache = model_lib.decode_step(params, cfg, token, cache,
                                              cache_len)
        nxt = pick(logits, sample=sample, gen=gen, temperature=temperature)
        return nxt[:, None], cache
    return decode_step


def abstract_cache(cfg: ModelConfig, batch: int, smax: int):
    return model_lib.init_cache(cfg, batch, smax, "meta")
