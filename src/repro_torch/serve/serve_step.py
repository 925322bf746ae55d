"""Serving step factories: batched prefill and single-token decode (the
port of ``repro.serve.serve_step``).  Sampling draws from an explicit
``torch.Generator``."""
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
    maximum on ties, as ``jnp.argmax``) or a draw from the softmax."""
    if sample:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
    else:
        nxt = torch.argmax(logits, dim=-1)
    return nxt.to(torch.int32)


def make_decode_step(cfg: ModelConfig, *, sample: bool = False,
                     temperature: float = 1.0):
    def decode_step(params, token, cache, cache_len: int,
                    gen: Optional[torch.Generator] = None):
        logits, cache = model_lib.decode_step(params, cfg, token, cache,
                                              cache_len)
        nxt = pick(logits, sample=sample, gen=gen, temperature=temperature)
        return nxt[:, None], cache
    return decode_step
