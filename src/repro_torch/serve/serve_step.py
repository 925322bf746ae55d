"""Serving step factories: batched prefill and single-token decode (the
port of ``repro.serve.serve_step``).  Sampling draws from an explicit
``torch.Generator``.  ``abstract_cache`` is a decode cache's restore target
on the ``meta`` device.  ``on_mesh`` runs a decode step on a block's mesh:
each rank decodes its rows of the batch under the block's sharding
context (its share of the heads, Mamba2 heads and vocabulary under tensor
parallelism, the logits whole again before ``pick``; a batch that does
not split, its slice of the cache's positions), and the next tokens come
back whole."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import ctx as shard_ctx

#: a rank's rows ``[lo, hi)`` of a batch of ``n``: (lo, hi, n)
Rows = Tuple[int, int, int]


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch, cache):
        return model_lib.prefill(params, cfg, batch, cache)
    return prefill_step


def pick(logits, *, sample: bool, gen: Optional[torch.Generator] = None,
         temperature: float = 1.0, rows: Optional[Rows] = None):
    """Next token per row of ``logits`` (B, V): greedy argmax (first
    maximum on ties, as ``jnp.argmax``) or a draw from the softmax.  The
    draw is ``torch.multinomial``'s one-sample path written out (the
    argmax of p / q, q ~ Exp(1) from ``gen``): the same draws and tokens,
    without the host-side checks of p that keep a graph from capturing
    it.  ``rows``: ``logits`` are rows ``[lo, hi)`` of a batch of ``n``;
    a draw takes the whole batch's numbers and keeps its rows, so a row
    draws what it would on one device."""
    if sample:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        B, V = probs.shape
        lo, hi, n = rows if rows is not None else (0, B, B)
        q = probs.new_empty((n, V)).exponential_(1.0, generator=gen)
        nxt = torch.argmax(probs / q[lo:hi], dim=-1)
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
                    gen: Optional[torch.Generator] = None,
                    rows: Optional[Rows] = None):
        logits, cache = model_lib.decode_step(params, cfg, token, cache,
                                              cache_len)
        nxt = pick(logits, sample=sample, gen=gen, temperature=temperature,
                   rows=rows)
        return nxt[:, None], cache
    return decode_step


def on_mesh(decode_step, ctx, rows: Rows):
    """``decode_step`` (``make_decode_step``'s) on a block's mesh, called
    as it is: the whole (B, 1) token in, this rank's rows ``rows`` of it
    decoded under the block's sharding context ``ctx`` against a cache
    of those rows, and the next tokens gathered whole over ``data``
    (inside a captured step's graph).  A batch whose rows do not split
    is decoded whole on every rank (``rows`` all of it) against its
    cache as the context lays it out: a slice of the positions where
    ``ctx.seq_split``, the attention's partial results merged over the
    data ranks inside the step."""
    lo, hi, _ = rows

    def fn(params, token, cache, cache_len,
           gen: Optional[torch.Generator] = None):
        with shard_ctx.use(ctx):
            nxt, cache = decode_step(params, token[lo:hi], cache, cache_len,
                                     gen, rows=rows)
            return shard_ctx.gather_rows(nxt), cache
    return fn


def abstract_cache(cfg: ModelConfig, batch: int, smax: int):
    return model_lib.init_cache(cfg, batch, smax, "meta")
