"""Deterministic synthetic data (the port of ``repro.data.pipeline``).

Reproducible numpy batches keyed on (seed, step) with no host-side state,
byte for byte the reference's; ``batch_shapes``/``prefill_shapes`` give
each input's (shape, torch dtype); ``DataIterator`` hands a train block
its batch for a step as tensors on its device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models.config import ModelConfig, ShapeConfig

# Pixtral stub geometry (see configs/pixtral_12b.py of the reference)
N_PATCHES = 256


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """(shape, dtype) of every input for a train-kind cell."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "frame":
        return {"frames": ((B, S, cfg.frontend_dim), torch.bfloat16),
                "labels": ((B, S), torch.int32),
                "mask": ((B, S), torch.bool)}
    if cfg.frontend == "patch":
        return {"tokens": ((B, S - N_PATCHES), torch.int32),
                "patches": ((B, N_PATCHES, cfg.frontend_dim), torch.bfloat16),
                "labels": ((B, S - N_PATCHES), torch.int32)}
    return {"tokens": ((B, S), torch.int32),
            "labels": ((B, S), torch.int32)}


def prefill_shapes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "frame":
        return {"frames": ((B, S, cfg.frontend_dim), torch.bfloat16)}
    if cfg.frontend == "patch":
        return {"tokens": ((B, S - N_PATCHES), torch.int32),
                "patches": ((B, N_PATCHES, cfg.frontend_dim), torch.bfloat16)}
    return {"tokens": ((B, S), torch.int32)}


def _lcg_sequences(rng, B: int, S: int, V: int) -> np.ndarray:
    """Learnable token streams: x_{t+1} = (x_t + b) mod V with the stride b
    drawn per sequence from a small set — a deterministic next-token function
    inferable from any adjacent pair, so LM loss drops well below ln V."""
    strides = np.asarray([1, 2, 3, 5, 7, 11])
    b = strides[rng.integers(0, len(strides), (B,))]
    x0 = rng.integers(0, V, (B,))
    t = np.arange(S + 1)[None, :]
    x = (x0[:, None] + b[:, None] * t) % V
    return x.astype(np.int32)


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, *, step: int,
                    seed: int = 0, batch_override: Optional[int] = None,
                    seq_override: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Reproducible numpy batch (host-side)."""
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    out: Dict[str, np.ndarray] = {}
    if cfg.frontend == "frame":
        # frames carry the (scaled) label signal in the first channels plus
        # noise: the masked-prediction task is learnable from context
        labels = _lcg_sequences(rng, B, S - 1, cfg.vocab_size)[:, :S]
        frames = rng.standard_normal((B, S, cfg.frontend_dim),
                                     dtype=np.float32) * 0.1
        frames[:, :, 0] = labels / cfg.vocab_size
        out["frames"] = frames
        out["labels"] = labels
        out["mask"] = rng.random((B, S)) < 0.3
    elif cfg.frontend == "patch":
        n_p = min(N_PATCHES, max(1, S // 8))
        toks = _lcg_sequences(rng, B, S - n_p, cfg.vocab_size)
        out["tokens"] = toks[:, :-1]
        out["patches"] = rng.standard_normal((B, n_p, cfg.frontend_dim),
                                             dtype=np.float32)
        out["labels"] = toks[:, 1:]
    else:
        toks = _lcg_sequences(rng, B, S, cfg.vocab_size)
        out["tokens"] = toks[:, :-1]
        out["labels"] = toks[:, 1:]
    return out


class DataIterator:
    """Stateless-by-construction iterator: batch(step) is a pure function
    of (seed, step), the reference's ``synthetic_batch`` as tensors on
    ``device`` (float64 leaves as float32, as the reference casts).
    ``device`` defaults to ``cuda`` and raises without a card, as the other
    entry points do."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                 device="cuda"):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.device = resolve(device)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        np_batch = synthetic_batch(self.cfg, self.shape, step=step,
                                   seed=self.seed)
        return {k: torch.from_numpy(
                    v.astype(np.float32) if v.dtype == np.float64 else v
                ).to(self.device) for k, v in np_batch.items()}
