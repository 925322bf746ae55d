"""Deterministic synthetic data (the port of ``repro.data.pipeline``).

Reproducible numpy batches keyed on (seed, step) with no host-side state,
byte for byte the reference's; ``batch_shapes``/``prefill_shapes`` give
each input's (shape, torch dtype), ``input_specs`` the dry run's stand-ins
for them (``meta`` tensors); ``DataIterator`` hands a train block
its batch for a step as tensors on its device, and under a data-parallel
layout (``BatchShards``) only the rank's rows of it
(``make_global_batch``), as a dense serve block on a mesh takes its rows
of a prompt batch.
"""
from __future__ import annotations

import dataclasses
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


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` tensors of every input's shape and dtype, the reference's
    ``ShapeDtypeStruct`` stand-ins (the dry run; nothing allocated)."""
    shapes = (batch_shapes(cfg, shape) if shape.kind == "train"
              else prefill_shapes(cfg, shape))
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in shapes.items()}


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


@dataclasses.dataclass(frozen=True)
class BatchShards:
    """A data-parallel rank's rows of a global batch of ``n_micro``
    microbatches over ``dp`` data ranks: its share of **each**
    microbatch, rows ``[i*mb + rank*mb/dp, i*mb + (rank+1)*mb/dp)`` of
    microbatch ``i`` (``mb`` rows each), in microbatch order.  That is
    the reference's routing group (i, rank): its train step splits the
    global batch into microbatches of consecutive rows and the MoE layer
    splits each microbatch into ``dp`` consecutive shards.  When a
    microbatch's rows do not split over ``dp`` every rank holds the whole
    batch (``split`` False)."""
    dp: int
    rank: int
    n_micro: int = 1

    def split(self, rows: int) -> bool:
        n = max(1, self.n_micro)
        return rows % n == 0 and (rows // n) % self.dp == 0

    def rows(self, rows: int) -> np.ndarray:
        """The global row ids this rank holds, in its local order."""
        if not self.split(rows):
            return np.arange(rows)
        n = max(1, self.n_micro)
        mb = rows // n
        per = mb // self.dp
        return np.concatenate([np.arange(i * mb + self.rank * per,
                                         i * mb + (self.rank + 1) * per)
                               for i in range(n)])


def batch_shards(mesh, dp_axes, n_micro: int = 1) -> BatchShards:
    """This rank's ``BatchShards`` on ``mesh`` (a DeviceMesh) with the
    batch split over ``dp_axes`` in mesh order, the first the slowest: on
    a ``("pod", "data", "model")`` mesh over ``("pod", "data")`` each
    rank takes its (pod, data) share of every microbatch, pod-major (the
    reference's ``P(("pod", "data"))``)."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    dp, rank = 1, 0
    for a in names:
        if a in dp_axes:
            n = int(mesh.mesh.shape[names.index(a)])
            dp, rank = dp * n, rank * n + coord[names.index(a)]
    return BatchShards(dp, rank, max(1, n_micro))


def _as_tensor(v: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(
        v.astype(np.float32) if v.dtype == np.float64 else v)


def make_global_batch(np_batch: Dict[str, Any], shardings: BatchShards,
                      device) -> Dict[str, torch.Tensor]:
    """Place a batch on this rank: its rows of every leaf
    (``BatchShards.rows``), on ``device``.  The leaves are numpy arrays
    (a train block's synthetic batch) or tensors (a serve block's
    prompt, on any device)."""
    out = {}
    for k, v in np_batch.items():
        rows = shardings.rows(v.shape[0])
        if isinstance(v, torch.Tensor):
            out[k] = v[torch.as_tensor(rows, device=v.device)].to(device)
        else:
            out[k] = _as_tensor(np.ascontiguousarray(v[rows])).to(device)
    return out


class DataIterator:
    """Stateless-by-construction iterator: batch(step) is a pure function
    of (seed, step), the reference's ``synthetic_batch`` as tensors on
    ``device`` (float64 leaves as float32, as the reference casts), or
    with ``shardings`` this rank's rows of it.  ``device`` defaults to
    ``cuda`` and raises without a card, as the other entry points do."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                 device="cuda", shardings: Optional[BatchShards] = None):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.device = resolve(device)
        self.shardings = shardings

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        np_batch = synthetic_batch(self.cfg, self.shape, step=step,
                                   seed=self.seed)
        if self.shardings is not None:
            return make_global_batch(np_batch, self.shardings, self.device)
        return {k: _as_tensor(v).to(self.device)
                for k, v in np_batch.items()}
