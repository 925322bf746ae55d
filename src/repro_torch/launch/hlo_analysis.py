"""Roofline terms for a live block (the analytic half of
``repro.launch.hlo_analysis``).

``block_roofline`` gives the Monitor each block's useful FLOPs per step
and its compute-bound step-time floor, so the step-time EWMA reads back
as model FLOPs utilization.  The port has no compiled HLO to walk and no
dry-run sweep of its own: the floor is always the analytic one, against
the H100's peaks.  A TPU dry run's step time is never a torch block's
floor.

One departure: the reference's ``model_step_flops`` takes
``vocab_size * d_model`` off the count as the embedding gather for every
frontend, but the frame frontend (the encoder) has no embedding table, so
for it the reference drops ``vocab_size * d_model`` params of real
matmuls (hubert_xlarge's LM head is 504 x 1280); here nothing is taken
off for a frame frontend.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM (data sheet, dense, at the 700 W limit)
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card


def model_step_flops(cfg, shape) -> float:
    """Analytic useful-FLOPs per step: 6ND for training, 2ND for inference
    (N = active non-embedding params, D = tokens touched per step).  The
    numerator of MFU — what the Monitor divides by measured step time."""
    from repro_torch.models import model as model_lib
    n_active = model_lib.count_active_params(cfg)
    # exclude the embedding gather (not matmul flops); keep lm_head.  The
    # frame frontend has no embedding table
    gather = 0 if cfg.frontend == "frame" else cfg.vocab_size * cfg.d_model
    n_eff = max(n_active - gather, 1)
    if shape.kind == "train":
        return 6.0 * n_eff * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_eff * shape.global_batch * shape.seq_len
    return 2.0 * n_eff * shape.global_batch      # decode: one token per seq


def block_roofline(cfg, shape, n_chips: int) -> Dict:
    """Roofline model for a live block, for ``Monitor.set_roofline``: the
    compute-bound floor (model FLOPs / chips x peak), so every block
    carries an MFU denominator."""
    flops = model_step_flops(cfg, shape)
    return {"model_flops": flops, "n_chips": int(n_chips),
            "peak_flops": PEAK_FLOPS, "source": "analytic",
            "step_time_s": flops / (max(1, n_chips) * PEAK_FLOPS),
            "bottleneck": "compute"}
