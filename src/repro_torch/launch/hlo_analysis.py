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

``tp_traffic`` computes what a rank receives over ``model`` a step under
the layouts of items 8a and 8d (no card has measured it: one H100);
``python -m repro_torch.launch.hlo_analysis`` prints the figures
``PERF.md`` quotes.
"""
from __future__ import annotations

import math
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


def tp_traffic(cfg, shape, mesh) -> Dict[str, int]:
    """Computed, not measured: the bytes one rank receives over the
    ``model`` axis in one step of ``shape`` on ``mesh`` (``{axis: size}``)
    under 8a's layout (every leaf the plan shards over ``model`` gathered
    whole, each rank of a model column computing the same rows) and
    under 8d's (``plans.tp_layout``: the leaves it keeps whole gathered,
    and the model column's activation collectives).  A ring all-reduce
    receives 2 (M - 1) / M of its tensor, an all-gather (M - 1) / M.  A
    train step runs its microbatches under remat (the groups forward
    twice) and a backward; a prefill and a decode step (one token a
    row) run forward, the serve logits gathered over the vocabulary.
    Activations are in the params' dtype, the vocab-parallel
    cross-entropy's three (B, S) all-reduces (its shift, its sum of
    exponentials, its gold logit) in fp32; the data axes' traffic is
    left out.  The joins' part is what ``shard_ctx.JOINED`` counts as
    they run, the gathers' what ``shard_ctx.GATHERED`` counts."""
    from repro_torch.models import transformer
    from repro_torch.models.moe import capacity
    from repro_torch.sharding import plans
    M = mesh["model"]
    dp = math.prod(n for a, n in mesh.items() if a != "model")
    train = shape.kind == "train"
    n_micro = max(1, shape.microbatch) if train else 1
    rows = shape.global_batch // n_micro // dp
    T = rows * (1 if shape.kind == "decode" else shape.seq_len)
    item = 4 if cfg.param_dtype == "float32" else 2
    remat = train and cfg.remat != "none"
    whole = plans.tp_layout(cfg, mesh, paged=True)      # nothing sharded
    tp = plans.tp_layout(cfg, mesh)
    ar, ag = 2 * (M - 1) / M, (M - 1) / M
    act = T * cfg.d_model * item
    # per group, forward: the all-reduces and the experts' all-gather;
    # backward: one all-reduce a sharded region (``copy_in``)
    regions = {"attn": 0, "mlp": 0, "shared": 0, "experts": 0}
    if cfg.family == "moe":
        regions["attn"] = 2 if cfg.d_ff > 0 else 1
        regions["mlp"] = 1 if cfg.d_ff > 0 else 0
        regions["shared"] = 1 if cfg.moe.n_shared else 0
        regions["experts"] = 1
    elif cfg.family in plans.TP_FAMILIES:
        regions["attn"] = regions["mlp"] = 1
    on = {k: n for k, n in regions.items() if tp.computes(k)}
    ng = transformer.n_groups(cfg)
    reduced = sum(n for k, n in on.items() if k != "experts")
    fwd = ng * reduced * act * ar
    if "experts" in on:
        m = cfg.moe
        E_C = m.n_experts * capacity(T, m)
        fwd += ng * E_C * cfg.d_model * item * ag
    vocab = tp.computes("vocab")
    top_fwd = act * ar if vocab and cfg.frontend != "frame" else 0
    if train:
        bwd = ng * sum(on.values()) * act * ar + (act * ar if vocab else 0)
        xent = 3 * T * 4 * ar if vocab else 0
        # remat's recompute stops at the group's last saved tensor
        # (PyTorch's non-reentrant checkpoint): a dense group's closing
        # all-reduce, the MLP's, is not run again; a MoE group's aux loss
        # saves tensors after its last join
        last = act * ar if "mlp" in on and cfg.family != "moe" else 0
        d8 = (fwd + (fwd - ng * last if remat else 0) + top_fwd + xent
              + bwd)
    else:
        d8 = fwd + top_fwd + (rows * cfg.vocab_size * item * ag
                              if vocab else 0)
    return {"8a": int(n_micro * whole.step_bytes(1, remat)),
            "8d": int(n_micro * (d8 + tp.step_bytes(1, remat)))}


def main() -> None:
    """Print the computed figures ``PERF.md`` quotes (no card, no
    process group: meta tensors only)."""
    import json
    import repro_torch.configs as configs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding import plans
    ds = configs.get("deepseek_7b")
    shapes = {"train 2 x 2048": ShapeConfig("t", "train", 2048, 2, 1),
              "prefill 4 x 512": ShapeConfig("p", "prefill", 512, 4),
              "decode 4 rows": ShapeConfig("d", "decode", 1, 4)}
    for m in (2, 4):
        for name, shape in shapes.items():
            got = tp_traffic(ds, shape, {"data": 1, "model": m})
            print(json.dumps({"deepseek_7b": f"(1, {m})", "step": name,
                              "gb_8a": got["8a"] / 1e9,
                              "gb_8d": got["8d"] / 1e9}))
    lay = plans.tp_layout(configs.get("llama4_maverick_400b"),
                          {"data": 1, "model": 8})
    print(json.dumps({"llama4_maverick_400b": "(1, 8)",
                      "group_gb_8d": lay.group_bytes / 1e9,
                      "group_gb_8a": lay.group_bytes_whole / 1e9,
                      **lay.summary()}))


if __name__ == "__main__":
    main()
