"""Collective traffic and roofline terms (the port of
``repro.launch.hlo_analysis``), on the H100's peaks.

``collective_stats`` is the reference's parser of an HLO text's
collectives (operand bytes by kind), unchanged.  ``Roofline`` keeps the
reference's terms and ``to_dict`` keys on the H100's peaks
(``PEAK_FLOPS``, ``HBM_BW``, ``LINK_BW`` within a pod and
``POD_LINK_BW`` across pods); ``analyze`` builds one from the port's dry
run's counts (``launch.dryrun``: the port has no compiled executable,
its step runs on fake tensors of a fake process group), where the
reference takes a compiled executable.

``block_roofline`` gives the Monitor each block's useful FLOPs per step
and its step-time floor, so the step-time EWMA reads back as model FLOPs
utilization.  The floor is compute-bound: the analytic model FLOPs, or,
where ``python -m repro_torch.launch.dryrun --out`` wrote a cell for the
(arch, shape) under ``artifacts/dryrun_torch/`` (``dryrun_roofline``;
git-ignored), the FLOPs the dry run counted, over the block's chips at
the peak.  The dry run's memory term is not a floor (it counts every
eager op's operands and results, more than the card moves through its
caches), so the cell's own roofline rides beside, under ``dryrun``.  A
TPU dry run's step time (the reference's ``artifacts/dryrun/``) is
never a torch block's floor.

One departure: the reference's ``model_step_flops`` takes
``vocab_size * d_model`` off the count as the embedding gather for every
frontend, but the frame frontend (the encoder) has no embedding table, so
for it the reference drops ``vocab_size * d_model`` params of real
matmuls (hubert_xlarge's LM head is 504 x 1280); here nothing is taken
off for a frame frontend.

``tp_traffic`` computes what a rank receives over ``model`` a step under
the layouts of items 8a and 8d, and ``pod_traffic`` what a rank sends and
receives over ``pod`` under the serial and the overlapped train steps
(item 9; no card has measured either: one H100);
``python -m repro_torch.launch.hlo_analysis`` prints the figures
``PERF.md`` quotes.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import re
from typing import Dict, Optional

# NVIDIA H100 SXM (data sheet, dense, at the 700 W limit)
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
# NVLink 4 within a pod (a node's cards): the H100 SXM data sheet's 900
# GB/s a card is both directions, 450e9 each way
LINK_BW = 450e9              # bytes/s per card, one direction
# across pods: one 400 Gb/s NDR InfiniBand port per card (the DGX H100
# data sheet's eight ConnectX-7 ports for eight cards), 50e9 each way
POD_LINK_BW = 50e9           # bytes/s per card, one direction

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute", "collective-broadcast")

# e.g.  bf16[16,4096,5120]{2,1,0}
_SHAPE_RE = re.compile(r"\b([a-z]+\d+(?:e\d+m\d+(?:fn)?)?|pred)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(?:\([^)]*\)|[^=]+?)\s*"
    r"(all-gather-start|all-gather|all-reduce-start|all-reduce|"
    r"reduce-scatter|all-to-all|collective-permute-start|collective-permute|"
    r"collective-broadcast)\(", re.M)


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims.strip():
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.counts.values())


def collective_stats(hlo_text: str) -> CollectiveStats:
    counts: Dict[str, int] = {}
    total: Dict[str, int] = {}
    for line in hlo_text.splitlines():
        m = _OP_RE.match(line)
        if not m:
            continue
        kind = m.group(1).replace("-start", "")
        # operand shapes = every shape appearing AFTER the opcode's '('
        after = line[m.end():]
        op_bytes = sum(_shape_bytes(d, s) for d, s in _SHAPE_RE.findall(after))
        counts[kind] = counts.get(kind, 0) + 1
        total[kind] = total.get(kind, 0) + op_bytes
    return CollectiveStats(counts=counts, bytes_by_kind=total)


@dataclasses.dataclass
class Roofline:
    """The reference's roofline terms on the H100's peaks.  Totals are
    across all devices (a rank's counts times ``n_chips``); the
    collective term splits the bytes within a pod (``LINK_BW``) from
    those on groups across pods (``pod_collective_bytes``,
    ``POD_LINK_BW``), each at one link's rate a card."""
    hlo_flops: float             # total FLOPs across all devices
    hlo_bytes: float             # total HBM bytes accessed across devices
    collective_bytes: float      # summed collective operand bytes (all)
    n_chips: int
    model_flops: float = 0.0
    bytes_per_device: float = 0.0
    pod_collective_bytes: float = 0.0   # the share on groups across pods

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.n_chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.n_chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        inside = self.collective_bytes - self.pod_collective_bytes
        return (inside / (self.n_chips * LINK_BW)
                + self.pod_collective_bytes / (self.n_chips * POD_LINK_BW))

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the modeled step time:
        useful (model) FLOPs / (step_time * peak).  1.0 = compute-bound with
        zero waste."""
        denom = self.step_time_s * self.n_chips * PEAK_FLOPS
        return self.model_flops / denom if denom else 0.0

    xla_cost: Optional[Dict] = None
    coll_detail: Optional[Dict] = None

    def to_dict(self) -> Dict:
        return {
            "xla_cost": self.xla_cost,
            "coll_detail": self.coll_detail,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "pod_collective_bytes": self.pod_collective_bytes,
            "n_chips": self.n_chips,
            "model_flops": self.model_flops,
            "bytes_per_device": self.bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze(counts: Dict, *, n_chips: int,
            model_flops: float = 0.0) -> Roofline:
    """Roofline terms from one rank's dry-run counts (``launch.dryrun``:
    ``flops``, ``bytes``, ``coll_bytes`` and ``coll_counts`` by kind,
    ``pod_bytes`` and ``peak_bytes``), scaled by ``n_chips`` into global
    quantities as the reference scales its per-device program's; the
    three terms then equal the per-device time under perfect balance.
    There is no XLA cost to cross-check (``xla_cost`` is None)."""
    coll = dict(counts.get("coll_bytes", {}))
    r = Roofline(hlo_flops=counts["flops"] * n_chips,
                 hlo_bytes=counts["bytes"] * n_chips,
                 collective_bytes=sum(coll.values()) * n_chips,
                 n_chips=n_chips, model_flops=model_flops,
                 bytes_per_device=float(counts.get("peak_bytes", 0.0)),
                 pod_collective_bytes=counts.get("pod_bytes", 0) * n_chips)
    r.coll_detail = {"bytes_by_kind": coll,
                     "counts": dict(counts.get("coll_counts", {}))}
    return r


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
    """Roofline model for a live block, for ``Monitor.set_roofline``.

    The step-time floor is compute-bound: model FLOPs / (chips x peak),
    raised to the port's dry-run cell's counted FLOPs (remat's recompute
    and the kernels' own formulas in them) over the same chips and peak
    where a sweep has a cell for this (arch, shape): work the card
    cannot do faster.  The cell's roofline (``step_time_s`` with its
    eager memory term, ``bottleneck``, the three terms and its chips)
    is kept under ``dryrun``, beside the floor and never as it."""
    flops = model_step_flops(cfg, shape)
    chips = max(1, n_chips)
    out = {"model_flops": flops, "n_chips": int(n_chips),
           "peak_flops": PEAK_FLOPS, "source": "analytic",
           "step_time_s": flops / (chips * PEAK_FLOPS),
           "bottleneck": "compute"}
    cell = dryrun_roofline(getattr(cfg, "name", None),
                           getattr(shape, "name", None))
    if cell:
        counted = cell.get("hlo_flops", 0.0) / (chips * PEAK_FLOPS)
        out.update({"source": "dryrun",
                     "step_time_s": max(out["step_time_s"], counted),
                     "model_flops": cell.get("model_flops", flops) or flops,
                     "dryrun": {k: cell[k] for k in (
                         "step_time_s", "bottleneck", "compute_s",
                         "memory_s", "collective_s", "n_chips")
                         if k in cell}})
    return out


#: where ``python -m repro_torch.launch.dryrun --out`` sweeps are read
#: from: the port's own directory, never the reference's
#: ``artifacts/dryrun/``
DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "artifacts", "dryrun_torch")


def dryrun_roofline(arch: Optional[str],
                    shape_name: Optional[str]) -> Optional[Dict]:
    """The port's dry-run roofline dict for one cell, or None.

    Reads ``DRYRUN_DIR/*.jsonl`` (``repro_torch.launch.dryrun --all
    --out``).  Single-pod cells win over multi-pod when both exist."""
    if not arch or not shape_name:
        return None
    best = None
    for path in sorted(glob.glob(os.path.join(DRYRUN_DIR, "*.jsonl"))):
        try:
            with open(path) as f:
                for line in f:
                    try:
                        d = json.loads(line)
                    except ValueError:
                        continue
                    if (d.get("arch") == arch
                            and d.get("shape") == shape_name
                            and d.get("status") == "ok"
                            and "roofline" in d):
                        if best is None or d.get("mesh") == "single":
                            best = d["roofline"]
        except OSError:
            continue
    return best


def tp_traffic(cfg, shape, mesh, exchange: bool = True) -> Dict[str, int]:
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
    left out.  A hybrid's Mamba2 sublayers each join as a region and
    gather their column's ``y`` for the gated norm (its gradient summed
    back); of their ``w_in`` and ``conv_w`` a rank brings the columns
    its heads compute with that its chunk lacks (``TPLayout.exchange``),
    and their ``norm`` whole (``plans.MAMBA_SLICED``, in
    ``TPLayout.step_bytes``).  An MLA
    attention joins as one region, its H / M heads' ``wq_b``, ``wk_b``,
    ``wv_b`` and ``wo`` the rank's shards; its ``plans.MLA_WHOLE``
    leaves, replicated over ``model`` by the plan, bring nothing.  An
    xLSTM group's mLSTM sublayers each join as a region (entered with
    ``copy_in``, left with ``reduce_out``) and gather their column's
    ``h`` (``inner`` wide, ``gather_sum``) for the output norm; its
    sLSTM enters with ``copy_in`` and gathers its column's ``h``
    (``d_model`` wide, ``gather_out``: no backward collective), and its
    feed-forward, where it computes sharded, joins as a region of its
    own, the group's last join; its mLSTM's ``w_up`` and sLSTM's
    ``w_gates`` are exchanged as Mamba2's ``w_in``.  Of the param
    gradients a train step counts those the exchange sends back to the
    ranks owning the columns (once a microbatch, ``TPLayout.step_bytes``
    with ``backward``); the gradients of the other leaves of
    ``TPLayout.partial``, summed over the column by DTensor's
    reduce-scatter over all the mesh's axes, are left out with the data
    axes' traffic.  An exchange brings each rank another count of bytes:
    "8d" is the rank that receives the most.  Without ``exchange``, "8d"
    has the exchanged leaves gathered whole
    (``TPLayout.step_bytes_whole``), as the port gathered them before
    the exchange, a train step counting their gradients' reduce-scatter
    over the model column in place of the exchange's return.  The
    joins' part is what ``shard_ctx.JOINED``
    counts as they run, the gathers' and the exchange's what
    ``shard_ctx.GATHERED`` counts."""
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
    regions = {"attn": 0, "mlp": 0, "shared": 0, "experts": 0, "mamba": 0}
    if cfg.family == "moe":
        regions["attn"] = 2 if cfg.d_ff > 0 else 1
        regions["mlp"] = 1 if cfg.d_ff > 0 else 0
        regions["shared"] = 1 if cfg.moe.n_shared else 0
        regions["experts"] = 1
    elif cfg.family != "xlstm":
        regions["attn"] = regions["mlp"] = 1
        if cfg.family == "hybrid":
            regions["mamba"] = cfg.hybrid.mamba_per_group
    on = {k: n for k, n in regions.items() if tp.computes(k)}
    ng = transformer.n_groups(cfg)
    reduced = sum(n for k, n in on.items() if k != "experts")
    fwd = ng * reduced * act * ar
    # a Mamba2 sublayer's gated norm gathers its column's y (d_inner
    # wide, ``shard_ctx.gather_sum``) and sums its gradient back
    y_whole = T * (cfg.ssm.expand * cfg.d_model if cfg.ssm else 0) * item
    fwd += ng * on.get("mamba", 0) * y_whole * ag
    # the xLSTM's regions, per group: forward and backward
    x_fwd = x_bwd = 0
    if cfg.family == "xlstm":
        n_m = cfg.xlstm.slstm_every - 1
        h_whole = T * int(cfg.xlstm.proj_factor * cfg.d_model) * item
        if tp.computes("mlstm"):
            x_fwd += n_m * (act * ar + h_whole * ag)
            x_bwd += n_m * (act * ar + h_whole * ar)
        if tp.computes("slstm"):
            x_fwd += act * ag
            x_bwd += act * ar
        if tp.computes("slstm_ff"):
            x_fwd += act * ar
            x_bwd += act * ar
    fwd += ng * x_fwd
    if "experts" in on:
        m = cfg.moe
        E_C = m.n_experts * capacity(T, m)
        fwd += ng * E_C * cfg.d_model * item * ag
    vocab = tp.computes("vocab")
    top_fwd = act * ar if vocab and cfg.frontend != "frame" else 0
    if train:
        bwd = (ng * sum(on.values()) * act * ar + (act * ar if vocab else 0)
               + ng * on.get("mamba", 0) * y_whole * ar + ng * x_bwd)
        xent = 3 * T * 4 * ar if vocab else 0
        # remat's recompute stops at the group's last saved tensor
        # (PyTorch's non-reentrant checkpoint): a dense group's closing
        # all-reduce, the MLP's, is not run again; a MoE group's aux loss
        # saves tensors after its last join; an xLSTM group's last join
        # is its feed-forward's, where that computes sharded
        last = act * ar if (("mlp" in on and cfg.family != "moe")
                            or tp.computes("slstm_ff")) else 0
        d8 = (fwd + (fwd - ng * last if remat else 0) + top_fwd + xent
              + bwd)
    else:
        d8 = fwd + top_fwd + (rows * cfg.vocab_size * item * ag
                              if vocab else 0)
    gathered = (tp.step_bytes(1, remat, backward=train) if exchange
                else tp.step_bytes_whole(1, remat, backward=train))
    return {"8a": int(n_micro * whole.step_bytes(1, remat)),
            "8d": int(n_micro * (d8 + gathered))}


def pod_traffic(cfg, shape, mesh) -> Dict:
    """Computed, not measured: what one rank moves over the pods in one
    train step of ``shape`` on ``mesh`` (``{axis: size}`` with ``pod``,
    the params replicated over it, item 9), for the serial step and the
    overlapped one (``make_train_step(overlap_comm=True)``).  For each:
    ``operand``, the collectives' operand bytes (the reference's
    convention; ``launch.dryrun.StepCounter`` counts the same), and
    ``sent`` and ``received``, a ring's bytes (an all-reduce of n bytes
    over P ranks 2 (P - 1) / P n each way, an all-gather of n-byte
    shards (P - 1) n).

    * serial: each microbatch's gradient all-reduced over ``pod`` in the
      params' dtype before its reduce-scatter over ``data`` (DTensor
      takes the mesh dims in order: a leaf's whole gradient over the
      data ranks, its ``model`` shard where ``plans.tp_layout`` computes
      it sharded), and the loss's two fp32 sums;
    * overlapped: each microbatch's int8 codes of the rank's shards
      (``grad_compression.pod_bytes``: the int8 all-gather), its scales'
      MAX all-reduce over the block (4 bytes a leaf), and the step's
      per-microbatch losses (4 bytes each).

    A MoE layer's aux-loss sums are left out."""
    from repro_torch.models import model as model_lib
    from repro_torch.sharding import plans
    from repro_torch.train import grad_compression as gc
    P = mesh["pod"]
    ranks = math.prod(mesh.values())
    n_micro = max(1, shape.microbatch)
    params = model_lib.abstract_params(cfg)
    spec = dict(plans._dict_leaves(plans.param_specs(
        params, mesh, plans.MeshAxes(dp=("data",), model="model"))))
    tp = plans.tp_layout(cfg, mesh)
    whole = local = 0
    leaves = list(plans._dict_leaves(params))
    for keys, p in leaves:
        local += math.prod(plans.local_shape(p.shape, spec[keys], mesh))
        whole += p.numel() * p.element_size() // (
            tp.model if "/".join(keys) in tp.leaves else 1)
    ar = 2 * (P - 1) / P
    serial_op = n_micro * (whole + 8)
    red = gc.pod_bytes(local, len(leaves), P, ranks)
    over_op = n_micro * (local + 4 * len(leaves)) + 4 * n_micro
    over_ring = n_micro * (red["payload"] + red["scales"]) + ar * 4 * n_micro
    return {"serial": {"operand": int(serial_op),
                       "sent": int(ar * serial_op),
                       "received": int(ar * serial_op)},
            "overlap": {"operand": int(over_op), "sent": int(over_ring),
                        "received": int(over_ring)}}


def main() -> None:
    """Print the computed figures ``PERF.md`` quotes (no card, no
    process group: meta tensors only).  ``gb_8d_whole``: 8d with the
    exchanged leaves gathered whole (``tp_traffic(exchange=False)``),
    where the layout exchanges any."""
    import json
    import repro_torch.configs as configs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding import plans
    shapes = {"train 2 x 2048": ShapeConfig("t", "train", 2048, 2, 1),
              "prefill 4 x 512": ShapeConfig("p", "prefill", 512, 4),
              "decode 4 rows": ShapeConfig("d", "decode", 1, 4)}

    def steps(arch, cfg, m):
        for name, shape in shapes.items():
            mesh = {"data": 1, "model": m}
            got = tp_traffic(cfg, shape, mesh)
            line = {arch: f"(1, {m})", "step": name,
                    "gb_8a": got["8a"] / 1e9, "gb_8d": got["8d"] / 1e9}
            whole = tp_traffic(cfg, shape, mesh, exchange=False)["8d"]
            if whole != got["8d"]:
                line["gb_8d_whole"] = whole / 1e9
            print(json.dumps(line))

    def group(arch, cfg, m):
        lay = plans.tp_layout(cfg, {"data": 1, "model": m})
        print(json.dumps({arch: f"(1, {m})",
                          "group_gb_8d": lay.group_bytes / 1e9,
                          "group_gb_8a": lay.group_bytes_whole / 1e9,
                          **lay.summary()}))

    for arch, ms, groups in (("deepseek_7b", (2, 4), False),
                             ("zamba2_2p7b", (2, 4, 8, 16), True),
                             ("deepseek_v2_236b", (2, 16), True),
                             ("xlstm_350m", (2, 4), True)):
        cfg = configs.get(arch)
        for m in ms:
            steps(arch, cfg, m)
            if groups:
                group(arch, cfg, m)
    group("llama4_maverick_400b", configs.get("llama4_maverick_400b"), 8)


if __name__ == "__main__":
    main()
