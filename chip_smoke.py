#!/usr/bin/env python3
"""Run the PyTorch port's serve and train paths on one NVIDIA card and
check them.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and
the repository's ``src/``; imports ``repro_torch``, ``torch`` and numpy,
never JAX.  Phases, each printing one JSON line:

1. ``device``      — the card (``nvidia-smi`` name and power limit), torch
                     and CUDA versions;
2. ``build``       — builds the CUDA kernels from ``src/repro_torch/kernels/
                     csrc`` with ``nvcc`` for ``sm_90a`` (into ``build/``);
3. ``kernels``     — each kernel against its plain PyTorch version on the
                     card, element by element, at the main paths'
                     full-width shapes and at edge cases (among them the
                     paged plane's admission prefill shapes, the other
                     dense configs' head groups, ragged and all-zero
                     quantization blocks, the SSD scan's ragged and short
                     sequences, initial states and extreme timesteps),
                     with its time, the plain
                     version's, one PyTorch library call's where one
                     computes the same function, and the least time the
                     card could take; each redesigned kernel also beside
                     the route it took before (``was_ms``: the flash
                     kernels' CUDA-core route, the scalar routes of the
                     fused AdamW, the paged decode kernel, the SSD scan,
                     its backward and the RMSNorm backward), on a copy of
                     its input one element off alignment, held by the same
                     check; the flash backward, the paged kernel, the SSD
                     scan, its backward and the RMSNorm backward twice,
                     bit for bit; the SSD scan's, its backward's and the
                     RMSNorm backward's kernels timed apart
                     (``passes_ms``), each held under a guard time
                     (``GUARD_MS``); the SSD backward's seven cotangents
                     each element by element at zamba2_2p7b's train shape
                     and at edge cases, each case's route checked, and
                     its tensor-core kernels' ptxas lines free of spills;
4. ``serve_dense`` — ``repro_torch.launch.serve`` on deepseek_7b at full
                     width (random bf16 weights from the seed): batched
                     prefill + greedy decode, the decode steps as CUDA
                     graph replays (one capture, a replay a step, no
                     eager decode step), the kernels' launches exactly,
                     the prefill logits against the same path with
                     ``impl="torch"``, and 31 replays against 31 eager
                     steps from one state (every token and the cache's
                     bits equal; ``captured_vs_eager``), with a sampling
                     job's captured decode against its eager one on both
                     planes at smoke size (``sampled_vs_eager``);
5. ``serve_paged`` — a paged serve ``BlockRuntime`` on the same model: 12
                     generate sessions through 8 slots, the decode rounds
                     as graph replays, the launches exactly, the logits
                     of two admission prefills (two prompt buckets) and
                     of the first decode round against ``impl="torch"``,
                     tokens/s and TTFT, then the same traffic with the
                     rounds run eagerly from the same (empty) state: every
                     session's tokens and the pool's bits equal;
6. ``serve_hybrid`` — ``repro_torch.launch.serve`` on zamba2_2p7b (the
                     hybrid family: Mamba2 + shared attention) at full
                     width, 54 layers, random bf16 weights from the seed:
                     4 x 1000 prompt tokens, 32 generated, the decode
                     steps as graph replays held against eager ones as in
                     ``serve_dense``; the launches of
                     one prefill and one decode step, exactly; the prefill
                     logits and the first decode step's (from the state
                     each prefill left) against ``impl="torch"`` in fp32
                     (the weights upcast) within 0.1% of their range, and
                     in bf16 each group's output, fed the same input,
                     within 5% of the range of its update, and the SSM
                     states within 5% of theirs (``hybrid_group_check``);
7. ``train``       — a train ``BlockRuntime`` on deepseek_7b at full width
                     (30 layers, random bf16 weights from the seed, int8
                     AdamW moments, 2 x 2048 tokens a step, remat): the
                     step-0 loss and grad norm against ``impl="torch"``,
                     then six steps with their losses, tokens/s, step time,
                     peak memory, the kernels' launches per step (held
                     exactly, as in every train phase) and a profiled
                     warm step;
8. ``train_f32``   — the same width cut to 4 layers with fp32 moments and
                     2 microbatches: the fp32 AdamW variant and the serial
                     gradient accumulation;
9. ``train_hybrid`` — a train ``BlockRuntime`` on zamba2_2p7b at full width
                     (54 layers, random bf16 weights from the seed, fp32
                     AdamW moments, 2 x 2048 tokens a step, remat): step 0
                     in fp32 (the weights upcast) against ``impl="torch"``
                     under the dense phases' limits, and the bf16 step 0
                     against the fp32 one, within 1.25 times the plain
                     version's bf16 distance (``step0_upcast_check``),
                     then 4 steps, the kernels' launches per step held
                     exactly (the SSD scan's backward kernel among them),
                     tokens/s, step time, peak memory and a profiled step;
10. ``preempt``    — checkpoints and preempt/resume at full width
                     (``BlockRuntime.suspend``/``resume`` through
                     ``repro_torch.checkpoint.manager``, under a temporary
                     directory): train_hybrid's job suspended after 3
                     steps and resumed, its 4 losses and grad norms
                     train_hybrid's bit for bit and the resumed step's
                     launches exact; serve_paged's 12 sessions suspended
                     after a third of their rounds, each session's tokens
                     those of a run without a break; serve_hybrid's dense
                     decode with an async save after 4 steps and a
                     suspend after 8, its 16 tokens a row those of 16
                     uninterrupted steps.  Each suspend releases the
                     block's decode graph and leaves under 1% of the
                     state's bytes on the card, each resume is a hit of
                     the compile cache (no new miss) and captures once
                     again, and it restores the state's per-leaf
                     checksums; save, suspend and
                     resume seconds and GB/s, the async save's overlap
                     with the steps, ``progress_lost`` before and after
                     the save, disk space and peak memory;
11. ``control``    — the control plane on the card: a background-mode
                     ``ClusterDaemon`` on one chip, Alice's train block
                     (train_hybrid's job) autostepping toward 4 steps,
                     preempted after 2 by Bob's priority-1 paged serve
                     block (serve_paged's job), whose 12 sessions run
                     through ``daemon.generate`` and the engine's decode
                     rounds (graph replays) until his period ends and the
                     pump's tick resumes Alice; her losses and grad norms
                     train_hybrid's and his tokens serve_paged's, bit for
                     bit, the events in order, her resume a compile-cache
                     hit, the memory while Bob runs, the launches exactly;
                     admission, preemption, first-token and resume
                     seconds, each block's tok/s inside the daemon and
                     Alice's MFU on the H100 roofline.

Then one JSON line (``decode_capture``) giving each decode path's step
wall time, idle share and tok/s run eagerly and as graph replays, its
capture time and graph pool, beside the ``nvidia-smi`` line; one JSON line
listing every kernel (its launches inside graphs among them), the
``nvidia-smi`` line, and as the last line ``{"ok": true, "device":
{...}}``.  Every JSON line is also
written to ``build/chip_smoke.jsonl`` beside the script, whole (the
kernels line is longer than a terminal's tail).  Any failed check exits
non-zero without that line; so does a machine without CUDA or a
directory without the package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

_CSRC = "src/repro_torch/kernels/csrc/"
KERNEL_META = {
    "flash_attention": {
        "source": _CSRC + "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:27"},
    "rmsnorm": {
        "source": _CSRC + "rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:19"},
    "paged_attention": {
        "source": _CSRC + "paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:40"},
    # the backward kernels' counterparts are JAX's gradients, not TPU
    # kernels: the custom VJP _flash_bwd_rule and autodiff of ops.rmsnorm
    "flash_attention_bwd": {
        "source": _CSRC + "flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/ops.py:125"},
    "rmsnorm_bwd": {
        "source": _CSRC + "rmsnorm.cu",
        "replaces": "src/repro/kernels/ops.py:243"},
    "fused_adamw": {
        "source": _CSRC + "fused_adamw.cu",
        "replaces": "src/repro/kernels/fused_adamw.py:73"},
    "ssd_scan": {
        "source": _CSRC + "ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:20"},
    # the SSD backward's counterpart is autodiff of the reference's jnp
    # scan (its Pallas kernel has no VJP), not a TPU kernel
    "ssd_scan_bwd": {
        "source": _CSRC + "ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ops.py:319"},
}

# kernel-name substrings that ``profile_steps`` sums device time over
KERNEL_FAMILIES = ("flash_", "rmsnorm", "paged_decode", "fused_adamw",
                   "ssd_scan", "ssd_bwd")

# launch counter -> (kernel module, counter attribute)
COUNTERS = {
    "flash_attention": ("flash_attention", "LAUNCHES"),
    "flash_attention_bwd": ("flash_attention", "BWD_LAUNCHES"),
    "rmsnorm": ("rmsnorm", "LAUNCHES"),
    "rmsnorm_bwd": ("rmsnorm", "BWD_LAUNCHES"),
    "paged_attention": ("paged_attention", "LAUNCHES"),
    "fused_adamw_i8": ("fused_adamw", "LAUNCHES_I8"),
    "fused_adamw_f32": ("fused_adamw", "LAUNCHES_F32"),
    "ssd_scan": ("ssd_scan", "LAUNCHES"),
    "ssd_scan_bwd": ("ssd_scan", "BWD_LAUNCHES"),
    # the calls of the kernels above that took their scalar route
    "fused_adamw_scalar": ("fused_adamw", "LAUNCHES_SCALAR"),
    "paged_attention_scalar": ("paged_attention", "LAUNCHES_SCALAR"),
    "ssd_scan_scalar": ("ssd_scan", "LAUNCHES_SCALAR"),
    "rmsnorm_bwd_scalar": ("rmsnorm", "BWD_LAUNCHES_SCALAR"),
    "ssd_scan_bwd_scalar": ("ssd_scan", "BWD_LAUNCHES_SCALAR"),
}

# guard limits, in ms at the main path's shape: a redesigned kernel slower
# than this has lost its redesign (the routes before read 1.23, 0.0795 and
# 2.155; NVIDIA H100 80GB HBM3, 700 W)
GUARD_MS = {"ssd_scan": 0.6, "rmsnorm_bwd": 0.07, "ssd_scan_bwd": 1.0}


_RECORD = None     # main() opens build/chip_smoke.jsonl here
_CARD = None       # phase_device's nvidia-smi line, beside every time


def emit(phase: str, **data) -> None:
    line = json.dumps({"phase": phase, **data})
    print(line, flush=True)
    if _RECORD is not None:
        _RECORD.write(line + "\n")
        _RECORD.flush()


_T0 = time.perf_counter()


def progress(msg: str) -> None:
    """A timestamped note on stderr, so a cut run shows where it was."""
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------- counters

def _counter(name):
    import importlib
    mod, attr = COUNTERS[name]
    return importlib.import_module(f"repro_torch.kernels.{mod}"), attr


def counts():
    out = {}
    for n in COUNTERS:
        mod, attr = _counter(n)
        out[n] = getattr(mod, attr)
    return out


def set_counts(values):
    for n in COUNTERS:
        mod, attr = _counter(n)
        setattr(mod, attr, values[n])


def zero_counts():
    set_counts({n: 0 for n in COUNTERS})


def route_of(counter, fn, routes):
    """Call ``fn``; return its result and the route its kernel took:
    ``routes[1]`` when the scalar-route counter ``counter`` moved, else
    ``routes[0]``."""
    mod, attr = _counter(counter)
    before = getattr(mod, attr)
    res = fn()
    return res, routes[int(getattr(mod, attr) > before)]


# ----------------------------------------------------------------- timing

_FLUSH = None


def flush_l2() -> None:
    """Overwrite the 50 MB L2 so the next launch reads its inputs cold,
    as it does on the serving path where the other layers' weights pass
    through the cache in between."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    _FLUSH.zero_()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each between
    its own CUDA events with a cold L2.  A spin kernel queued before the
    first event keeps the card busy while the host enqueues the event,
    ``fn`` and the second event, so the host's launch overhead (the
    ctypes call, PyTorch's dispatch) falls outside the measured span."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush_l2()
        torch.cuda._sleep(2_000_000)      # ~1 ms at the H100's clocks
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def profile_steps(fn, n: int = 3, top: int = 8):
    """Host wall time per call of ``fn`` (warm, ending in a device sync),
    then the device kernel time per call over ``n`` more calls under
    ``torch.profiler``, the device's idle share, and the ``top`` kernels
    that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev = sum(e.self_device_time_total for e in kern) / 1e3 / n
    kern.sort(key=lambda e: -e.self_device_time_total)
    top = [{"kernel": e.key[:80], "ms_per_call":
            e.self_device_time_total / 1e3 / n, "count_per_call":
            e.count / n} for e in kern[:top]]
    # the port's kernels by family: device ms per call and share of the
    # device time (the flash family counts forward, backward and delta)
    fam = {}
    for name in KERNEL_FAMILIES:
        ms = sum(e.self_device_time_total for e in kern
                 if name in e.key) / 1e3 / n
        fam[name] = {"ms_per_call": ms, "share": ms / dev if dev else 0.0}
    return {"wall_ms": wall, "device_ms": dev,
            "idle_share": max(0.0, 1.0 - dev / wall), "top": top,
            "families": fam}


def bound(nbytes: float, flops: float, flop_rate: float = BF16_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def rms(t) -> float:
    return float(t.float().pow(2).mean().sqrt())


def close(got, want, rtol: float):
    """Element by element, |got - want| <= rtol * (|want| + rms(want)).

    Returns (max abs error, worst error / tolerance over the elements);
    the check passes when the second is at most 1.  A bf16 output rounds
    to within 2^-8 of its magnitude, so the kernel and its plain version
    (both fp32 inside) may land one bf16 step apart: rtol 2e-2 leaves room
    for that and no more.  The rms term keeps values near 0 from needing
    bit equality; a fault that spoils a subset of rows moves them by about
    their own size, far past either term."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = (rtol * (w.abs() + rms(w))).clamp_min(1e-30)
    return float(diff.max()), float((diff / tol).max())


def logits_check(got, want, rtol: float = 5e-2) -> dict:
    """A whole path's logits against the same path with ``impl="torch"``,
    within ``rtol`` of the logits' range, 5% by default: each of the 30
    layers rounds its bf16 activations, and a kernel and its plain version
    may round a value to neighbouring bf16 steps; those differences pass
    through the rest of the stack.  The kernels themselves are held
    element by element (``close``) in the kernels phase."""
    err = max_err(got, want)
    tol = rtol * max(1.0, float(want.float().abs().max()))
    check(bool(torch.isfinite(got).all()), "logits not finite")
    return {"max_abs_err": err, "tol": tol, "passed": err <= tol,
            "rms_err": rms(got.float() - want.float()), "rms_want": rms(want),
            "argmax_agree": float((torch.argmax(got, -1)
                                   == torch.argmax(want, -1)).float().mean())}


# The hybrid's checks (``serve_hybrid``).  In fp32 (the same weights
# upcast, every kernel in its fp32 instantiation, TF32 off) the whole
# stack's logits with the kernels lie within HYBRID_F32_RTOL of their range
# of ``impl="torch"`` (17x the 5.9e-5 read on the H100).  In bf16 the
# random-weight stack grows one bf16 step of difference in a layer's
# output to 6-7% of the logits' range over its 9 groups (read on the H100;
# the bf16 plain run lies as far from an fp32 run as the bf16 kernel run
# does), so the whole stack's bf16 logits are read, not checked.  bf16 is
# held group by group (``hybrid_group_check``): each group with the
# kernels against the same group with ``impl="torch"``, fed the same
# input, within HYBRID_GROUP_RTOL of the range of the group's update (its
# output less its input; read at most 3.1% in the prefill and 2.1% in the
# decode step), and the SSM states the prefill leaves within the same
# share of their range (read 0.43%).  One head of one bf16 SSD scan zeroed
# reads 41-53% (at smoke size on the CPU).
HYBRID_F32_RTOL = 1e-3
HYBRID_GROUP_RTOL = 5e-2


def update_check(x_in, got, want) -> dict:
    """One group's output with the kernels (``got``) against its output
    with the plain versions (``want``) from the same input ``x_in``, in
    units of the range of the plain group's update ``want - x_in``."""
    upd = want.float() - x_in.float()
    err, span = max_err(got, want), float(upd.abs().max())
    return {"max_abs_err": err, "update_range": span,
            "err_over_range": err / max(span, 1e-30),
            "rms_err": rms(got.float() - want.float()), "rms_update": rms(upd),
            "finite": bool(torch.isfinite(got).all())}


@torch.no_grad()
def hybrid_group_check(params, cfg, tokens, first) -> dict:
    """The bf16 stack one group at a time, the kernels' stream carried on:
    group g with the kernels and with ``impl="torch"`` on the same input,
    each writing its own cache; first the prefill of ``tokens``, then the
    decode step of ``first``, where each variant steps from the state its
    own prefill left (the kernel's final SSM state against the plain
    version's).  Returns the per-group ``update_check`` rows and the SSM
    states' distance after the prefill."""
    from repro_torch.models import model
    from repro_torch.models import transformer as tf
    B, P = tokens.shape
    ng = tf.n_groups(cfg)
    groups = tf._unbind(params["layers"], ng)
    caches = {impl: model.init_cache(cfg, B, P + 1, tokens.device)
              for impl in ("auto", "torch")}
    rows = {}
    for step, toks, start in (("prefill", tokens, 0), ("decode", first, P)):
        x = model.embed_inputs(params, cfg, {"tokens": toks})
        pos = start + torch.arange(toks.shape[1], device=x.device)
        rows[step] = []
        for g, gp in enumerate(groups):
            out = {impl: tf.group_fwd(gp, x, cfg, positions=pos,
                                      cache=tf._index(caches[impl], g),
                                      cache_len=start, extra=params["extra"],
                                      impl=impl)[0]
                   for impl in ("auto", "torch")}
            rows[step].append(update_check(x, out["auto"], out["torch"]))
            x = out["auto"]
        if step == "prefill":
            hs = [c["mamba"]["ssm"] for c in caches.values()]
            rows["ssm_state_after_prefill"] = {
                "max_abs_err": max_err(*hs),
                "err_over_range": max_err(*hs) / float(hs[1].abs().max()),
                "rms_err": rms(hs[0] - hs[1]), "rms_state": rms(hs[1])}
    return rows


def _chunks(*ts, n: int = 1 << 26):
    """Matching flat slices of same-shaped tensors, ``n`` elements at a
    time (a full-width optimizer leaf has 1.35e9 elements: whole-tensor
    temporaries in int64 would not fit beside it)."""
    flat = [t.reshape(-1) for t in ts]
    for i in range(0, flat[0].numel(), n):
        yield [f[i:i + n] for f in flat]


def ulp_dist(got, want) -> int:
    """Largest distance between two float tensors of one dtype in units in
    the last place (0 where they are bitwise equal; -0 and +0 are 0
    apart)."""
    it = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[want.dtype]
    lo = -(1 << (8 * want.element_size() - 1))

    def ordered(t):
        i = t.contiguous().view(it).long()
        return torch.where(i >= 0, i, lo - i)

    return max((int((ordered(g) - ordered(w)).abs().max())
                for g, w in _chunks(got, want)), default=0)


# ------------------------------------------------------------ the phases

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    info = {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "capability": list(torch.cuda.get_device_capability(0))}
    global _CARD
    _CARD = smi
    emit("device", **info)
    return info


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.load()._name
    build_s = time.perf_counter() - t0
    log = os.path.join(os.path.dirname(path), "build.log")
    ptxas, per_kernel, name = [], {}, None
    if os.path.exists(log):
        with open(log) as f:
            for ln in f:
                if "Compiling entry function" in ln:
                    name = ln.split("'")[1] if "'" in ln else None
                if "registers" in ln or "spill" in ln:
                    ptxas.append(ln.strip())
                    if name and any(k in name for k in PTXAS_KERNELS):
                        per_kernel.setdefault(name, []).append(
                            ln.split(":", 1)[-1].strip())
    emit("build", seconds=build_s, library=os.path.relpath(path, ROOT),
         ptxas=ptxas, ptxas_by_kernel=per_kernel,
         sass_instructions=sass_counts(path))
    # the SSD backward's six tensor-core kernels keep their registers: no
    # spills
    tc = {k: v for k, v in per_kernel.items()
          if "ssd_bwd" in k and "tc_" in k}
    check(len(tc) == 6 and all(
        any("0 bytes spill stores, 0 bytes spill loads" in ln for ln in v)
        for v in tc.values()),
        f"ssd_scan_bwd tensor-core kernels' ptxas lines: {tc}")
    return build_s


SASS_FAMILIES = ("fused_adamw", "paged_decode")
# kernels whose registers, shared memory and spills the build line gives
# by name (ptxas -v): the SSD scan's, its backward's and the RMSNorm
# backward's
PTXAS_KERNELS = ("ssd_scan", "ssd_bwd", "rmsnorm_bwd", "rmsnorm_dscale")


def sass_counts(lib: str) -> dict:
    """Static SASS instruction count of each fused AdamW and paged decode
    kernel in the built library (``cuobjdump -sass``; slow paths and
    both branches included), by mangled name; {} without cuobjdump."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.default_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
            name = name if any(f in name for f in SASS_FAMILIES) else None
            if name:
                counts[name] = 0
        elif name and ln.strip().startswith("/*") and ";" in ln:
            counts[name] += 1
    return counts


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _randn(shape, g, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def misaligned(t):
    """A contiguous copy of ``t`` one element off 16-byte alignment: the
    flash entry points then take their CUDA-core route (the TMA loads of
    the tensor-core route need 16-byte aligned rows), the fused AdamW and
    the paged decode kernel their scalar route (16-byte vector loads)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def flash_case(B, Hq, Hkv, Sq, Sk, D, Dv, causal=True, window=0,
               q_offset=0, dtype=torch.bfloat16, seed=0):
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_torch)
    g = _gen(seed)
    q = _randn((B, Hq, Sq, D), g, dtype)
    k = _randn((B, Hkv, Sk, D), g, dtype)
    v = _randn((B, Hkv, Sk, Dv), g, dtype)
    kw = dict(causal=causal, sliding_window=window, q_offset=q_offset)
    got = flash_attention_cuda(q, k, v, **kw)
    want = flash_attention_torch(q, k, v, **kw)
    torch.cuda.synchronize()
    return (q, k, v, kw), got, want


def rms_case(rows, d, dtype=torch.bfloat16, seed=1, offset=0):
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_torch
    g = _gen(seed)
    # ``offset`` shifts x off 16-byte alignment: the kernel's scalar path
    x = _randn((rows * d + offset,), g, dtype)[offset:].view(rows, d)
    s = _randn((d,), g, dtype)
    got = rmsnorm_cuda(x, s)
    want = rmsnorm_torch(x, s)
    torch.cuda.synchronize()
    return (x, s), got, want


def paged_case(lens, Hq, Hkv, D, Dv, page=16, maxp=64, dtype=torch.bfloat16,
               seed=2, poison_trash=False):
    """A decode round's inputs, the kernel's output, the plain version's
    and the kernel's route ("split" or "scalar")."""
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_torch)
    B = len(lens)
    n_pages = B * maxp + 1
    g = _gen(seed)
    k_pages = _randn((n_pages, page, Hkv, D), g, dtype)
    v_pages = _randn((n_pages, page, Hkv, Dv), g, dtype)
    if poison_trash:
        k_pages[0], v_pages[0] = 1e4, -1e4
    q = _randn((B, Hq, D), g, dtype)
    rng = np.random.default_rng(seed)
    free = list(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((B, maxp), np.int32)
    for b, ln in enumerate(lens):
        for j in range(-(-ln // page)):
            table[b, j] = free.pop()
    pt = torch.from_numpy(table).cuda()
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got, route = route_of("paged_attention_scalar", lambda: (
        paged_attention_cuda(q, k_pages, v_pages, pt, sl)),
        ("split", "scalar"))
    want = paged_attention_torch(q, k_pages, v_pages, pt, sl)
    torch.cuda.synchronize()
    return (q, k_pages, v_pages, pt, sl), got, want, route


def ssd_inputs(Bt, S, H, P, N, chunk, dtype=torch.bfloat16, h0="zeros",
               dt_max=None, zero_dt_block=False, seed=6, misalign=False):
    """The SSD scan's inputs as the Mamba2 layer gives them: x, B and C
    strided slices of one conv output (its base one element off 16-byte
    alignment with ``misalign``), dt softplus'd (scaled to reach
    ``dt_max``, or 0 over the first chunk), A = -exp(.), h0 zeros (as a
    prefill from a fresh cache), random or None.  Returns ((x, dt, A, B,
    C, D), h0, the generator, to draw more from)."""
    import torch.nn.functional as F
    g = _gen(seed)
    di = H * P
    conv = _randn((Bt * S * (di + 2 * N) + int(misalign),), g, dtype)
    conv = conv[int(misalign):].view(Bt, S, di + 2 * N)
    x = conv[..., :di].reshape(Bt, S, H, P)
    B, C = conv[..., di:di + N], conv[..., di + N:]
    dt = F.softplus(_randn((Bt, S, H), g, torch.float32) - 1.0)
    if dt_max is not None:
        dt = dt * (dt_max / dt.max())
    if zero_dt_block:
        dt[:, :min(chunk, S)] = 0.0
    A = -torch.exp(_randn((H,), g, torch.float32, 0.5))
    D = _randn((H,), g, torch.float32)
    h = {"zeros": torch.zeros((Bt, H, P, N), device="cuda"), "none": None,
         "random": _randn((Bt, H, P, N), g, torch.float32, 0.5)}[h0]
    return (x, dt, A, B, C, D), h, g


def ssd_case(Bt, S, H, P, N, chunk, dtype=torch.bfloat16, h0="zeros",
             dt_max=None, zero_dt_block=False, seed=6):
    """The SSD scan on ``ssd_inputs``: (inputs, the kernel's (y,
    h_final), the plain version's, the kernel's route, "chunked" or
    "scalar")."""
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_torch
    args, h, _ = ssd_inputs(Bt, S, H, P, N, chunk, dtype, h0, dt_max,
                            zero_dt_block, seed)
    got, route = route_of("ssd_scan_scalar", lambda: ssd_scan_cuda(
        *args, chunk=chunk, h0=h), ("chunked", "scalar"))
    want = ssd_scan_torch(*args, chunk=chunk, h0=h)
    torch.cuda.synchronize()
    return (args, chunk, h), got, want, route


def ssd_cost(x, B, h0, chunk):
    """(bytes, flops) of one SSD scan: every input read once and y and the
    final state written once; the chunked form's operations over the
    chunks this sequence has (C.B^T and the weighted sum over j <= t per
    head, the inter-chunk product and the state update)."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    es = x.element_size()
    nbytes = (2 * x.numel() * es + 2 * B.numel() * es + 4 * Bt * S * H
              + 8 * H + 4 * Bt * H * P * N * (2 if h0 is not None else 1))
    Q = min(chunk, S)
    lens = [Q] * (S // Q) + ([S % Q] if S % Q else [])
    flops = Bt * H * sum(q * (q + 1) * (N + P) + 4 * q * N * P
                         for q in lens)
    return nbytes, flops


def ssd_bwd_cost(x, B, h0, dh_final, chunk):
    """(bytes, flops) of one SSD backward: every input (x, dt, A, B, C, D,
    dy, h0 and dh_final where given) read once and every cotangent written
    once; the operations the chunked backward needs over the chunks this
    sequence has, per head: dy_t . x_j and sum_t W[t, j] dy_t over the
    causal triangle, and five (P, N) products of a chunk's rows (the
    chunk's state, the entering state's cotangent, and the state terms of
    dx, dB and dC); per (batch, chunk), shared by the heads: C.B^T and
    the two products of dCB with B and C."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    es = x.element_size()
    states = 4 * Bt * H * P * N
    nbytes = (3 * x.numel() * es + 2 * 2 * B.numel() * es
              + 2 * 4 * Bt * S * H + 2 * 8 * H + states
              + (states if h0 is not None else 0)
              + (states if dh_final is not None else 0))
    Q = min(chunk, S)
    lens = [Q] * (S // Q) + ([S % Q] if S % Q else [])
    flops = Bt * sum(H * (2 * q * (q + 1) * P + 10 * q * P * N)
                     + 3 * q * (q + 1) * N for q in lens)
    return nbytes, flops


SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


def ssd_bwd_rtol(name, dtype):
    """dx, dB and dC in bf16 within 2e-2 (one bf16 step, as every bf16
    output here); every fp32 cotangent within 1e-3 (what fp32 summation
    order alone moves is read at the train shape: the fp32 plain version
    against its own float64 run, ``fp32_plain_vs_f64``)."""
    return (2e-2 if name in ("dx", "dB", "dC") and dtype == torch.bfloat16
            else 1e-3)


def ssd_bwd_case(Bt, S, H, P, N, chunk, dtype=torch.bfloat16, h0="zeros",
                 dh="random", dt_max=None, zero_dt_block=False, seed=7,
                 misalign=False):
    """The SSD backward kernel and its plain version on ``ssd_inputs``
    with a random cotangent dy of y (x's dtype) and dh of the final state
    (fp32, or None).  Returns ((inputs, dy, dh, chunk, h0), the kernel's
    seven cotangents, the plain version's, the kernel's route,
    "tensor_core" or "scalar")."""
    from repro_torch.kernels.ssd_scan import (ssd_scan_bwd_cuda,
                                              ssd_scan_bwd_torch)
    args, h, g = ssd_inputs(Bt, S, H, P, N, chunk, dtype, h0, dt_max,
                            zero_dt_block, seed, misalign)
    dy = _randn((Bt, S, H, P), g, dtype)
    dhf = (_randn((Bt, H, P, N), g, torch.float32, 0.5) if dh == "random"
           else None)
    got, route = route_of("ssd_scan_bwd_scalar", lambda: ssd_scan_bwd_cuda(
        *args, dy, dhf, chunk=chunk, h0=h), ("tensor_core", "scalar"))
    want = ssd_scan_bwd_torch(*args, dy, dhf, chunk=chunk, h0=h)
    torch.cuda.synchronize()
    return (args, dy, dhf, chunk, h), got, want, route


def ssd_bwd_held(what, got, want, dtype):
    """Every cotangent element by element against the plain version
    (``ssd_bwd_rtol``): {name: max_err, rtol, err_over_tol}; fails on one
    outside its tolerance or not finite."""
    res = {}
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        rtol = ssd_bwd_rtol(name, dtype)
        err, ratio = close(g, w, rtol)
        res[name] = {"max_err": err, "rtol": rtol, "err_over_tol": ratio}
        check(ratio <= 1.0 and bool(torch.isfinite(g).all()),
              f"ssd_scan_bwd {what} {name}: max_abs_err {err}, {ratio} x "
              f"its tolerance (rtol {rtol})")
    return res


def check_ssd_bwd_kernel(out, edge, edges):
    """The SSD backward at zamba2_2p7b's train shape (timed) and at edge
    cases, every cotangent element by element against the plain version
    (``ssd_bwd_rtol``).  bf16 takes the tensor-core route, which is also
    held against its passes in plain PyTorch
    (``ssd_scan_bwd_passes_torch``), twice on the same inputs, bit for bit,
    and under its guard time; its seven kernels are timed apart
    (``passes_ms``); the scalar route on a copy of x one element off
    alignment is held and timed (``was_route``).  At the train shape also
    the fp32 plain version's distance from its own float64 run (what fp32
    summation order alone moves)."""
    from repro_torch.kernels.ssd_scan import (ssd_scan_bwd_cuda,
                                              ssd_scan_bwd_passes_torch,
                                              ssd_scan_bwd_torch)
    progress("kernels: ssd_scan_bwd")
    (args, dy, dhf, chunk, h0), got, want, route = ssd_bwd_case(
        2, 2048, 80, 64, 64, 256)
    check(route == "tensor_core",
          f"ssd_scan_bwd train shape: {route} route")
    dtype = args[0].dtype
    res = ssd_bwd_held("train shape", got, want, dtype)
    again = ssd_scan_bwd_cuda(*args, dy, dhf, chunk=chunk, h0=h0)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "ssd_scan_bwd: two calls on the same inputs differ")
    del again
    passes = ssd_scan_bwd_passes_torch(*args, dy, dhf, chunk=chunk, h0=h0)
    vs_passes = {n: r["err_over_tol"] for n, r in ssd_bwd_held(
        "train shape against its passes in plain PyTorch", got, passes,
        dtype).items()}
    del passes
    # the fp32 plain version against its float64 run: what fp32 summation
    # order alone moves each fp32 cotangent, in units of its rtol
    f64 = ssd_scan_bwd_torch(*(t.double() for t in args), dy.double(),
                             dhf.double(), chunk=chunk, h0=h0.double())
    vs64 = {}
    for name, w, w64 in zip(SSD_BWD_NAMES, want, f64):
        if w.dtype == torch.float32:
            vs64[name] = close(w, w64, ssd_bwd_rtol(name, w.dtype))[1]
    del f64
    nbytes, flops = ssd_bwd_cost(args[0], args[3], h0, dhf, chunk)
    b_ms, b_by = bound(nbytes, flops)
    # the scalar route on the same values, x one element off alignment
    margs = (misaligned(args[0]),) + args[1:]
    sgot, sroute = route_of("ssd_scan_bwd_scalar", lambda: ssd_scan_bwd_cuda(
        *margs, dy, dhf, chunk=chunk, h0=h0), ("tensor_core", "scalar"))
    check(sroute == "scalar", f"ssd_scan_bwd on a misaligned x: {sroute} "
          f"route")
    sres = ssd_bwd_held("scalar route", sgot, want, dtype)
    del sgot

    def kernel():
        return ssd_scan_bwd_cuda(*args, dy, dhf, chunk=chunk, h0=h0)

    kernel_ms = time_ms(kernel)
    check(kernel_ms <= GUARD_MS["ssd_scan_bwd"],
          f"ssd_scan_bwd train shape: {kernel_ms} ms, above its "
          f"{GUARD_MS['ssd_scan_bwd']} ms guard")
    out["ssd_scan_bwd"] = {
        "shape": {"x": list(args[0].shape), "N": args[3].shape[-1],
                  "chunk": chunk, "h0": "zeros", "dh_final": "random"},
        "route": route,
        "max_err": max(r["max_err"] for r in res.values()),
        "outputs": res, "vs_passes_plain": vs_passes,
        "fp32_plain_vs_f64": vs64, "bitwise_reproducible": True,
        "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda: ssd_scan_bwd_torch(
            *args, dy, dhf, chunk=chunk, h0=h0), iters=3),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": nbytes, "flops": flops,
        # the tensor-core route's nine kernels, apart
        "passes_ms": {t["kernel"]: t["ms_per_call"] for t in profile_steps(
            kernel, 5, top=12)["top"] if "ssd_bwd" in t["kernel"]},
        "was_route": {"route": "scalar", "outputs": sres,
                      "kernel_ms": time_ms(lambda: ssd_scan_bwd_cuda(
                          *margs, dy, dhf, chunk=chunk, h0=h0), iters=5)}}
    out["ssd_scan_bwd"]["tflops"] = flops / kernel_ms / 1e9
    del args, margs, dy, dhf, h0, got, want
    for name, shape, kw in [
            ("S1000_ragged", (2, 1000, 80, 64, 64, 256), {}),
            ("S17_lt_chunk", (2, 17, 80, 64, 64, 256), {}),
            # a short last chunk of whole 64-row tiles; P and N narrower
            # than 64 and unequal
            ("S640_tiles_not_chunks", (2, 640, 16, 64, 64, 256),
             dict(h0="random")),
            ("P32_N48", (2, 300, 8, 32, 48, 128), dict(h0="random")),
            ("h0_random", (2, 600, 16, 64, 64, 256), dict(h0="random")),
            ("dh_final_none", (2, 300, 16, 64, 64, 256),
             dict(dh="none", h0="none")),
            ("f32", (2, 600, 16, 64, 64, 256),
             dict(dtype=torch.float32, h0="random")),
            ("zero_dt_block", (2, 600, 16, 64, 64, 256),
             dict(zero_dt_block=True, h0="random")),
            ("dt_max_20", (2, 600, 16, 64, 64, 256),
             dict(dt_max=20.0, h0="random")),
            # every case reads B and C as strided views of a conv output;
            # here its base is one element off 16-byte alignment
            ("misaligned_base", (2, 300, 16, 64, 64, 256),
             dict(misalign=True, h0="random")),
            ("smoke_width", (2, 40, 8, 16, 16, 16), dict(h0="random"))]:
        (args, dy, dhf, chunk, h0), got, want, route = ssd_bwd_case(
            *shape, **kw)
        expect = ("scalar" if name in ("f32", "misaligned_base")
                  else "tensor_core")
        check(route == expect, f"ssd_scan_bwd {name}: {route} route, want "
              f"{expect}")
        for gname, g, w in zip(SSD_BWD_NAMES, got, want):
            edge("ssd_scan_bwd", f"{name}_{gname}", g, w,
                 ssd_bwd_rtol(gname, args[0].dtype))
            edges[-1]["route"] = route
        if name in ("misaligned_base", "S1000_ragged"):
            again = ssd_scan_bwd_cuda(*args, dy, dhf, chunk=chunk, h0=h0)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"ssd_scan_bwd {name}: two calls differ")


def check_ssd_kernel(out, edge, edges):
    """The SSD scan at zamba2_2p7b's prefill shape (timed) and at edge
    cases: y within rtol 2e-2 (bf16) or 1e-4 (f32), the fp32 final state
    within 1e-4 of the plain version (the same chunked algorithm).  At
    the prefill shape, with a random h0 and with dt up to 20 the kernel is
    also held against the sequential oracle ``ref.ssd_scan`` (another
    algorithm: fp32 y and the final state within 5e-3, the JAX tests'
    rtol against the reference's oracle; bf16 y within 2e-2).  bf16 takes
    the chunked route, which is also held against its passes in plain
    PyTorch (``ssd_scan_passes_torch``) and twice on the same inputs, bit
    for bit; its four kernels are timed apart; the scalar route on a copy
    of x one element off alignment is held and timed (``was_route``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import (ssd_scan_cuda,
                                              ssd_scan_passes_torch,
                                              ssd_scan_torch)

    def vs_oracle(case, args, chunk, h0, y, hf):
        yo, ho = ref.ssd_scan(*args, h0=h0)
        edge("ssd_scan", f"{case}_y_vs_oracle", y, yo,
             5e-3 if y.dtype == torch.float32 else 2e-2)
        edge("ssd_scan", f"{case}_h_final_vs_oracle", hf, ho, 5e-3)

    progress("kernels: ssd_scan")
    (args, chunk, h0), got, want, route = ssd_case(4, 1000, 80, 64, 64, 256)
    (y, hf), (yw, hw) = got, want
    err, ratio = close(y, yw, 2e-2)
    h_err, h_ratio = close(hf, hw, 1e-4)
    check(route == "chunked" and ratio <= 1.0 and h_ratio <= 1.0
          and bool(torch.isfinite(y.float()).all()),
          f"ssd_scan full width: {route} route, y max_abs_err {err} "
          f"({ratio} x tol), h_final {h_err} ({h_ratio} x tol)")
    vs_oracle("full_width", args, chunk, h0, y, hf)
    again = ssd_scan_cuda(*args, chunk=chunk, h0=h0)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "ssd_scan: two calls on the same inputs differ")
    yp, hp = ssd_scan_passes_torch(*args, chunk=chunk, h0=h0)
    p_err, p_ratio = close(y, yp, 2e-2)
    ph_err, ph_ratio = close(hf, hp, 1e-4)
    check(p_ratio <= 1.0 and ph_ratio <= 1.0,
          f"ssd_scan full width against its passes in plain PyTorch: y "
          f"{p_err} ({p_ratio} x tol), h_final {ph_err} ({ph_ratio} x tol)")
    del again, yp, hp
    nbytes, flops = ssd_cost(args[0], args[3], h0, chunk)
    b_ms, b_by = bound(nbytes, flops)
    xm = misaligned(args[0])
    margs = (xm,) + args[1:]
    (sy, shf), sroute = route_of("ssd_scan_scalar", lambda: ssd_scan_cuda(
        *margs, chunk=chunk, h0=h0), ("chunked", "scalar"))
    s_err, s_ratio = close(sy, yw, 2e-2)
    sh_err, sh_ratio = close(shf, hw, 1e-4)
    check(sroute == "scalar" and s_ratio <= 1.0 and sh_ratio <= 1.0,
          f"ssd_scan on a misaligned x: {sroute} route, y {s_err} "
          f"({s_ratio} x tol), h_final {sh_err} ({sh_ratio} x tol)")
    kernel_ms = time_ms(lambda: ssd_scan_cuda(*args, chunk=chunk, h0=h0))
    check(kernel_ms <= GUARD_MS["ssd_scan"],
          f"ssd_scan full width: {kernel_ms} ms, above its "
          f"{GUARD_MS['ssd_scan']} ms guard")
    out["ssd_scan"] = {
        "shape": {"x": list(args[0].shape), "N": args[3].shape[-1],
                  "chunk": chunk, "h0": "zeros"},
        "route": route, "max_err": err, "rtol": 2e-2, "err_over_tol": ratio,
        "h_final_max_err": h_err, "h_final_err_over_tol": h_ratio,
        "bitwise_reproducible": True,
        "vs_passes_plain": {"y_err_over_tol": p_ratio,
                            "h_final_err_over_tol": ph_ratio},
        "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda: ssd_scan_torch(*args, chunk=chunk,
                                                   h0=h0), iters=3),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": nbytes, "flops": flops,
        # the chunked route's four kernels, apart
        "passes_ms": {t["kernel"]: t["ms_per_call"] for t in profile_steps(
            lambda: ssd_scan_cuda(*args, chunk=chunk, h0=h0), 20)["top"]
            if "ssd_scan" in t["kernel"]},
        "was_route": {"route": "scalar", "max_err": s_err,
                      "err_over_tol": s_ratio,
                      "h_final_err_over_tol": sh_ratio,
                      "kernel_ms": time_ms(lambda: ssd_scan_cuda(
                          *margs, chunk=chunk, h0=h0), iters=5)}}
    del args, margs, xm, got, want, y, hf, yw, hw, sy, shf
    for name, shape, kw in [
            # the hybrid train step's forward: 8 whole chunks, no h0
            ("train_shape", (2, 2048, 80, 64, 64, 256), dict(h0="none")),
            ("S17_lt_chunk", (2, 17, 80, 64, 64, 256), {}),
            ("S256_one_chunk", (2, 256, 80, 64, 64, 256), {}),
            ("S1000_ragged_B1", (1, 1000, 80, 64, 64, 256), {}),
            # S a multiple of 64 but not of the chunk: a short last chunk
            # of whole 64-row tiles
            ("S640_tiles_not_chunks", (2, 640, 16, 64, 64, 256),
             dict(h0="random")),
            ("Bt1_H1", (1, 700, 1, 64, 64, 256), dict(h0="random")),
            ("h0_random", (2, 600, 80, 64, 64, 256), dict(h0="random")),
            ("h0_none", (2, 300, 16, 64, 64, 256), dict(h0="none")),
            ("f32", (2, 600, 16, 64, 64, 256),
             dict(dtype=torch.float32, h0="random")),
            ("smoke_width", (2, 40, 8, 16, 16, 16), dict(h0="random")),
            ("dt_max_20", (2, 600, 16, 64, 64, 256),
             dict(dt_max=20.0, h0="random")),
            ("zero_dt_block", (2, 600, 16, 64, 64, 256),
             dict(zero_dt_block=True, h0="random"))]:
        (args, chunk, h0), (y, hf), (yw, hw), route = ssd_case(*shape, **kw)
        f32 = kw.get("dtype") == torch.float32
        check(route == ("scalar" if f32 else "chunked"),
              f"ssd_scan {name}: {route} route")
        rel = 1e-4 if f32 else 2e-2
        edge("ssd_scan", f"{name}_y", y, yw, rel)
        edges[-1]["route"] = route
        edge("ssd_scan", f"{name}_h_final", hf, hw, 1e-4)
        edges[-1]["route"] = route
        if name in ("h0_random", "dt_max_20"):
            vs_oracle(name, args, chunk, h0, y, hf)


def flash_bwd_case(B, Hq, Hkv, Sq, Sk, D, Dv, causal=True, window=0,
                   q_offset=0, dtype=torch.bfloat16, seed=3):
    """The forward kernel's o and lse beside its plain version's, then the
    backward kernel and its plain version on the same (q, k, v, o, lse,
    do)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_torch,
        flash_attention_cuda, flash_attention_torch)
    g = _gen(seed)
    q = _randn((B, Hq, Sq, D), g, dtype)
    k = _randn((B, Hkv, Sk, D), g, dtype)
    v = _randn((B, Hkv, Sk, Dv), g, dtype)
    do = _randn((B, Hq, Sq, Dv), g, dtype)
    kw = dict(causal=causal, sliding_window=window, q_offset=q_offset)
    o, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
    o_plain, lse_plain = flash_attention_torch(q, k, v, with_lse=True, **kw)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    return (q, k, v, o, lse, do, kw), got, want, (o, o_plain, lse, lse_plain)


def rms_bwd_case(rows, d, dtype=torch.bfloat16, seed=4, offset=0):
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda,
                                             rmsnorm_bwd_torch)
    g = _gen(seed)
    x = _randn((rows * d + offset,), g, dtype)[offset:].view(rows, d)
    s = _randn((d,), g, dtype)
    gy = _randn((rows * d + offset,), g, dtype)[offset:].view(rows, d)
    got, route = route_of("rmsnorm_bwd_scalar", lambda: rmsnorm_bwd_cuda(
        x, s, gy), ("vector", "scalar"))
    want = rmsnorm_bwd_torch(x, s, gy)
    torch.cuda.synchronize()
    return (x, s, gy), got, want, route


ADAM_HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
ADAM_SCALARS = (3e-4, 0.7, 0.1, 0.05)       # lr, clip scale, bc1, bc2


def adamw_run(p, g, m, v, sc, hyper, misalign=False):
    """The kernel in place on copies of (p, m, v), p one element off
    16-byte alignment with ``misalign`` (the scalar route); returns the
    copies and the route the kernel took ("vector" or "scalar")."""
    from repro_torch.kernels.fused_adamw import fused_adamw_cuda

    def copy(t):
        return ({k: x.clone() for k, x in t.items()} if isinstance(t, dict)
                else t.clone())

    got = (misaligned(p) if misalign else p.clone(), copy(m), copy(v))
    _, route = route_of("fused_adamw_scalar", lambda: fused_adamw_cuda(
        got[0], g, got[1], got[2], sc, **hyper), ("vector", "scalar"))
    torch.cuda.synchronize()
    return got, route


def adamw_case(shape, quant, p_dtype=torch.bfloat16, g_dtype=torch.bfloat16,
               seed=5, zero_block=False, misalign=False):
    """A leaf's update by the plain version, then by the kernel in place
    on copies of the same inputs (``adamw_run``).  Returns (inputs, the
    kernel's (p, m, v), the plain version's, the kernel's route)."""
    from repro_torch.kernels.fused_adamw import fused_adamw_torch
    from repro_torch.train import quantized_state as qs
    gen = _gen(seed)
    p = _randn(shape, gen, p_dtype, 0.02)
    g = _randn(shape, gen, g_dtype, 1e-3)
    m = _randn(shape, gen, torch.float32, 1e-3)
    v = _randn(shape, gen, torch.float32, 1e-3) ** 2
    if zero_block:      # a quant block whose new m and v are all 0
        for t in (g, m, v):
            t[..., :256] = 0
    if quant:
        m, v = qs.quantize(m), qs.quantize(v)
    sc = torch.tensor(ADAM_SCALARS, dtype=torch.float32, device="cuda")
    hyper = dict(ADAM_HYPER, apply_wd=len(shape) >= 2)
    want = fused_adamw_torch(p, g, m, v, lr=sc[0], scale=sc[1], bc1=sc[2],
                             bc2=sc[3], **hyper)
    got, route = adamw_run(p, g, m, v, sc, hyper, misalign)
    return (p, g, m, v, sc, hyper), got, want, route


def same_bits(a, b) -> bool:
    """Two updates (p, m, v), moments fp32 or {"q", "s"}, bit for bit."""
    flat = [(x, y) for x, y in zip(a, b) if not isinstance(x, dict)]
    flat += [(x[k], y[k]) for x, y in zip(a, b) if isinstance(x, dict)
             for k in x]
    return all(bool(torch.equal(cx, cy)) for x, y in flat
               for cx, cy in _chunks(x.reshape(-1).view(torch.uint8),
                                     y.reshape(-1).view(torch.uint8)))


def adamw_check(got, want):
    """Params within 1 bf16 (or f32) ulp; fp32 moments within 1 ulp; int8
    codes at most 1 apart on at most 1e-5 of the elements (an FMA that
    nvcc contracted would move a value across a rounding boundary; the
    kernel's _rn intrinsics should leave none) and scales within 1 ulp.
    Returns the measured distances and whether they pass."""
    res = {"p_ulp": ulp_dist(got[0], want[0]),
           "p_max_abs_err": max((max_err(g, w) for g, w in
                                 _chunks(got[0], want[0])), default=0.0)}
    if isinstance(want[1], dict):
        for name, g, w in (("m", got[1], want[1]), ("v", got[2], want[2])):
            most, differ = 0, 0
            for a, b in _chunks(g["q"], w["q"]):
                d = (a.int() - b.int()).abs()
                most = max(most, int(d.max()))
                differ += int((d > 0).sum())
            res[f"{name}_code_max_diff"] = most
            res[f"{name}_code_diff_share"] = differ / max(1, w["q"].numel())
            res[f"{name}_scale_ulp"] = ulp_dist(g["s"], w["s"])
        ok = all(res[f"{n}_code_max_diff"] <= 1
                 and res[f"{n}_code_diff_share"] <= 1e-5
                 and res[f"{n}_scale_ulp"] <= 1 for n in "mv")
    else:
        res["m_ulp"] = ulp_dist(got[1], want[1])
        res["v_ulp"] = ulp_dist(got[2], want[2])
        ok = res["m_ulp"] <= 1 and res["v_ulp"] <= 1
    res["passed"] = ok and res["p_ulp"] <= 1
    return res


def check_train_kernels(out, edge, edges):
    """The train path's kernels: the flash backward, the RMSNorm backward
    and both fused AdamW variants, at the train shapes (timed) and at
    edge cases."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_torch,
        flash_attention_cuda)
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda,
                                             rmsnorm_bwd_torch)

    def worst(got, want, rtol):
        errs = [close(g, w, rtol) for g, w in zip(got, want)]
        return max(e for e, _ in errs), max(r for _, r in errs)

    def fwd_ok(fwd, case, rtol):
        """The forward's o (rtol as the backward's) and lse (fp32, rtol
        1e-4) with the lse output on, against the plain version's."""
        o, o_plain, lse, plain = fwd
        err, ratio = close(o, o_plain, rtol)
        check(ratio <= 1.0 and bool(torch.isfinite(o).all()),
              f"flash forward o with lse, {case}: max_abs_err {err}, "
              f"{ratio} x tol")
        live = plain > -1e29
        check(bool(torch.equal(live, lse > -1e29)),
              f"flash forward lse, {case}: fully masked rows disagree")
        lse_err, lse_ratio = close(lse[live], plain[live], 1e-4)
        check(lse_ratio <= 1.0, f"flash forward lse, {case}: max_abs_err "
              f"{lse_err}, {lse_ratio} x tol")
        return {"o_max_err": err, "o_err_over_tol": ratio,
                "lse_max_err": lse_err, "lse_err_over_tol": lse_ratio}

    progress("kernels: flash backward")
    # ---- flash backward: (2, 32, 2048, 128) causal bf16, the train step's
    (q, k, v, o, lse, do, kw), got, want, fwd = flash_bwd_case(
        2, 32, 32, 2048, 2048, 128, 128)
    # the forward at the train shape, lse written: held and timed, and
    # reported in the flash_attention row
    fa = out["flash_attention"]
    B, H, S, D = q.shape
    pairs = H * B * sum(min(S, i + 1) for i in range(S))
    fwd_flops = pairs * 2 * (D + v.shape[-1])
    b_ms, b_by = bound(2 * 4 * q.numel() + 4 * lse.numel(), fwd_flops)
    fa["train_shape"] = {
        "shape": list(q.shape), "rtol": 2e-2, **fwd_ok(fwd, "train shape",
                                                       2e-2),
        "kernel_ms": time_ms(lambda: flash_attention_cuda(
            q, k, v, with_lse=True, **kw)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        "bound_ms": b_ms, "bound_by": b_by, "flops": fwd_flops}
    fa["train_shape"]["tflops"] = (fwd_flops / fa["train_shape"]["kernel_ms"]
                                   / 1e9)
    fa["max_err"] = max(fa["max_err"], fa["train_shape"]["o_max_err"],
                        out["flash_attention_hybrid"]["max_err"])
    err, ratio = worst(got, want, 2e-2)
    check(ratio <= 1.0 and all(bool(torch.isfinite(t).all()) for t in got),
          f"flash_attention_bwd full width: max_abs_err {err}, {ratio} x tol")
    # no atomics: a second call gives the same bits
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "flash_attention_bwd: two calls on the same inputs differ")
    del again
    nbytes = 2 * 8 * q.numel() + 4 * lse.numel()
    bwd_flops = pairs * 2 * (3 * D + 2 * D)
    b_ms, b_by = bound(nbytes, bwd_flops)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    out["flash_attention_bwd"] = {
        "shape": [B, H, S, D], "max_err": err, "rtol": 2e-2,
        "err_over_tol": ratio,
        "kernel_ms": time_ms(lambda: flash_attention_bwd_cuda(
            q, k, v, o, lse, do, **kw)),
        "plain_ms": time_ms(lambda: flash_attention_bwd_torch(
            q, k, v, o, lse, do, **kw), iters=5),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True)),
        "bound_ms": b_ms, "bound_by": b_by, "flops": bwd_flops,
        "bitwise_reproducible": True}
    fb = out["flash_attention_bwd"]
    fb["tflops"] = bwd_flops / fb["kernel_ms"] / 1e9
    qm = misaligned(q)
    cc = flash_attention_bwd_cuda(qm, k, v, o, lse, do, **kw)
    cc_err, cc_ratio = worst(cc, want, 2e-2)
    check(cc_ratio <= 1.0, f"flash_attention_bwd CUDA-core route: "
          f"max_abs_err {cc_err}, {cc_ratio} x tol")
    fb["was_route"] = {
        "route": "cuda_core", "max_err": cc_err, "err_over_tol": cc_ratio,
        "kernel_ms": time_ms(lambda: flash_attention_bwd_cuda(
            qm, k, v, o, lse, do, **kw), iters=5)}
    del q, k, v, o, lse, do, got, want, fwd, ql, kl, vl, ol, qm, cc
    # ---- the hybrid's train shape: zamba2_2p7b's shared block, (2, 32,
    # 2048, 80): the forward with lse held, the backward held and timed
    # beside its plain version and SDPA's
    (q, k, v, o, lse, do, kw), got, want, fwd = flash_bwd_case(
        2, 32, 32, 2048, 2048, 80, 80)
    fa["hybrid_train_shape"] = {"shape": list(q.shape), "rtol": 2e-2,
                                **fwd_ok(fwd, "hybrid train shape", 2e-2)}
    fa["max_err"] = max(fa["max_err"], fa["hybrid_train_shape"]["o_max_err"])
    err, ratio = worst(got, want, 2e-2)
    check(ratio <= 1.0 and all(bool(torch.isfinite(t).all()) for t in got),
          f"flash_attention_bwd hybrid train shape: max_abs_err {err}, "
          f"{ratio} x tol")
    B, H, S, D = q.shape
    pairs = H * B * sum(min(S, i + 1) for i in range(S))
    h_flops = pairs * 2 * 5 * D
    b_ms, b_by = bound(2 * 8 * q.numel() + 4 * lse.numel(), h_flops)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    fb["hybrid_train_shape"] = {
        "shape": [B, H, S, D], "max_err": err, "rtol": 2e-2,
        "err_over_tol": ratio,
        "kernel_ms": time_ms(lambda: flash_attention_bwd_cuda(
            q, k, v, o, lse, do, **kw)),
        "plain_ms": time_ms(lambda: flash_attention_bwd_torch(
            q, k, v, o, lse, do, **kw), iters=5),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True)),
        "bound_ms": b_ms, "bound_by": b_by, "flops": h_flops}
    fb["hybrid_train_shape"]["tflops"] = (
        h_flops / fb["hybrid_train_shape"]["kernel_ms"] / 1e9)
    del q, k, v, o, lse, do, got, want, fwd, ql, kl, vl, ol
    for name, args, kw2 in [
            ("gqa_g4", (2, 8, 2, 100, 100, 64, 64), {}),
            ("gqa_g12", (1, 48, 4, 100, 100, 128, 128), {}),
            ("mqa_dv_ne_d_noncausal", (1, 4, 1, 77, 130, 128, 64),
             dict(causal=False)),
            ("window_50", (1, 4, 4, 200, 200, 128, 128), dict(window=50)),
            ("q_offset_64", (1, 4, 4, 33, 97, 128, 128), dict(q_offset=64)),
            ("fully_masked_rows", (1, 2, 2, 70, 70, 128, 128),
             dict(q_offset=-10)),
            # the tensor-core route's padding: the hybrid's D = Dv = 80,
            # and D = 72, Dv = 40 (neither a multiple of 16); GQA groups
            # over several 128-row tiles
            ("d80", (1, 4, 4, 200, 200, 80, 80), {}),
            ("d72_dv40", (1, 4, 2, 100, 100, 72, 40), {}),
            ("gqa_g4_tiles128", (1, 16, 4, 300, 300, 128, 128), {}),
            ("gqa_g12_tiles128", (1, 48, 4, 300, 300, 128, 128), {}),
            ("f32_small_heads", (2, 4, 2, 65, 65, 16, 8),
             dict(dtype=torch.float32))]:
        _, got, want, fwd = flash_bwd_case(*args, **kw2)
        rel = 1e-4 if kw2.get("dtype") == torch.float32 else 2e-2
        edges.append({"kernel": "flash_attention", "case":
                      f"with_lse_{name}", "rtol": rel,
                      **fwd_ok(fwd, name, rel), "passed": True})
        for gname, g, w in zip(("dq", "dk", "dv"), got, want):
            edge("flash_attention_bwd", f"{name}_{gname}", g, w, rel)
        if name == "fully_masked_rows":
            check(bool((got[0][:, :, :10] == 0).all()),
                  "flash_attention_bwd: fully masked rows' dq is not 0")

    progress("kernels: rmsnorm backward")
    # ---- rmsnorm backward: (4096, 4096), the train step's rows; the
    # vector route, twice bit for bit, and the scalar route on copies of x
    # and g one element off alignment (``was_route``)
    (x, s, gy), got, want, route = rms_bwd_case(4096, 4096)
    err, ratio = worst(got, want, 2e-2)
    check(route == "vector" and ratio <= 1.0,
          f"rmsnorm_bwd (4096, 4096): {route} route, max_abs_err {err}, "
          f"{ratio} x tol")
    again = rmsnorm_bwd_cuda(x, s, gy)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "rmsnorm_bwd: two calls on the same inputs differ")
    xm, gm = misaligned(x), misaligned(gy)
    sgot, sroute = route_of("rmsnorm_bwd_scalar", lambda: rmsnorm_bwd_cuda(
        xm, s, gm), ("vector", "scalar"))
    s_err, s_ratio = worst(sgot, want, 2e-2)
    check(sroute == "scalar" and s_ratio <= 1.0,
          f"rmsnorm_bwd on misaligned x and g: {sroute} route, max_abs_err "
          f"{s_err}, {s_ratio} x tol")
    b_ms, b_by = bound(2 * (3 * x.numel() + 2 * s.numel()), 10 * x.numel(),
                       F32_FLOPS)
    kernel_ms = time_ms(lambda: rmsnorm_bwd_cuda(x, s, gy))
    check(kernel_ms <= GUARD_MS["rmsnorm_bwd"],
          f"rmsnorm_bwd (4096, 4096): {kernel_ms} ms, above its "
          f"{GUARD_MS['rmsnorm_bwd']} ms guard")
    xl, sl = (t.detach().requires_grad_(True) for t in (x, s))
    yl = F.rms_norm(xl, (4096,), sl, 1e-6)
    out["rmsnorm_bwd"] = {
        "shape": [4096, 4096], "route": route, "max_err": err, "rtol": 2e-2,
        "err_over_tol": ratio, "bitwise_reproducible": True,
        "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda: rmsnorm_bwd_torch(x, s, gy)),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            yl, (xl, sl), gy, retain_graph=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        # the vector route's row kernel and its dscale sum, apart
        "passes_ms": {t["kernel"]: t["ms_per_call"] for t in profile_steps(
            lambda: rmsnorm_bwd_cuda(x, s, gy), 20)["top"]
            if "rmsnorm" in t["kernel"]},
        "was_route": {"route": "scalar", "max_err": s_err,
                      "err_over_tol": s_ratio,
                      "kernel_ms": time_ms(lambda: rmsnorm_bwd_cuda(
                          xm, s, gm))}}
    del x, s, gy, got, want, again, xm, gm, sgot, xl, sl, yl
    # the hybrid's widest rows: the Mamba2 gated norm's (4096, 5120) in a
    # train step of 2 x 2048 tokens, held and timed
    (x, s, gy), got, want, route = rms_bwd_case(4096, 5120)
    err, ratio = worst(got, want, 2e-2)
    check(route == "vector" and ratio <= 1.0,
          f"rmsnorm_bwd (4096, 5120): {route} route, max_abs_err {err}, "
          f"{ratio} x tol")
    b_ms, b_by = bound(2 * (3 * x.numel() + 2 * s.numel()), 10 * x.numel(),
                       F32_FLOPS)
    xl, sl = (t.detach().requires_grad_(True) for t in (x, s))
    yl = F.rms_norm(xl, (5120,), sl, 1e-6)
    out["rmsnorm_bwd"]["hybrid_d5120"] = {
        "shape": [4096, 5120], "route": route, "max_err": err, "rtol": 2e-2,
        "err_over_tol": ratio,
        "kernel_ms": time_ms(lambda: rmsnorm_bwd_cuda(x, s, gy)),
        "plain_ms": time_ms(lambda: rmsnorm_bwd_torch(x, s, gy)),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            yl, (xl, sl), gy, retain_graph=True)),
        "bound_ms": b_ms, "bound_by": b_by}
    del x, s, gy, got, want, xl, sl, yl
    for name, args, kw2, expect in [
            ("d8_f32", (3, 8), dict(dtype=torch.float32), "vector"),
            ("d4100_scalar_path", (5, 4100), {}, "scalar"),
            ("misaligned", (6, 4096), dict(offset=3), "scalar"),
            ("rows_1000_ragged_chunks", (1000, 4096), {}, "vector"),
            ("one_row", (1, 64), {}, "vector"),
            # 512 threads of 4 f32 vectors; a width that leaves threads idle
            ("d8192_f32", (77, 8192), dict(dtype=torch.float32), "vector"),
            ("d2560", (300, 2560), {}, "vector")]:
        _, got, want, route = rms_bwd_case(*args, **kw2)
        check(route == expect, f"rmsnorm_bwd {name}: {route} route, want "
              f"{expect}")
        rel = 1e-4 if kw2.get("dtype") == torch.float32 else 2e-2
        for gname, g, w in zip(("dx", "dscale"), got, want):
            edge("rmsnorm_bwd", f"{name}_{gname}", g, w, rel)
            edges[-1]["route"] = route

    check_adamw_kernel(out, edges)


# the distances adamw_check measures: the vector route may be no farther
# from the plain version than the scalar route on the same inputs
ADAM_DISTANCES = ("p_ulp", "p_max_abs_err", "m_ulp", "v_ulp",
                  "m_code_max_diff", "m_code_diff_share", "m_scale_ulp",
                  "v_code_max_diff", "v_code_diff_share", "v_scale_ulp")


def check_adamw_kernel(out, edges):
    """Both fused AdamW instances (int8 and fp32 moments) at deepseek_7b's
    largest, widest and smallest leaves (timed) and at edge cases.  Each
    vector-route case also runs the scalar route on a copy of p one
    element off alignment: that route is held by the same check, it is
    no nearer the plain version than the vector route, both give the same
    bits, and at full width its time is the row's ``was_route``."""
    from repro_torch.kernels.fused_adamw import (fused_adamw_cuda,
                                                 fused_adamw_torch)

    def both_routes(case, inputs, got, want, route, expect):
        chk = adamw_check(got, want)
        check(chk["passed"] and route == expect,
              f"fused_adamw {case}: {route} route (want {expect}), {chk}")
        if route != "vector":
            return chk, None, None
        sgot, sroute = adamw_run(*inputs, misalign=True)
        schk = adamw_check(sgot, want)
        check(schk["passed"] and sroute == "scalar",
              f"fused_adamw {case}: {sroute} route on a misaligned p, {schk}")
        farther = [k for k in ADAM_DISTANCES if k in chk and chk[k] > schk[k]]
        check(not farther, f"fused_adamw {case}: the vector route is farther "
              f"from the plain version than the scalar one in {farther}: "
              f"{chk} against {schk}")
        chk["bitwise_equal_to_scalar_route"] = same_bits(got, sgot)
        check(chk["bitwise_equal_to_scalar_route"],
              f"fused_adamw {case}: the two routes' bits differ")
        return chk, sgot, schk

    leaves = {"layers/mlp/w_up": (30, 4096, 11008), "embed": (102400, 4096),
              "final_norm/scale": (4096,)}
    res = {}
    for variant, quant in (("i8", True), ("f32", False)):
        per_leaf = {}
        for leaf, shape in leaves.items():
            progress(f"kernels: fused_adamw {variant} {leaf}")
            inputs, got, want, route = adamw_case(shape, quant)
            p, g, m, v, sc, hyper = inputs
            chk, sgot, schk = both_routes(f"{variant} {leaf}", inputs, got,
                                          want, route, "vector")
            n = p.numel()
            nb = n // shape[-1] * -(-shape[-1] // 256)
            nbytes = 10 * n + 16 * nb if quant else 22 * n
            b_ms, b_by = bound(nbytes, 20 * n, F32_FLOPS)
            lr, scale, bc1, bc2 = sc
            del want
            row = {"shape": list(shape), "route": route, **chk,
                   "kernel_ms": time_ms(lambda: fused_adamw_cuda(
                       got[0], g, got[1], got[2], sc, **hyper)),
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                   "was_route": {"route": "scalar", **schk,
                                 "kernel_ms": time_ms(lambda: (
                                     fused_adamw_cuda(sgot[0], g, sgot[1],
                                                      sgot[2], sc,
                                                      **hyper)))}}
            del got, sgot
            row["plain_ms"] = time_ms(lambda: fused_adamw_torch(
                p, g, m, v, lr=lr, scale=scale, bc1=bc1, bc2=bc2, **hyper),
                iters=3)
            del m, v
            if not quant:
                # yardstick, not the same function: one fused
                # torch.optim.AdamW step on the same bf16 param and grad
                # keeps bf16 moments (as the param), not fp32 ones, so it
                # moves 14 bytes an element where the kernel moves 22;
                # library_bound_ms is its own byte bound
                lp = torch.nn.Parameter(p.clone())
                lp.grad = g.clone()
                optim = torch.optim.AdamW([lp], lr=ADAM_SCALARS[0],
                                          betas=(ADAM_HYPER["b1"],
                                                 ADAM_HYPER["b2"]),
                                          eps=ADAM_HYPER["eps"],
                                          weight_decay=ADAM_HYPER[
                                              "weight_decay"], fused=True)
                row["library_ms"] = time_ms(optim.step, iters=5)
                row["library_bound_ms"] = bound(14 * n, 20 * n, F32_FLOPS)[0]
                del lp, optim
            per_leaf[leaf] = row
            del p, g
            torch.cuda.empty_cache()
        res[variant] = per_leaf
        for name, shape, kw2, expect in [
                ("ragged_L300", (7, 300), {}, "scalar"),
                ("scalar_leaf", (), {}, "scalar"),
                ("zero_block", (4, 512), dict(zero_block=True), "vector"),
                ("g_f32", (3, 1000), dict(g_dtype=torch.float32), "scalar"),
                ("g_f32_vector", (3, 4096), dict(g_dtype=torch.float32),
                 "vector"),
                ("p_f32_g_f32", (5, 256), dict(p_dtype=torch.float32,
                                               g_dtype=torch.float32),
                 "vector"),
                # 4112 = 16 x 257: the last quant block of a row holds 16
                # elements, masked 16 at a time
                ("L4112_ragged_block_vector", (3, 4112), {}, "vector"),
                ("misaligned_scalar_route", (5, 4096), dict(misalign=True),
                 "scalar")]:
            inputs, got, want, route = adamw_case(shape, quant, **kw2)
            chk = both_routes(f"{variant} {name}", inputs, got, want, route,
                              expect)[0]
            edges.append({"kernel": "fused_adamw",
                          "case": f"{variant}_{name}", "route": route,
                          **chk})
            if name == "zero_block" and quant:
                check(bool((got[1]["s"][..., 0] == 1.0).all()
                           and (got[1]["q"][..., :256] == 0).all()),
                      "fused_adamw i8: an all-zero block's scale is not 1")
    w_up = res["i8"]["layers/mlp/w_up"]
    f32 = res["f32"]["layers/mlp/w_up"]
    out["fused_adamw"] = {
        "shape": list(leaves["layers/mlp/w_up"]),
        "max_err": w_up["p_max_abs_err"],
        **{k: w_up[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                                "bound_by", "was_route")},
        "library_ms": None,
        "f32": {"ms": f32["kernel_ms"],
                "was_ms": f32["was_route"]["kernel_ms"],
                "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
                "library_ms": f32["library_ms"],
                "library_bound_ms": f32["library_bound_ms"]},
        "variants": res}


def check_paged_kernel(out, edge, edges):
    """Paged decode attention at deepseek_7b's paged round (8 slots, 32
    heads, D 128, page 16, lengths 17-1000; timed) and at edge cases.  The
    split route is held against the plain version and its partition-and-
    merge arithmetic (``paged_attention_split_torch``), and twice on the
    same inputs, bit for bit (its merge is ordered); the scalar route on a
    copy of q one element off alignment is held and timed
    (``was_route``)."""
    from repro_torch.kernels.paged_attention import (
        PARTITION, paged_attention_cuda, paged_attention_split_torch,
        paged_attention_torch)
    progress("kernels: paged_attention")
    lens = [17, 157, 298, 438, 579, 719, 860, 1000]
    (q, kp, vp, pt, sl), got, want, route = paged_case(lens, 32, 32, 128,
                                                       128)
    err, ratio = close(got, want, 2e-2)
    check(route == "split" and ratio <= 1.0,
          f"paged_attention full width: {route} route, max_abs_err {err}, "
          f"{ratio} x tol")
    again = paged_attention_cuda(q, kp, vp, pt, sl)
    check(bool(torch.equal(got.view(torch.int16), again.view(torch.int16))),
          "paged_attention: two calls on the same inputs differ")
    s_err, s_ratio = close(got, paged_attention_split_torch(
        q, kp, vp, pt, sl, part=PARTITION), 2e-2)
    check(s_ratio <= 1.0, f"paged_attention full width against the split "
          f"plain version: max_abs_err {s_err}, {s_ratio} x tol")
    Hkv, D = kp.shape[2], kp.shape[3]
    live = sum(lens)
    nbytes = (2 * (q.numel() + got.numel()) + 2 * live * Hkv * (D + D)
              + 4 * (len(lens) + sum(-(-n // 16) for n in lens)))
    b_ms, b_by = bound(nbytes, live * q.shape[1] * 2 * (D + D))
    qm = misaligned(q)
    cc, cc_route = route_of("paged_attention_scalar", lambda: (
        paged_attention_cuda(qm, kp, vp, pt, sl)), ("split", "scalar"))
    cc_err, cc_ratio = close(cc, want, 2e-2)
    check(cc_route == "scalar" and cc_ratio <= 1.0,
          f"paged_attention on a misaligned q: {cc_route} route, "
          f"max_abs_err {cc_err}, {cc_ratio} x tol")
    out["paged_attention"] = {
        "shape": {"lens": lens, "Hq": 32, "Hkv": 32, "D": 128, "page": 16,
                  "partition": PARTITION},
        "route": route, "max_err": err, "rtol": 2e-2, "err_over_tol": ratio,
        "bitwise_reproducible": True,
        "vs_split_plain": {"max_err": s_err, "err_over_tol": s_ratio},
        "kernel_ms": time_ms(lambda: paged_attention_cuda(q, kp, vp, pt, sl)),
        "plain_ms": time_ms(lambda: paged_attention_torch(q, kp, vp, pt, sl)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        # the split route's two kernels, apart
        "kernels_ms": {t["kernel"]: t["ms_per_call"] for t in profile_steps(
            lambda: paged_attention_cuda(q, kp, vp, pt, sl), 20)["top"]
            if "paged_decode" in t["kernel"]},
        "was_route": {"route": "scalar", "max_err": cc_err,
                      "err_over_tol": cc_ratio,
                      "kernel_ms": time_ms(lambda: paged_attention_cuda(
                          qm, kp, vp, pt, sl))}}
    del q, kp, vp, pt, sl, got, want, again, qm, cc
    for name, args, kw2, expect in [
            ("empty_and_len1_slots", ([0, 1, 16, 17], 8, 8, 128, 128), {},
             "split"),
            ("poisoned_trash_page", ([5, 33, 64], 4, 4, 128, 128),
             dict(poison_trash=True, maxp=8), "split"),
            ("gqa_g4_dv_ne_d", ([40, 300], 8, 2, 128, 64), {}, "split"),
            # starcoder2_15b's group (48 / 4 = 12 runs as 2 chunks of 6)
            # and yi_34b's (56 / 8 = 7)
            ("gqa_g12_two_chunks", ([40, 300, 1], 48, 4, 128, 128), {},
             "split"),
            ("gqa_g7", ([33, 200], 56, 8, 128, 128), {}, "split"),
            ("f32_g8", ([9, 100, 31], 8, 1, 64, 64),
             dict(dtype=torch.float32, page=8, maxp=16), "split"),
            # lengths on, just past and just short of the 128-position
            # partitions, and one position
            ("partition_boundaries", ([127, 128, 129, 256, 1], 8, 8, 128,
                                      128), {}, "split"),
            # a head dim that is no whole number of 16-byte words
            ("d100_scalar_route", ([40, 300], 8, 8, 100, 100), {},
             "scalar"),
            # page 8 (16 pages a partition), lengths ending mid-partition
            ("f32_page8", ([9, 100, 131, 250], 8, 2, 128, 128),
             dict(dtype=torch.float32, page=8, maxp=32), "split")]:
        _, got, want, route = paged_case(*args, **kw2)
        check(route == expect, f"paged_attention {name}: {route} route, "
              f"want {expect}")
        rel = 1e-4 if kw2.get("dtype") == torch.float32 else 2e-2
        edge("paged_attention", name, got, want, rel)
        edges[-1]["route"] = route
        if name == "empty_and_len1_slots":
            check(bool((got[0] == 0).all()), "paged: empty slot is not 0")


def phase_kernels():
    """Every kernel vs its plain version at full width (timed) and at edge
    cases.  Launches made here are checks, not the main path's."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_torch)
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_torch
    out = {}
    edges = []

    def edge(name, case, got, want, rtol):
        err, ratio = close(got, want, rtol)
        ok = bool(torch.isfinite(got).all()) and ratio <= 1.0
        edges.append({"kernel": name, "case": case, "max_err": err,
                      "rtol": rtol, "err_over_tol": ratio, "passed": ok})
        check(ok, f"{name} {case}: max_abs_err {err}, {ratio} x its "
              f"tolerance (rtol {rtol})")

    def flash_row(*shape):
        """A causal bf16 prefill shape, held and timed."""
        (q, k, v, kw), got, want = flash_case(*shape)
        err, ratio = close(got, want, 2e-2)
        check(ratio <= 1.0 and bool(torch.isfinite(got).all()),
              f"flash_attention {list(q.shape)}: max_abs_err {err}, "
              f"{ratio} x tol")
        B, H, S, D = q.shape
        pairs = H * B * sum(min(S, i + 1) for i in range(S))
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
        flops = pairs * 2 * (D + v.shape[-1])
        b_ms, b_by = bound(nbytes, flops)
        row = {
            "shape": [B, H, S, D], "max_err": err, "rtol": 2e-2,
            "err_over_tol": ratio,
            "kernel_ms": time_ms(lambda: flash_attention_cuda(q, k, v, **kw)),
            "plain_ms": time_ms(lambda: flash_attention_torch(q, k, v, **kw)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)),
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops}
        row["tflops"] = flops / row["kernel_ms"] / 1e9
        # the CUDA-core route (the bf16 design before the tensor cores,
        # kept for f32) on the same inputs, held and timed
        qm = misaligned(q)
        cc = flash_attention_cuda(qm, k, v, **kw)
        cc_err, cc_ratio = close(cc, want, 2e-2)
        check(cc_ratio <= 1.0, f"flash_attention CUDA-core route "
              f"{list(q.shape)}: max_abs_err {cc_err}, {cc_ratio} x tol")
        row["was_route"] = {
            "route": "cuda_core", "max_err": cc_err, "err_over_tol": cc_ratio,
            "kernel_ms": time_ms(lambda: flash_attention_cuda(qm, k, v,
                                                              **kw))}
        return row

    # ---- flash attention: deepseek_7b's prefill, q/k/v (4, 32, 512, 128),
    # and zamba2_2p7b's shared attention block, (4, 32, 1000, 80); causal
    out["flash_attention"] = flash_row(4, 32, 32, 512, 512, 128, 128)
    out["flash_attention_hybrid"] = flash_row(4, 32, 32, 1000, 1000, 80, 80)
    for name, args, kw2 in [
            ("gqa_g4", (2, 8, 2, 100, 100, 64, 64), {}),
            ("gqa_g12", (1, 48, 4, 100, 100, 128, 128), {}),
            # the paged plane's admission prefills: batch 1, a page-multiple
            # prompt bucket with a partial last kv tile (80) and the longest
            ("admission_bucket_80", (1, 32, 32, 80, 80, 128, 128), {}),
            ("admission_bucket_704", (1, 32, 32, 704, 704, 128, 128), {}),
            ("mqa_dv_ne_d_noncausal", (1, 4, 1, 77, 130, 128, 64),
             dict(causal=False)),
            ("window_50", (1, 4, 4, 200, 200, 128, 128), dict(window=50)),
            ("q_offset_64", (1, 4, 4, 33, 97, 128, 128), dict(q_offset=64)),
            ("fully_masked_rows", (1, 2, 2, 70, 70, 128, 128),
             dict(q_offset=-10)),
            # the tensor-core route's padding (neither a multiple of 16)
            # and GQA groups over several 128-row tiles
            ("d72_dv40", (1, 4, 2, 100, 100, 72, 40), {}),
            ("gqa_g4_tiles128", (1, 16, 4, 300, 300, 128, 128), {}),
            ("gqa_g12_tiles128", (1, 48, 4, 300, 300, 128, 128), {}),
            ("f32_small_heads", (2, 4, 2, 65, 65, 16, 8),
             dict(dtype=torch.float32))]:
        _, got, want = flash_case(*args, **kw2)
        rel = 1e-4 if kw2.get("dtype") == torch.float32 else 2e-2
        edge("flash_attention", name, got, want, rel)
        if name == "fully_masked_rows":
            check(bool((got[:, :, :10] == 0).all()),
                  "flash_attention: fully masked rows are not 0")

    # ---- rmsnorm at the main paths' rows: deepseek_7b's prefill (2048,
    # 4096), decode (4, 4096) and train step (4096, 4096); zamba2_2p7b's
    # prefill (4000 rows) and decode (4 rows) at d_model 2560 and at the
    # Mamba2 gated norm's 5120
    for rows, d, key in ((2048, 4096, "rmsnorm"), (4, 4096, "rmsnorm_decode"),
                         (4096, 4096, "rmsnorm_train"),
                         (4000, 2560, "rmsnorm_hybrid_d2560"),
                         (4000, 5120, "rmsnorm_hybrid_d5120"),
                         (4, 2560, "rmsnorm_hybrid_decode_d2560"),
                         (4, 5120, "rmsnorm_hybrid_decode_d5120")):
        (x, s), got, want = rms_case(rows, d)
        err, ratio = close(got, want, 2e-2)
        check(ratio <= 1.0, f"rmsnorm ({rows}, {d}): max_abs_err {err}, "
              f"{ratio} x tol")
        b_ms, b_by = bound(2 * (2 * x.numel() + s.numel()), 4 * x.numel(),
                           F32_FLOPS)
        out[key] = {
            "shape": [rows, d], "max_err": err, "rtol": 2e-2,
            "err_over_tol": ratio,
            "kernel_ms": time_ms(lambda: rmsnorm_cuda(x, s)),
            "plain_ms": time_ms(lambda: rmsnorm_torch(x, s)),
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), s, 1e-6)),
            "bound_ms": b_ms, "bound_by": b_by}
    # the kernels line's error is the worst over the main paths' shapes
    out["rmsnorm"]["max_err"] = max(out[k]["max_err"] for k in out
                                    if k.startswith("rmsnorm"))
    for name, args, kw2 in [("d8_f32", (3, 8), dict(dtype=torch.float32)),
                            ("d4100_scalar_path", (5, 4100), {}),
                            ("d8192", (7, 8192), {}),
                            ("misaligned", (6, 4096), dict(offset=3))]:
        _, got, want = rms_case(*args, **kw2)
        rel = 1e-5 if kw2.get("dtype") == torch.float32 else 2e-2
        edge("rmsnorm", name, got, want, rel)

    check_paged_kernel(out, edge, edges)
    check_ssd_kernel(out, edge, edges)
    check_ssd_bwd_kernel(out, edge, edges)
    check_train_kernels(out, edge, edges)
    emit("kernels", launches=counts(), full_width=out, edge_cases=edges)
    return out


def dense_launches(cfg):
    """The kernels' launches in one dense prefill (or paged admission),
    one decode step and one paged round: a layer runs one flash attention
    (prefill only) or one paged attention (a paged round) and two
    RMSNorms, the final norm one."""
    zero = {n: 0 for n in COUNTERS}
    L, norms = cfg.n_layers, 2 * cfg.n_layers + 1
    return ({**zero, "flash_attention": L, "rmsnorm": norms},
            {**zero, "rmsnorm": norms},
            {**zero, "paged_attention": L, "rmsnorm": norms})


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _eager_calls():
    from repro_torch.train import compile_cache
    return compile_cache.EAGER_CALLS


def _zero_eager_calls():
    from repro_torch.train import compile_cache
    compile_cache.EAGER_CALLS = 0


def graph_check(name, graph, steps, eager_calls, device):
    """The main path's decode ran as graph replays: one capture, a replay
    a step, and no eager decode step (on the CPU: every step eager)."""
    st = graph.stats()
    if torch.device(device).type == "cuda":
        check(st["captures"] == 1 and st["replays"] == steps
              and st["eager_calls"] == 0 and eager_calls == 0,
              f"{name}: {steps} decode steps on the main path, graph "
              f"{st}, {eager_calls} eager decode steps")
    else:
        check(st["captures"] == st["replays"] == 0
              and st["eager_calls"] == steps,
              f"{name}: {steps} decode steps on the CPU, graph {st}")
    return {**st, "card": _CARD}


def captured_vs_eager(rt, batch, n):
    """A dense-plane block's captured decode against its step function run
    eagerly, from one state (a prefill of ``batch`` into the block's
    zeroed cache, and a copy of it): ``n`` steps each, every token and
    the final cache's bit checksums equal.  Each loop ends every step in
    the launcher's ``token.cpu()``: their seconds and tok/s are decode
    before and after capture.  Returns the record, the eager copy of the
    cache and its position scalar (for a profile of the eager step); the
    check's launches are not the main path's."""
    saved = counts()
    graph = rt.decode_graph
    for t in _tensors(rt.cache):       # in place: the graph keeps its cache
        t.zero_()
    rt.prefill(batch)
    params, B, P = rt.state["params"], rt.token.shape[0], rt.cache_len
    cache, first = _clone(rt.cache), rt.token.clone()
    pos = torch.zeros((), dtype=torch.int32, device=rt.device)
    rt._sync()
    t0 = time.perf_counter()
    tok, eager = first, []
    for i in range(n):
        pos.fill_(P + i)
        tok, _ = graph.fn(params, tok, cache, pos, None)
        eager.append(tok.cpu())
    eager_s = time.perf_counter() - t0
    replays = graph.replays
    t0 = time.perf_counter()
    captured = []
    for _ in range(n):
        rt.step()
        captured.append(rt.token.cpu())
    captured_s = time.perf_counter() - t0
    set_counts(saved)
    out = {"steps": n,
           "tokens_equal": all(torch.equal(a, b)
                               for a, b in zip(eager, captured)),
           "cache_bitwise_equal": bit_checksums(cache)
           == bit_checksums(rt.cache),
           "replays": graph.replays - replays,
           "eager_s": eager_s, "captured_s": captured_s,
           "eager_tok_s": B * n / eager_s,
           "captured_tok_s": B * n / captured_s, "card": _CARD}
    check(out["tokens_equal"] and out["cache_bitwise_equal"],
          f"captured decode against eager from one state: {out}")
    if rt.device.type == "cuda":
        check(out["replays"] == n, f"captured decode: {out}")
    return out, cache, first, pos


def sampled_vs_eager(device):
    """A sampling job's decode on the dense and the paged plane, at
    deepseek_7b's smoke size: captured with its generator registered,
    against the same block (the same seed) run eagerly, token for token
    over 8 steps (4 sessions of 8 tokens on the paged plane, whose
    admissions draw eagerly in between).  The check's launches are not
    the main path's."""
    import repro_torch.configs as configs
    from repro_torch.core.runtime import JobSpec
    from repro_torch.data import pipeline
    from repro_torch.models.config import ShapeConfig
    saved = counts()
    cfg = configs.get_smoke("deepseek_7b")
    prompt = pipeline.synthetic_batch(
        cfg, ShapeConfig("p", "prefill", 16, 2), step=0, seed=0)["tokens"]
    out = {}
    for plane in ("dense", "paged"):
        runs = []
        for capture in (False, True):
            if plane == "dense":
                job = JobSpec(cfg, ShapeConfig("s", "serve", 32, 2),
                              kind="serve", seed=0, decode_sample=True)
            else:
                job = dataclasses.replace(_paged_job(True),
                                          decode_sample=True)
            rt = _block(job, device)
            rt.init_state()
            rt.decode_graph.capture = capture
            if plane == "dense":
                rt.prefill({"tokens": prompt})
                toks = []
                for _ in range(8):
                    rt.step()
                    toks.append(rt.token.cpu())
                toks = torch.cat(toks, 1).tolist()
            else:
                for p in _paged_prompts(cfg, True)[:4]:
                    rt.start_session(p, max_new_tokens=8)
                toks = [(e["session"], e["token"]) for e in _feed(rt)[0]
                        if e["event"] == "token"]
            runs.append((toks, rt.decode_graph.stats()))
            del rt
        (want, _), (got, st) = runs
        out[plane] = {"tokens_equal": got == want, "graph": st}
        on_card = torch.device(device).type == "cuda"
        check(got == want and (not on_card or (
            st["captures"] == 1 and st["replays"] > 0
            and st["eager_calls"] == 0)),
            f"sampled {plane} decode, captured against eager: {out}")
    set_counts(saved)
    return out


def phase_serve_dense(device="cuda", smoke=False):
    """The dense data plane through the launcher's entry point: the
    decode steps as graph replays, each kernel's launches exact, then the
    captured decode against the eager one from one state."""
    from repro_torch.launch import serve
    from repro_torch.models import model
    argv = ["--arch", "deepseek_7b", "--batch", "4", "--prompt-len", "512",
            "--gen", "32", "--seed", "0", "--device", device]
    if smoke:
        argv = argv[:2] + ["--smoke", "--batch", "2", "--prompt-len", "24",
                           "--gen", "6", "--device", device]
    args = serve.parse_args(argv)
    zero_counts()
    _zero_eager_calls()
    res = serve.run(args)
    launches = counts()
    rt, cfg = res["runtime"], res["cfg"]
    B, P, G = args.batch, args.prompt_len, args.gen
    graph = graph_check("serve_dense", rt.decode_graph, G - 1,
                        _eager_calls(), device)
    pre, dec, _ = dense_launches(cfg)
    if rt.device.type != "cuda":
        pre = dec = {n: 0 for n in COUNTERS}
    check(launches == {n: pre[n] + (G - 1) * dec[n] for n in COUNTERS},
          f"dense main path launches {launches}: not one prefill {pre} and "
          f"{G - 1} decode steps {dec}")
    toks = res["tokens"]
    check(toks.shape == (B, G) and toks.min() >= 0
          and toks.max() < cfg.vocab_size, f"dense tokens {toks.shape}")

    # the same prefill with the kernels and with their plain versions
    params, tokens = rt.state["params"], torch.as_tensor(
        res["batch"]["tokens"], device=rt.device)
    got, _ = model.prefill(params, cfg, {"tokens": tokens},
                           model.init_cache(cfg, B, P, rt.device))
    want, _ = model.prefill(params, cfg, {"tokens": tokens},
                            model.init_cache(cfg, B, P, rt.device),
                            impl="torch")
    chk = logits_check(got, want)
    check(chk["passed"], f"dense prefill logits: {chk}")
    check(bool((torch.argmax(got, -1).cpu().numpy() == toks[:, 0]).all()),
          "the runtime's first token is not the prefill logits' argmax")
    del got, want
    vs_eager, eager_cache, first, pos = captured_vs_eager(
        rt, {"tokens": tokens}, G - 1)
    out = {"arch": cfg.name, "batch": B, "prompt_len": P, "gen": G,
           "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
           "prefill_tok_s": B * P / res["prefill_s"],
           "decode_tok_s": B * (G - 1) / res["decode_s"],
           "launches": launches, "decode_graph": graph,
           "captured_vs_eager": vs_eager,
           "sampled_vs_eager": sampled_vs_eager(device),
           "logits_check": chk}
    if rt.device.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        # warm: the timed run above includes first-call costs (cuBLAS
        # handles and heuristics, lazy module loading)
        cache = model.init_cache(cfg, B, P, rt.device)
        out["warm_prefill"] = profile_steps(
            lambda: model.prefill(params, cfg, {"tokens": tokens}, cache), 2)
        del cache
        rt.prefill({"tokens": tokens})         # cache_len back to P
        out["warm_decode_step"] = profile_steps(rt.step, 3)
        # the same step eagerly, on the check's copy of the cache
        pos.fill_(P)
        out["warm_decode_step_eager"] = profile_steps(
            lambda: rt.decode_graph.fn(params, first, eager_cache, pos,
                                       None), 3)
    emit("serve_dense", **out)
    return out


def phase_serve_paged(device="cuda", smoke=False):
    """The paged data plane: 12 generate sessions through 8 slots."""
    from repro_torch.models import model
    job = _paged_job(smoke)
    cfg = job.cfg
    max_new = PAGED_NEW_TOKENS_SMOKE if smoke else PAGED_NEW_TOKENS
    rt = _block(job, device)
    rt.init_state()
    sch = rt.sessions
    prompts = _paged_prompts(cfg, smoke)
    n_sess, lens = len(prompts), [len(p) for p in prompts]

    # hold the first admission prefill, the first one of another prompt
    # bucket that ends in a partial 64-row kv tile, and the first decode
    # round against impl="torch" on the same inputs (the decode round on
    # copies of the pool); those launches are restored out of the main
    # path's counts
    admit, decode = sch._admit_prefill, sch._decode_step
    tap = {"rounds": 0, "admit_checks": [], "check": None}

    def tapped_admit(tokens, pages, last_idx):
        S = tokens.shape[1]
        done = tap["admit_checks"]
        if not done or (len(done) == 1 and S != done[0]["bucket"]
                        and S % 64):
            saved = counts()
            res = []
            for impl in ("auto", "torch"):
                x = model.embed_inputs(sch.params, cfg, {"tokens": tokens})
                lg, _, _ = model.forward(
                    sch.params, cfg, x,
                    positions=torch.arange(S, device=x.device),
                    cache=model.init_cache(cfg, 1, S, x.device),
                    cache_len=0, impl=impl)
                res.append(lg[0, last_idx][None])
            set_counts(saved)
            tap["admit_checks"].append(
                {"bucket": S, **logits_check(res[0], res[1])})
        return admit(tokens, pages, last_idx)

    def tapped_decode(tokens, page_table, seq_lens):
        if tap["rounds"] == 0:
            saved = counts()
            res = []
            for impl in ("auto", "torch"):
                copy = {k: v.clone() for k, v in sch.pool.items()}
                lg, _ = model.decode_step_paged(sch.params, cfg, tokens, copy,
                                                page_table, seq_lens,
                                                impl=impl)
                res.append(lg)
                del copy
            set_counts(saved)
            live = seq_lens > 0
            tap["check"] = {"slots": int(live.sum()),
                            **logits_check(res[0][live], res[1][live])}
        tap["rounds"] += 1
        return decode(tokens, page_table, seq_lens)

    sch._admit_prefill, sch._decode_step = tapped_admit, tapped_decode
    zero_counts()
    _zero_eager_calls()
    emissions, elapsed, ttft = _paged_traffic(rt, prompts, max_new)
    launches = counts()
    rounds = tap["rounds"]
    graph = graph_check("serve_paged", sch.decode_graph, rounds,
                        _eager_calls(), device)
    pre, _, per_round = dense_launches(cfg)
    if rt.device.type != "cuda":
        pre = per_round = {n: 0 for n in COUNTERS}
    check(launches == {n: sch.admissions * pre[n] + rounds * per_round[n]
                       for n in COUNTERS},
          f"paged main path launches {launches}: not {sch.admissions} "
          f"admissions {pre} and {rounds} rounds {per_round}")
    want_tokens = {s.sid: list(s.generated) for s in sch.sessions.values()}
    want_pool = bit_checksums(sch.pool)
    finished = [e for e in emissions if e["event"] == "finished"]
    n_tokens = sum(1 for e in emissions if e["event"] == "token")
    check(len(finished) == n_sess and sch.finished == n_sess,
          f"{len(finished)} of {n_sess} sessions finished")
    check(n_tokens == n_sess * max_new, f"{n_tokens} tokens generated")
    for sess in sch.sessions.values():
        check(len(sess.generated) == max_new and all(
            0 <= t < cfg.vocab_size for t in sess.generated),
              f"session {sess.sid} tokens")
    chk, admits = tap["check"], tap["admit_checks"]
    check(chk is not None and chk["passed"],
          f"first paged decode round logits: {chk}")
    check(len(admits) == 2 and all(c["passed"] for c in admits),
          f"admission prefill logits: {admits}")
    out = {"arch": cfg.name, "sessions": n_sess, "slots": 8,
           "prompt_lens": lens, "max_new_tokens": max_new,
           "n_pages": sch.n_pages, "decode_rounds": rounds,
           "admissions": sch.admissions, "evictions": sch.evictions,
           "elapsed_s": elapsed, "tokens": n_tokens,
           "tok_s": n_tokens / elapsed,
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_p99_s": float(np.percentile(ttft, 99)),
           "launches": launches, "decode_graph": graph,
           "logits_check": chk, "admission_logits_checks": admits}
    if rt.device.type == "cuda":
        out["pool_gb"] = sum(v.numel() * v.element_size()
                             for v in sch.pool.values()) / 1e9
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["warm_decode_round"] = _warm_round(rt, prompts, max_new)

    # the same traffic from the same state (a fresh scheduler: an empty
    # pool) with the decode round run eagerly: every session's tokens and
    # the pool's bits equal; its seconds and tok/s are before capture
    saved = counts()
    del sch._admit_prefill, sch._decode_step     # the taps' cycle
    sch.decode_graph.release()
    rt.sessions = sch = None
    _free(device)
    rt.sessions = sch = rt._make_scheduler(rt.state["params"])
    sch.decode_graph.capture = False
    ems, eager_s, eager_ttft = _paged_traffic(rt, prompts, max_new)
    got_tokens = {s.sid: list(s.generated) for s in sch.sessions.values()}
    out["captured_vs_eager"] = {
        "rounds": sch.decode_graph.eager_calls,
        "tokens_equal": got_tokens == want_tokens,
        "pool_bitwise_equal": bit_checksums(sch.pool) == want_pool,
        "eager_s": eager_s, "captured_s": elapsed,
        "eager_tok_s": n_tokens / eager_s, "captured_tok_s": out["tok_s"],
        "eager_ttft_p50_s": float(np.percentile(eager_ttft, 50)),
        "card": _CARD}
    check(out["captured_vs_eager"]["tokens_equal"]
          and out["captured_vs_eager"]["pool_bitwise_equal"]
          and out["captured_vs_eager"]["rounds"] == rounds,
          f"paged rounds captured against eager from one state: "
          f"{out['captured_vs_eager']}")
    if rt.device.type == "cuda":
        out["warm_decode_round_eager"] = _warm_round(rt, prompts, max_new)
    set_counts(saved)
    emit("serve_paged", **out)
    # each session's tokens, for the control phase (not printed)
    out["session_tokens"] = want_tokens
    return out


def _paged_traffic(rt, prompts, max_new):
    """The prompts submitted at once and fed to the end: (emissions,
    seconds, each session's time to its first token)."""
    t0 = time.perf_counter()
    submit_t, first_t = {}, {}
    for p in prompts:
        sid = rt.start_session(p, max_new_tokens=max_new)
        submit_t[sid] = time.perf_counter()
    emissions = []
    while not rt.idle_serve:
        ems = rt.feed()
        now = time.perf_counter()          # feed() ends in a host sync
        for e in ems:
            if e["event"] == "token" and e["session"] not in first_t:
                first_t[e["session"]] = now
        emissions.extend(ems)
    elapsed = time.perf_counter() - t0
    return emissions, elapsed, np.asarray(
        [first_t[s] - submit_t[s] for s in submit_t])


def _warm_round(rt, prompts, max_new):
    """A warm decode round with all 8 slots busy (after their
    admission)."""
    for p in prompts[:8]:
        rt.start_session(p, max_new_tokens=max_new)
    rt.feed()
    return profile_steps(rt.feed, 3)


def hybrid_launches(cfg):
    """The kernels' launches in one hybrid prefill and one decode step:
    a Mamba2 sublayer runs one SSD scan (prefill only) and two RMSNorms
    (its pre-norm and the gated norm), a shared attention block one flash
    attention (prefill only) and two RMSNorms, and the final norm one."""
    from repro_torch.models.transformer import n_groups
    ng, m = n_groups(cfg), cfg.hybrid.mamba_per_group
    norms = ng * (2 * m + 2) + 1
    zero = {n: 0 for n in COUNTERS}
    return ({**zero, "ssd_scan": ng * m, "flash_attention": ng,
             "rmsnorm": norms}, {**zero, "rmsnorm": norms})


def phase_serve_hybrid(device="cuda", smoke=False):
    """The hybrid family (zamba2_2p7b) through the launcher's entry point
    on the dense plane, then each kernel's launches in one prefill and one
    decode step, and the logits of the prefill and of the first decode
    step (each from the state its own prefill left, so the kernel's final
    SSM state feeds the step) against ``impl="torch"``: the whole stack in
    fp32, and group by group in bf16 (see HYBRID_F32_RTOL)."""
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.models.transformer import flatten, unflatten
    argv = ["--arch", "zamba2_2p7b", "--batch", "4", "--prompt-len", "1000",
            "--gen", "32", "--seed", "0", "--device", device]
    if smoke:
        argv = argv[:2] + ["--smoke", "--batch", "2", "--prompt-len", "24",
                           "--gen", "6", "--device", device]
    args = serve.parse_args(argv)
    zero_counts()
    _zero_eager_calls()
    res = serve.run(args)
    launches = counts()
    rt, cfg = res["runtime"], res["cfg"]
    # the main path's peak, before the checks' fp32 copy of the weights
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if rt.device.type == "cuda" else None)
    B, P, G = args.batch, args.prompt_len, args.gen
    graph = graph_check("serve_hybrid", rt.decode_graph, G - 1,
                        _eager_calls(), device)
    toks = res["tokens"]
    check(toks.shape == (B, G) and toks.min() >= 0
          and toks.max() < cfg.vocab_size, f"hybrid tokens {toks.shape}")

    # the checks' launches are not the main path's: counted apart, then
    # the main path's counts are put back
    params, tokens = rt.state["params"], torch.as_tensor(
        res["batch"]["tokens"], device=rt.device)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params32 = unflatten((k, v.float()) for k, v in flatten(params))
    logits, per_call, first = {}, {}, None
    for dt_name, c, p in (("bf16", cfg, params), ("f32", cfg32, params32)):
        for impl in ("auto", "torch"):
            key = f"{dt_name}_{impl}"
            zero_counts()
            cache = model.init_cache(c, B, P + 1, rt.device)
            lg, _ = model.prefill(p, c, {"tokens": tokens}, cache, impl=impl)
            per_call[key] = counts()
            if first is None:
                # every decode check steps from the main path's first token
                first = torch.argmax(lg, -1)[:, None].to(torch.int32)
            zero_counts()
            step, _ = model.decode_step(p, c, first, cache, P, impl=impl)
            per_call[f"decode_{key}"] = counts()
            logits[key] = (lg.float(), step.float())
            del cache
    del params32
    groups = hybrid_group_check(params, cfg, tokens, first)
    set_counts(launches)
    check(bool((first[:, 0].cpu().numpy() == toks[:, 0]).all()),
          "the runtime's first token is not the prefill logits' argmax")
    # fp32: checked; bf16 whole stack: its spread, read and not checked
    chk, chk_dec = ({"f32": logits_check(logits["f32_auto"][i],
                                         logits["f32_torch"][i],
                                         HYBRID_F32_RTOL),
                     "bf16_whole_stack": {
                         k: v for k, v in logits_check(
                             logits["bf16_auto"][i],
                             logits["bf16_torch"][i]).items()
                         if k not in ("tol", "passed")}}
                    for i in (0, 1))
    check(chk["f32"]["passed"], f"hybrid prefill logits: {chk}")
    check(chk_dec["f32"]["passed"],
          f"hybrid first decode step logits: {chk_dec}")
    worst = {step: max(r["err_over_range"] for r in groups[step])
             for step in ("prefill", "decode")}
    groups["limit"], groups["worst"] = HYBRID_GROUP_RTOL, worst
    check(all(r["finite"] for step in ("prefill", "decode")
              for r in groups[step])
          and max(worst.values()) <= HYBRID_GROUP_RTOL
          and groups["ssm_state_after_prefill"]["err_over_range"]
          <= HYBRID_GROUP_RTOL,
          f"hybrid bf16 groups, kernels against impl=\"torch\": {groups}")
    del logits

    want_pre, want_dec = hybrid_launches(cfg)
    if rt.device.type != "cuda":
        want_pre = want_dec = {n: 0 for n in COUNTERS}
    # the fp32 stack's SSD scans take the scalar route
    want_f32 = dict(want_pre, ssd_scan_scalar=want_pre["ssd_scan"])
    check(per_call["bf16_auto"] == want_pre
          and per_call["decode_bf16_auto"] == want_dec
          and per_call["f32_auto"] == want_f32
          and per_call["decode_f32_auto"] == want_dec
          and all(set(per_call[k].values()) == {0} for k in per_call
                  if k.endswith("torch")),
          f"hybrid launches per prefill and decode step {per_call} (want "
          f"{want_pre} ({want_f32} in fp32) and {want_dec} with the "
          f"kernels, none without)")
    check(launches == {n: want_pre[n] + (G - 1) * want_dec[n]
                       for n in COUNTERS},
          f"hybrid main path launches {launches}: not one prefill and "
          f"{G - 1} decode steps")
    vs_eager, eager_cache, first, pos = captured_vs_eager(
        rt, {"tokens": tokens}, G - 1)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": B,
           "prompt_len": P, "gen": G,
           "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
           "prefill_tok_s": B * P / res["prefill_s"],
           "decode_tok_s": B * (G - 1) / res["decode_s"],
           "launches": launches, "decode_graph": graph,
           "captured_vs_eager": vs_eager,
           "launches_per_prefill": per_call["bf16_auto"],
           "launches_per_decode_step": per_call["decode_bf16_auto"],
           "logits_check": chk, "first_decode_logits_check": chk_dec,
           "bf16_group_check": groups}
    if rt.device.type == "cuda":
        out["peak_mem_gb"] = peak
        cache = model.init_cache(cfg, B, P, rt.device)
        out["warm_prefill"] = profile_steps(
            lambda: model.prefill(params, cfg, {"tokens": tokens}, cache), 2)
        del cache
        # a fresh decode context, in the graph's own cache: the SSM states
        # restart from zeros and cache_len goes back to P
        for t in _tensors(rt.cache):
            t.zero_()
        rt.prefill({"tokens": tokens})
        out["warm_decode_step"] = profile_steps(rt.step, 3)
        pos.fill_(P)
        out["warm_decode_step_eager"] = profile_steps(
            lambda: rt.decode_graph.fn(params, first, eager_cache, pos,
                                       None), 3)
    emit("serve_hybrid", **out)
    return out


def leaf_grad_norms(grads):
    """The grad norm of every leaf in fp32, per layer for the stacked
    ``layers/`` leaves (one slice at a time: a whole full-width leaf in
    fp32 would not fit beside the model)."""
    from repro_torch.models.transformer import flatten
    out = {}
    for path, g in flatten(grads):
        if path.startswith("layers/"):
            for i in range(g.shape[0]):
                out[f"{path}[{i}]"] = float(torch.linalg.vector_norm(
                    g[i].float()))
        else:
            out[path] = float(torch.linalg.vector_norm(g.float()))
    return out


# step-0 limits, 17x or more above the relative errors read on the H100
# (PERF.md: loss 2.3e-5, grad norm 7.5e-5 to 1.6e-4, worst leaf 1.2e-3)
STEP0_RTOL = {"loss": 1e-3, "grad_norm": 5e-3, "worst_leaf_grad_norm": 2e-2}


def step0_reads(params, cfg, batch, impl):
    """Step 0's loss, grad norm and every leaf's grad norm (per layer for
    the stacked leaves), no update."""
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as train_lib
    loss, grads = train_lib.value_and_grad(params, cfg, batch, impl=impl)
    return (float(loss), float(opt_lib.global_norm(grads)),
            leaf_grad_norms(grads))


def step0_distance(got, want, ref="torch"):
    """How far one step-0 read (``step0_reads``) lies from another, named
    ``ref``: the loss, the grad norm, the leaf whose grad norm lies
    farthest and the root mean square over the leaves, each relative to
    ``want``'s."""
    (la, ga, na), (lt, gt, nt) = got, want
    leaf_err = {k: abs(na[k] - nt[k]) / max(abs(nt[k]), 1e-30) for k in nt}
    worst = max(leaf_err, key=leaf_err.get)
    rms = float(np.sqrt(np.mean(np.square(list(leaf_err.values())))))
    return {"loss": la, f"loss_{ref}": lt, "grad_norm": ga,
            f"grad_norm_{ref}": gt, "loss_rel_err": abs(la - lt) / abs(lt),
            "grad_norm_rel_err": abs(ga - gt) / abs(gt),
            "worst_leaf": worst, "worst_leaf_grad_norm": na[worst],
            f"worst_leaf_grad_norm_{ref}": nt[worst],
            "worst_leaf_grad_norm_rel_err": leaf_err[worst],
            "leaf_rms_rel_err": rms, "leaves": len(nt), "finite": bool(np.isfinite(
                [la, lt, ga, gt, *na.values(), *nt.values()]).all())}


def held_within(chk, rtol, what):
    """``chk`` (``step0_distance``) held under ``rtol``, a limit for each
    of its three distances."""
    chk["rtol"] = rtol
    chk["within_rtol"] = all(chk[f"{k}_rel_err"] <= r
                             for k, r in rtol.items())
    check(chk["finite"] and chk["within_rtol"], f"{what}: {chk}")
    return chk


def step0_check(params, cfg, batch):
    """Step 0 with the kernels against the same params and batch with
    ``impl="torch"``.  Both paths round every layer's activations and
    gradients to bf16, and a kernel and its plain version may land a
    value on neighbouring bf16 steps; the limits (``STEP0_RTOL``) leave
    room for that, read from the card.  The kernels themselves are held
    element by element in the kernels phase."""
    got, want = (step0_reads(params, cfg, batch, impl)
                 for impl in ("auto", "torch"))
    return held_within(step0_distance(got, want), STEP0_RTOL,
                       "step-0 check")


# the kernels' bf16 hybrid step 0 may lie this many times as far from the
# fp32 one as the plain bf16 step 0 does (or within STEP0_RTOL of it); read
# on the H100, the kernels' distances were 0.42-1.04 times the plain's
# (PERF.md §6)
BF16_STEP0_MARGIN = 1.25


def step0_upcast_check(params, cfg, batch):
    """The hybrid's step 0 with the weights upcast to fp32, every kernel on
    its fp32 instantiation and TF32 off, against ``impl="torch"`` on the
    same weights: held under STEP0_RTOL.  The random-weight bf16 stack
    moves its step 0 farther than STEP0_RTOL from ``impl="torch"``'s in
    bf16, so the bf16 step 0 is held against the fp32 one instead: the
    kernels' loss, grad norm, worst leaf and leaves' root mean square may
    lie no farther from it than the plain version's bf16 step 0 does,
    times BF16_STEP0_MARGIN, or within STEP0_RTOL (the worst leaf's for
    the mean).  Single leaves scatter too widely to hold one by one (a
    leaf's two bf16 distances read 0.4-13 times each other); those past
    STEP0_RTOL are recorded with both distances."""
    from repro_torch.models.transformer import flatten, unflatten
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params32 = unflatten((k, v.detach().float().requires_grad_(True))
                         for k, v in flatten(params))
    f32 = {impl: step0_reads(params32, cfg32, batch, impl)
           for impl in ("auto", "torch")}
    del params32
    bf16 = {impl: step0_reads(params, cfg, batch, impl)
            for impl in ("auto", "torch")}
    plain = step0_distance(bf16["torch"], f32["torch"], "f32")
    rtol = dict(STEP0_RTOL, leaf_rms=STEP0_RTOL["worst_leaf_grad_norm"])
    limit = {k: max(r, BF16_STEP0_MARGIN * plain[f"{k}_rel_err"])
             for k, r in rtol.items()}
    kernels = step0_distance(bf16["auto"], f32["torch"], "f32")
    far = {}
    for leaf, want in f32["torch"][2].items():
        d = [abs(bf16[impl][2][leaf] - want) / max(abs(want), 1e-30)
             for impl in ("auto", "torch")]
        if max(d) > rtol["leaf_rms"]:
            far[leaf] = {"kernels": d[0], "plain": d[1]}
    kernels["leaves_past_rtol"] = far
    return {"f32": held_within(step0_distance(f32["auto"], f32["torch"]),
                               STEP0_RTOL, "step-0 check, fp32"),
            "bf16": step0_distance(bf16["auto"], bf16["torch"]),
            "bf16_plain_vs_f32": plain,
            "bf16_vs_f32": held_within(
                kernels, limit, f"bf16 step 0 against the fp32 one (the "
                f"plain bf16 step 0's distance from it: {plain})")}


def train_launches(cfg, shape, opt_cfg, params):
    """The kernels' launches in one train step: each microbatch runs every
    group's kernels forward, again in the group's recompute (remat) and
    once backward (the final norm is outside the groups); a dense group
    is one layer (attention and 2 norms), a hybrid group m Mamba2 layers
    (an SSD scan and 2 norms each) and the shared block (attention and 2
    norms); one AdamW launch a leaf, int8 or fp32 as the moments; no
    scalar-route launch."""
    from repro_torch.models.transformer import flatten, n_groups
    ng, fwd = n_groups(cfg), 2 if cfg.remat != "none" else 1
    m = cfg.hybrid.mamba_per_group if cfg.family == "hybrid" else 0
    norms = ng * (2 * m + 2) + 1
    mb = max(1, shape.microbatch)
    adamw = "fused_adamw_i8" if opt_cfg.state_bits == 8 else \
        "fused_adamw_f32"
    return {**{n: 0 for n in COUNTERS},
            "ssd_scan": mb * fwd * ng * m, "ssd_scan_bwd": mb * ng * m,
            "flash_attention": mb * fwd * ng, "flash_attention_bwd": mb * ng,
            "rmsnorm": mb * (fwd * (norms - 1) + 1), "rmsnorm_bwd": mb * norms,
            adamw: len(flatten(params))}


def _train_phase(name, cfg, shape, opt_cfg, device, n_steps, profile,
                 step0=step0_check):
    """A train block through ``BlockRuntime``: the step-0 check
    (``step0``), then ``n_steps`` steps counted as the main path, their
    launches per step held exactly (``train_launches``; none on the
    CPU)."""
    progress(f"{name}: init")
    from repro_torch.core.block import BlockGrant
    from repro_torch.core.runtime import BlockRuntime, JobSpec
    job = JobSpec(cfg, shape, kind="train", opt=opt_cfg, seed=0)
    rt = BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 3600.0), job,
                      devices=[device])
    t0 = time.perf_counter()
    rt.init_state()
    rt._sync()
    init_s = time.perf_counter() - t0
    progress(f"{name}: step-0 check")
    chk = step0(rt.state["params"], cfg, rt.data.batch(0))
    progress(f"{name}: {n_steps} steps")
    if rt.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    hist = []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        hist.append(rt.step())
    elapsed = time.perf_counter() - t0
    launches = counts()
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)) and all(np.isfinite(
        [h["grad_norm"] for h in hist])), f"{name}: losses {losses}")
    tokens = shape.global_batch * shape.seq_len
    steady = [h["step_s"] for h in hist[1:]] or [hist[0]["step_s"]]
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "state_bits": opt_cfg.state_bits, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch,
           "microbatch": shape.microbatch, "steps": n_steps,
           "init_s": init_s, "step0_check": chk, "losses": losses,
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_s": [h["step_s"] for h in hist],
           "tok_s": n_steps * tokens / elapsed,
           "steady_tok_s": tokens / float(np.median(steady)),
           "steady_step_s": float(np.median(steady)),
           "launches": launches,
           "launches_per_step": {k: c / n_steps for k, c in launches.items()}}
    want = (train_launches(cfg, shape, opt_cfg, rt.state["params"])
            if rt.device.type == "cuda" else {n: 0 for n in COUNTERS})
    out["launches_per_step_expected"] = want
    check(out["launches_per_step"] == want,
          f"{name} launches per step {out['launches_per_step']}, want "
          f"{want}")
    if rt.device.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if profile:
            out["warm_step"] = profile_steps(rt.step, 1)
    emit(name, **out)
    return out


def phase_train(device="cuda", smoke=False):
    """deepseek_7b at full width, all 30 layers, int8 moments."""
    import repro_torch.configs as configs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optimizer import OptConfig
    cfg = (configs.get_smoke("deepseek_7b") if smoke
           else configs.get("deepseek_7b"))
    shape = ShapeConfig("chip", "train", seq_len=32 if smoke else 2048,
                        global_batch=2, microbatch=1)
    opt_cfg = OptConfig(state_bits=8, warmup_steps=2, total_steps=100)
    return _train_phase("train", cfg, shape, opt_cfg, device,
                        n_steps=2 if smoke else 6, profile=True)


def phase_train_f32(device="cuda", smoke=False):
    """The same width cut to 4 layers, fp32 moments, 2 microbatches."""
    import repro_torch.configs as configs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optimizer import OptConfig
    cfg = (configs.get_smoke("deepseek_7b") if smoke
           else configs.get("deepseek_7b"))
    cfg = dataclasses.replace(cfg, n_layers=2 if smoke else 4)
    shape = ShapeConfig("chip", "train", seq_len=32 if smoke else 2048,
                        global_batch=2, microbatch=2)
    opt_cfg = OptConfig(state_bits=None, warmup_steps=2, total_steps=100)
    return _train_phase("train_f32", cfg, shape, opt_cfg, device,
                        n_steps=2 if smoke else 3, profile=False)


def _train_hybrid_setup(smoke):
    """train_hybrid's job: zamba2_2p7b at full width (54 layers), 2 x 2048
    tokens a step (2 x 32 at smoke size), one microbatch, fp32 moments."""
    import repro_torch.configs as configs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optimizer import OptConfig
    cfg = (configs.get_smoke("zamba2_2p7b") if smoke
           else configs.get("zamba2_2p7b"))
    shape = ShapeConfig("chip", "train", seq_len=32 if smoke else 2048,
                        global_batch=2, microbatch=1)
    opt_cfg = OptConfig(state_bits=None, warmup_steps=2, total_steps=100)
    return cfg, shape, opt_cfg


def phase_train_hybrid(device="cuda", smoke=False):
    """zamba2_2p7b at full width (54 layers, random bf16 weights from seed
    0), fp32 AdamW moments, 2 x 2048 tokens a step, one microbatch, remat:
    the step 0 in fp32 (weights upcast) against impl="torch" under
    STEP0_RTOL and the bf16 step 0 beside it; 3 steps, their launches per
    step held exactly (``train_launches``), and a profiled step."""
    cfg, shape, opt_cfg = _train_hybrid_setup(smoke)
    return _train_phase("train_hybrid", cfg, shape, opt_cfg, device,
                        n_steps=2 if smoke else 4, profile=True,
                        step0=step0_upcast_check)


# ---------------------------------------------------------------- preempt

def _tensors(tree):
    """The tensors of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, torch.Tensor):
        yield tree


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def bit_checksums(tree, chunk: int = 1 << 26):
    """Per-leaf checksums of the raw bits, computed where the leaf lies:
    the sum and a position-weighted sum of its 32-bit words (16- or 8-bit
    where its size is no multiple of 4), in int64 with wraparound."""
    out = []
    for t in _tensors(tree):
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        width = next(w for w in (4, 2, 1) if b.numel() % w == 0)
        words = b.view({4: torch.int32, 2: torch.int16, 1: torch.uint8}[
            width])
        s1 = s2 = torch.zeros((), dtype=torch.int64, device=t.device)
        for o in range(0, words.numel(), chunk):
            w = words[o:o + chunk].to(torch.int64)
            pos = torch.arange(o, o + w.numel(), device=t.device) % 1000003
            s1 = s1 + w.sum()
            s2 = s2 + (w * (pos + 1)).sum()
        out.append((int(s1), int(s2)))
    return out


def _mem(device):
    return (torch.cuda.memory_allocated() if device.type == "cuda"
            else None)


def _ckpt_files(rt):
    """The latest checkpoint's bytes on disk and its leaf count."""
    path = os.path.join(rt.ckpt.dir, f"step_{rt.ckpt.latest_step():08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        n = len(json.load(f)["leaves"])
    return sum(os.path.getsize(os.path.join(path, x))
               for x in os.listdir(path)), n


def _disk_check(root, need, what):
    free = shutil.disk_usage(root).free
    progress(f"preempt {what}: {free / 1e9:.1f} GB free for a "
             f"{need / 1e9:.1f} GB checkpoint")
    check(free >= need + (1 << 30),
          f"preempt {what}: {free / 1e9:.2f} GB free under {root}, the "
          f"checkpoint needs {need / 1e9:.2f} GB and 1 GB to spare")
    return free / 1e9


def _suspend_resume(rt, name, root, base_mem):
    """``suspend()``, the card's memory after it, then ``resume()``: the
    timings, GB/s and memory of the pair; the state's checksums before
    and after are held equal bit for bit."""
    payload = rt._payload()
    state_bytes = tree_bytes(payload)
    free = _disk_check(root, state_bytes, name)
    before = bit_checksums(payload)
    del payload
    lost = rt.progress_lost
    from repro_torch.train import compile_cache
    cache_before = compile_cache.GLOBAL.stats()
    graph = rt.decode_graph
    t0 = time.perf_counter()
    info = rt.suspend()
    suspend_s = time.perf_counter() - t0
    check(graph is None or graph._graph is None,
          f"preempt {name}: suspend() kept the decode graph")
    save_t = dict(rt.ckpt.timings)
    held = _mem(rt.device)
    ckpt_bytes, n_leaves = _ckpt_files(rt)
    out = {"state_gb": state_bytes / 1e9, "ckpt_gb": ckpt_bytes / 1e9,
           "ckpt_leaves": n_leaves, "disk_free_gb": free,
           "progress_lost_before_save": lost,
           "progress_lost_after_save": rt.progress_lost,
           "drained_steps": info["drained_steps"],
           "suspend_s": suspend_s,
           "save_s": save_t["copy_s"] + save_t["write_s"],
           "save_stages_s": save_t}
    if held is not None:
        out["mem_after_suspend_gb"] = (held - base_mem) / 1e9
        out["reserved_after_suspend_gb"] = torch.cuda.memory_reserved() / 1e9
        check(held - base_mem < 0.01 * state_bytes,
              f"preempt {name}: {(held - base_mem) / 1e9:.3f} GB still "
              f"allocated after suspend(), 1% of the state is "
              f"{0.01 * state_bytes / 1e9:.3f} GB")
    t0 = time.perf_counter()
    at = rt.resume(rt.grant, [str(rt.device)])
    rt._sync()
    out["resume_s"] = time.perf_counter() - t0
    out["restore_stages_s"] = dict(rt.ckpt.timings)
    check(at == info["step"], f"preempt {name}: resumed at {at}, suspended "
          f"at {info['step']}")
    cache_after = compile_cache.GLOBAL.stats()
    out["compile_cache"] = {"before_suspend": cache_before,
                            "after_resume": cache_after}
    check(cache_after["misses"] == cache_before["misses"]
          and cache_after["hits"] > cache_before["hits"],
          f"preempt {name}: resume is not a compile-cache hit: "
          f"{out['compile_cache']}")
    after = bit_checksums(rt._payload())
    check(after == before, f"preempt {name}: the resumed state's checksums "
          f"differ from the suspended state's in "
          f"{sum(a != b for a, b in zip(after, before))} of {len(before)} "
          f"leaves")
    out["leaves_bitwise_equal"] = len(before)
    for k in ("save", "suspend", "resume"):
        out[f"{k}_gb_s"] = ckpt_bytes / 1e9 / out[f"{k}_s"]
    return out


def _resumed_graph(name, rt, steps):
    """After resume the block's decode captures again, once, and replays
    every step (on the CPU: runs each eagerly)."""
    st = rt.decode_graph.stats()
    want = ((1, steps, 0) if rt.device.type == "cuda" else (0, 0, steps))
    check((st["captures"], st["replays"], st["eager_calls"]) == want,
          f"preempt {name}: the decode graph after resume {st}, want "
          f"(captures, replays, eager) {want}")
    return {**st, "card": _CARD}


def _block(job, device, root=None):
    from repro_torch.core.block import BlockGrant
    from repro_torch.core.runtime import BlockRuntime
    rt = BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 3600.0), job,
                      devices=[device], ckpt_root=root)
    if root is not None:
        rt.ckpt.keep = 1            # one checkpoint on disk at a time
    return rt


def _peak(device):
    if device.type == "cuda":
        return torch.cuda.max_memory_allocated() / 1e9
    return None


def _preempt_train(device, smoke, root, train):
    """zamba2_2p7b's train_hybrid job: 3 steps, suspend, resume, a 4th;
    the 4 losses and grad norms are the uninterrupted run's, bit for
    bit, and the resumed step's launches ``train_launches``'."""
    from repro_torch.core.runtime import JobSpec
    cfg, shape, opt_cfg = _train_hybrid_setup(smoke)
    job = JobSpec(cfg, shape, kind="train", opt=opt_cfg, seed=0,
                  ckpt_namespace="train_hybrid")
    n_before = 1 if smoke else 3
    if train is None:                       # the uninterrupted run
        rt = _block(job, device)
        rt.init_state()
        train = {"losses": [], "grad_norms": []}
        for _ in range(n_before + 1):
            m = rt.step()
            train["losses"].append(m["loss"])
            train["grad_norms"].append(m["grad_norm"])
        del rt
        _free(device)
    dev = torch.device(device)
    base = _mem(dev)
    rt = _block(job, device, root)
    rt.init_state()
    hist = [rt.step() for _ in range(n_before)]
    out = _suspend_resume(rt, "train_hybrid", root, base)
    zero_counts()
    hist.append(rt.step())
    launches = counts()
    want = (train_launches(cfg, shape, opt_cfg, rt.state["params"])
            if dev.type == "cuda" else {n: 0 for n in COUNTERS})
    check(launches == want, f"preempt train_hybrid: the resumed step's "
          f"launches {launches}, want {want}")
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    ref = (train["losses"][:n_before + 1], train["grad_norms"][:n_before + 1])
    check((losses, gnorms) == ref,
          f"preempt train_hybrid: losses {losses} and grad norms {gnorms} "
          f"across a suspend, uninterrupted {ref}")
    out.update(arch=cfg.name, n_layers=cfg.n_layers, steps_before=n_before,
               losses=losses, grad_norms=gnorms, uninterrupted_losses=ref[0],
               resumed_step_launches=launches, peak_mem_gb=_peak(dev))
    shutil.rmtree(rt.ckpt.dir)
    return out, launches


# the serve_paged traffic: 12 sessions through 8 slots, each generating
# this many tokens (the second at smoke size)
PAGED_NEW_TOKENS, PAGED_NEW_TOKENS_SMOKE = 32, 6


def _paged_job(smoke, ns=None):
    import repro_torch.configs as configs
    from repro_torch.core.runtime import JobSpec
    from repro_torch.models.config import ShapeConfig
    cfg = (configs.get_smoke("deepseek_7b") if smoke
           else configs.get("deepseek_7b"))
    max_seq = 64 if smoke else 1024
    return JobSpec(cfg, ShapeConfig("smoke", "serve", seq_len=max_seq,
                                    global_batch=1), kind="serve", seed=0,
                   paged=True, page_size=16, max_slots=8,
                   max_seq_len=max_seq, ckpt_namespace=ns)


def _paged_prompts(cfg, smoke):
    """serve_paged's 12 prompts (17 to 700 tokens; 17 to 40 at smoke
    size)."""
    from repro_torch.data import pipeline
    from repro_torch.models.config import ShapeConfig
    longest = 40 if smoke else 700
    toks = pipeline.synthetic_batch(
        cfg, ShapeConfig("p", "prefill", longest, 12), step=1,
        seed=0)["tokens"]
    lens = np.linspace(17, longest, 12).astype(int)
    return [toks[i, :n].tolist() for i, n in enumerate(lens)]


def _feed(rt, rounds=None):
    ems, n = [], 0
    while not rt.idle_serve and (rounds is None or n < rounds):
        ems.extend(rt.feed())
        n += 1
    return ems, n


def _preempt_paged(device, smoke, root):
    """deepseek_7b's serve_paged traffic (12 sessions through 8 slots,
    greedy), once straight and once suspended after a third of its
    rounds: each session's tokens are the same."""
    job = _paged_job(smoke)
    prompts = _paged_prompts(job.cfg, smoke)
    max_new = PAGED_NEW_TOKENS_SMOKE if smoke else PAGED_NEW_TOKENS
    dev = torch.device(device)

    def start(rt):
        rt.init_state()
        return [rt.start_session(p, max_new_tokens=max_new)
                for p in prompts]

    rt = _block(job, device)
    sids = start(rt)
    want, rounds = _feed(rt)
    want_tokens = {s: rt.sessions.sessions[s].generated for s in sids}
    del rt                                   # released before the fresh one
    _free(device)

    base = _mem(dev)
    rt = _block(_paged_job(smoke, "serve_paged"), device, root)
    start(rt)
    got, _ = _feed(rt, rounds // 3)
    states = [s.state for s in rt.sessions.sessions.values()]
    running, queued = states.count("running"), states.count("queued")
    check(running > 0 and queued > 0, f"preempt serve_paged: suspended "
          f"with {running} sessions running and {queued} queued")
    out = _suspend_resume(rt, "serve_paged", root, base)
    zero_counts()
    rest, n_rest = _feed(rt)
    launches = counts()
    out["decode_graph_after_resume"] = _resumed_graph(
        "serve_paged", rt, n_rest)
    got += rest
    tokens = {s: rt.sessions.sessions[s].generated for s in sids}
    check(tokens == want_tokens, f"preempt serve_paged: tokens across a "
          f"suspend differ in sessions "
          f"{[s for s in sids if tokens[s] != want_tokens[s]]}")
    if dev.type == "cuda":
        check(launches["paged_attention"] > 0
              and launches["flash_attention"] > 0
              and launches["paged_attention_scalar"] == 0,
              f"preempt serve_paged: launches after resume {launches}")
    out.update(arch=job.cfg.name, sessions=len(sids), rounds=rounds,
               suspended_after_rounds=rounds // 3, running=running,
               queued=queued, emissions_equal=got == want,
               launches_after_resume=launches, peak_mem_gb=_peak(dev))
    shutil.rmtree(rt.ckpt.dir)
    return out, launches


def _preempt_hybrid(device, smoke, root):
    """zamba2_2p7b on the dense plane, 4 x 1000 prompt tokens: an async
    save after 4 decode steps while steps 5-8 run, a suspend after 8,
    resume, 8 more; the tokens are 16 uninterrupted steps'."""
    import repro_torch.configs as configs
    from repro_torch.core.runtime import JobSpec
    from repro_torch.data import pipeline
    from repro_torch.models.config import ShapeConfig
    cfg = (configs.get_smoke("zamba2_2p7b") if smoke
           else configs.get("zamba2_2p7b"))
    B, P = (2, 24) if smoke else (4, 1000)
    n1, n2, n3 = (2, 2, 4) if smoke else (4, 4, 8)
    G = n1 + n2 + n3
    job = JobSpec(cfg, ShapeConfig("cli", "serve", seq_len=P + G + 1,
                                   global_batch=B), kind="serve", seed=0,
                  ckpt_namespace="serve_hybrid")
    batch = {"tokens": pipeline.synthetic_batch(
        cfg, ShapeConfig("cli", "prefill", seq_len=P, global_batch=B),
        step=0, seed=0)["tokens"]}
    dev = torch.device(device)

    def decode(rt, n):
        toks, times = [], []
        for _ in range(n):
            m = rt.step()
            times.append(m["step_s"])
            toks.append(rt.token.cpu())
        return toks, times

    rt = _block(job, device)
    rt.init_state()
    rt.prefill(batch)
    want, _ = decode(rt, G)
    del rt
    _free(device)

    base = _mem(dev)
    rt = _block(job, device, root)
    rt.init_state()
    rt.prefill(batch)
    got, t_before = decode(rt, n1)
    _disk_check(root, tree_bytes(rt._payload()), "serve_hybrid async")
    lost_before = rt.progress_lost
    t0 = time.perf_counter()
    rt.save(async_=True)
    save_call_s = time.perf_counter() - t0
    lost_after = rt.progress_lost
    t0 = time.perf_counter()
    toks, t_during = decode(rt, n2)
    during_s = time.perf_counter() - t0
    got += toks
    t0 = time.perf_counter()
    rt.ckpt.wait()
    wait_s = time.perf_counter() - t0
    write_s = rt.ckpt.timings["write_s"]
    delay = during_s - n2 * float(np.median(t_before))
    first_steps = rt.ckpt.steps()
    out = _suspend_resume(rt, "serve_hybrid", root, base)
    check(first_steps == [n1] and rt.ckpt.steps() == [n1 + n2],
          f"preempt serve_hybrid: checkpoints {first_steps} then "
          f"{rt.ckpt.steps()} with keep=1")
    check(rt.cache_len == P + n1 + n2, f"preempt serve_hybrid: cache_len "
          f"{rt.cache_len} after resume")
    zero_counts()
    toks, _ = decode(rt, n3)
    launches = counts()
    out["decode_graph_after_resume"] = _resumed_graph(
        "serve_hybrid", rt, n3)
    got += toks
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "preempt serve_hybrid: tokens across an async save and a suspend "
          "differ from uninterrupted decoding")
    per_step = hybrid_launches(cfg)[1] if dev.type == "cuda" else {}
    want_l = {n: n3 * per_step.get(n, 0) for n in COUNTERS}
    check(launches == want_l, f"preempt serve_hybrid: launches after "
          f"resume {launches}, want {want_l}")
    out.update(arch=cfg.name, batch=B, prompt_len=P,
               decode_steps=[n1, n2, n3],
               async_save={"progress_lost_before": lost_before,
                           "progress_lost_after": lost_after,
                           "call_s": save_call_s,
                           "stages_s": {"copy_s": save_call_s,
                                        "write_s": write_s},
                           "steps_during_s": during_s,
                           "wait_after_steps_s": wait_s,
                           # the write ran beside the steps for overlap_s,
                           # and slowed them by step_delay_s: what it hid
                           # is the difference
                           "overlap_s": write_s - wait_s,
                           "step_delay_s": delay,
                           "hidden_share": (write_s - wait_s - delay)
                           / write_s,
                           "step_s_before": t_before,
                           "step_s_during": t_during},
               checkpoints_kept=rt.ckpt.steps(),
               launches_after_resume=launches, peak_mem_gb=_peak(dev))
    shutil.rmtree(rt.ckpt.dir)
    return out, launches


def phase_preempt(device="cuda", smoke=False, train=None):
    """Checkpoints and preempt/resume at full width, three sub-runs, each
    with its checkpoints under one temporary directory (one at a time,
    ``keep=1``, removed before the next sub-run; the directory goes at
    the end): train_hybrid suspended and resumed between steps 3 and 4
    (``train``: train_hybrid's output, whose 4 steps it must equal; run
    here when not given), serve_paged's 12 sessions suspended after a
    third of their rounds, and serve_hybrid's dense decode with an async
    save and a suspend.  Each sub-run gives its checkpoint's GB and
    leaves, save, suspend and resume seconds and GB/s, progress_lost
    before and after the save, the card's memory after suspend() (held
    under 1% of the state) and peak memory."""
    root = tempfile.mkdtemp(prefix="chip_smoke_preempt_")
    t0 = time.perf_counter()
    out, launches = {}, {n: 0 for n in COUNTERS}
    try:
        for name, run in (("train_hybrid", lambda: _preempt_train(
                               device, smoke, root, train)),
                          ("serve_paged", lambda: _preempt_paged(
                              device, smoke, root)),
                          ("serve_hybrid", lambda: _preempt_hybrid(
                              device, smoke, root))):
            progress(f"preempt: {name}")
            _free(device)
            out[name], got = run()
            launches = {n: launches[n] + got[n] for n in COUNTERS}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = launches
    emit("preempt", **out)
    return out


# ---------------------------------------------------------------- control

#: Alice's step rate until Bob arrives: a dispatch every 2 s, about five
#: train_hybrid steps apart, so Bob's submit lands between her steps and
#: the preemption finds her with exactly half her steps done
CONTROL_PACE_HZ = 0.5
#: the longest the control phase waits for one event of its scenario
CONTROL_TIMEOUT_S = 300.0


def _await(daemon, cond, what):
    """Wait until ``cond()`` holds; fails on a timeout or an engine error
    (the daemon's workers print its traceback and go on)."""
    deadline = time.monotonic() + CONTROL_TIMEOUT_S
    while not cond():
        check(not daemon._engine_error_logged,
              f"control: an engine round raised while waiting for {what}")
        check(time.monotonic() < deadline,
              f"control: no {what} in {CONTROL_TIMEOUT_S:.0f} s")
        time.sleep(0.01)


def _events(log, app_id, kind, **payload):
    return [e for e in list(log) if e.app_id == app_id and e.kind == kind
            and all(e.payload.get(k) == v for k, v in payload.items())]


def phase_control(device="cuda", smoke=False, train=None, paged=None):
    """The paper's scenario on one chip, through ``ClusterDaemon`` in
    background mode (its pump thread serves the commands and the periodic
    tick; an engine worker thread runs the blocks' steps): Alice's train
    block (train_hybrid's job) autosteps toward 4 steps (2 at smoke size),
    paced until Bob arrives; Bob's paged serve block (serve_paged's job)
    is submitted at priority 1 once the bus shows her second step, and the
    scheduler preempts her (drain, a synchronous checkpoint, her memory
    given back) and grants him the chip; his 12 sessions run through
    ``daemon.generate`` and the engine's decode rounds (graph replays);
    his period ends, and the pump's tick expires him and resumes Alice,
    who trains on to her last step.  Held: Alice's losses and grad norms
    are train_hybrid's (``train``) bit for bit, and Bob's tokens
    serve_paged's (``paged``); the bus shows her ``preempted`` (her
    checkpoint at her second step, and both steps counted as what a kill
    without the suspend would have lost), his grant and her ``resumed``,
    in that order; her resume is a
    compile-cache hit with no new miss; while Bob runs, the card holds no
    more than his state, his graph pool and 1% of Alice's state; each
    kernel's launches are exactly her steps', his admissions' and his
    rounds'.  Times come from the events' wall clocks."""
    from repro_torch.core.block import BlockState
    from repro_torch.core.daemon import ClusterDaemon
    from repro_torch.core.runtime import JobSpec
    from repro_torch.core.topology import Topology
    from repro_torch.models import model as model_lib
    if train is None:
        train = phase_train_hybrid(device, smoke)
        _free(device)
    if paged is None:
        paged = phase_serve_paged(device, smoke)
        _free(device)
    cfg, shape, opt_cfg = _train_hybrid_setup(smoke)
    n_steps = len(train["losses"])
    n_before = n_steps // 2
    alice_job = JobSpec(cfg, shape, kind="train", opt=opt_cfg, seed=0,
                        collect_metrics=True)
    bob_job = _paged_job(smoke)
    prompts = _paged_prompts(bob_job.cfg, smoke)
    max_new = PAGED_NEW_TOKENS_SMOKE if smoke else PAGED_NEW_TOKENS
    dev = torch.device(device)
    root = tempfile.mkdtemp(prefix="chip_smoke_control_")
    base = _mem(dev)
    log = []
    daemon = ClusterDaemon(Topology(n_pods=1, pod_x=1, pod_y=1),
                           devices=[device], ckpt_root=root,
                           background=True)
    daemon.bus.subscribe(log.append)
    t0 = time.perf_counter()
    try:
        zero_counts()
        _zero_eager_calls()
        progress("control: alice submits")
        t_alice = time.time()
        alice, grant = daemon.submit("alice", f"train {cfg.name}", 1,
                                     job=alice_job, priority=0)
        check(grant is not None, "control: alice not admitted on a free "
              "chip")
        alice_bytes = tree_bytes(daemon.runtime(alice).state)
        _disk_check(root, alice_bytes, "control")
        daemon.autostep_enable(alice, until_steps=n_steps,
                               max_rate_hz=CONTROL_PACE_HZ)
        _await(daemon, lambda: len(_events(log, alice, "step")) >= n_before,
               f"alice's step {n_before}")

        progress("control: bob submits")
        t_bob = time.time()
        bob, bob_grant = daemon.submit("bob", f"serve {bob_job.cfg.name}",
                                       1, job=bob_job, priority=1)
        check(bob_grant is not None and daemon.registry.get(alice).state
              == BlockState.PREEMPTED,
              f"control: bob {bob_grant}, alice "
              f"{daemon.registry.get(alice).state}")
        daemon.autostep_pace(alice, None)      # unpaced once she resumes
        sids = [daemon.generate(bob, p, max_new_tokens=max_new)
                for p in prompts]
        daemon.autostep_enable(bob)
        _await(daemon, lambda: len(_events(
            log, bob, "session", action="finished")) == len(sids),
            "the end of bob's sessions")
        held = _mem(dev)
        rt = daemon.runtime(bob)
        sch = rt.sessions
        bob_bytes = tree_bytes(rt.state) + tree_bytes(sch.pool)
        graph = sch.decode_graph.stats()
        tokens = {s: list(sch.sessions[s].generated) for s in sids}
        admissions = sch.admissions
        del rt, sch
        progress("control: bob's period ends")
        daemon.registry.get(bob).grant.expires_at = time.time()
        _await(daemon, lambda: _events(log, alice, "autostep",
                                       action="done"),
               "alice's last step")
        launches = counts()
        elapsed = time.perf_counter() - t0
        mfu = daemon.monitor.mfu(grant.block_id)
        roofline = daemon.monitor.roofline_report()["blocks"][
            grant.block_id]
        daemon.expire(alice)
    finally:
        daemon.stop()
        shutil.rmtree(root, ignore_errors=True)

    # Alice: her losses and grad norms across the preemption
    steps = _events(log, alice, "step")
    losses = [e.payload["metrics"]["loss"] for e in steps]
    gnorms = [e.payload["metrics"]["grad_norm"] for e in steps]
    check((losses, gnorms) == (train["losses"], train["grad_norms"]),
          f"control: alice's losses {losses} and grad norms {gnorms} "
          f"through the daemon, train_hybrid's {train['losses']} and "
          f"{train['grad_norms']}")
    # Bob: the direct run's tokens, session by session
    want = paged["session_tokens"]
    check(tokens == want, f"control: bob's tokens differ from "
          f"serve_paged's in sessions "
          f"{[s for s in sids if tokens[s] != want.get(s)]}")
    # the bus: her preemption, his grant, her resume
    pre = _events(log, alice, "preempted")
    granted = _events(log, bob, "state", state="approved")
    res = _events(log, alice, "resumed")
    check(len(pre) == len(granted) == len(res) == 1
          and pre[0].seq < granted[0].seq < res[0].seq,
          f"control: events preempted {pre}, granted {granted}, resumed "
          f"{res}")
    pre, res = pre[0], res[0]
    check(pre.payload["checkpoint_step"] == n_before
          and pre.payload["progress_lost_steps"] == n_before
          and res.payload["step"] == n_before,
          f"control: alice preempted {pre.payload}, resumed "
          f"{res.payload}")
    check(daemon.registry.get(bob).state == BlockState.EXPIRED,
          f"control: bob {daemon.registry.get(bob).state}")
    # her resume is a compile-cache hit
    comp = [e.payload["action"] for e in list(log) if e.kind == "compile"
            and e.block_id == grant.block_id and e.seq > pre.seq]
    check("miss" not in comp and "hit" in comp,
          f"control: alice's compile-cache events after her preemption "
          f"{comp}")
    # memory while Bob runs
    if held is not None:
        limit = bob_bytes + graph["pool_mb"] * 2 ** 20 + 0.01 * alice_bytes
        check(held - base < limit,
              f"control: {(held - base) / 1e9:.3f} GB allocated while bob "
              f"runs, his state {bob_bytes / 1e9:.3f} GB, graph pool "
              f"{graph['pool_mb']:.0f} MB, 1% of alice's "
              f"{0.01 * alice_bytes / 1e9:.3f} GB")
    # launches: her steps, his admissions and rounds
    rounds = graph["replays"] if dev.type == "cuda" else graph["eager_calls"]
    zero = {n: 0 for n in COUNTERS}
    per_step, pre_l, per_round = zero, zero, zero
    if dev.type == "cuda":
        check(graph["captures"] == 1 and graph["eager_calls"] == 0
              and _eager_calls() == 0,
              f"control: bob's decode graph {graph}, {_eager_calls()} "
              f"eager decode steps")
        per_step = train_launches(cfg, shape, opt_cfg,
                                  model_lib.abstract_params(cfg))
        pre_l, _, per_round = dense_launches(bob_job.cfg)
    want = {n: n_steps * per_step[n] + admissions * pre_l[n]
            + rounds * per_round[n] for n in COUNTERS}
    check(launches == want, f"control: launches {launches}, want {want} "
          f"({n_steps} train steps, {admissions} admissions, {rounds} "
          f"rounds)")

    def t_of(evs):
        check(bool(evs), "control: an event the timing needs is missing")
        return evs[0].t

    def state_t(app_id, state):
        return t_of(_events(log, app_id, "state", state=state))

    b_steps = _events(log, bob, "step")
    gen = _events(log, bob, "generate")
    bob_enabled = t_of(_events(log, bob, "autostep", action="enabled"))
    alice_tokens = shape.global_batch * shape.seq_len
    step_s = [e.payload["step_s"] for e in steps]
    out = {
        "alice": {"arch": cfg.name, "n_layers": cfg.n_layers,
                  "steps": n_steps, "preempted_after": n_before,
                  "losses": losses, "grad_norms": gnorms,
                  "state_gb": alice_bytes / 1e9, "step_s": step_s,
                  # each step from its dispatch or its predecessor's end,
                  # whichever is later: their sum is the serial chain's
                  # busy time, the first step and the one after resume
                  # included, as the direct run's tok_s includes its first
                  "tok_s_in_daemon": n_steps * alice_tokens / sum(step_s),
                  "tok_s_direct": train["tok_s"],
                  "steady_step_s_direct": train["steady_step_s"],
                  "mfu": mfu, "roofline": roofline},
        "bob": {"arch": bob_job.cfg.name, "sessions": len(sids),
                "max_new_tokens": max_new, "admissions": admissions,
                "rounds": rounds, "tokens": len(gen),
                "decode_graph": graph,
                "state_gb": bob_bytes / 1e9,
                # from the engine's start on his sessions, as the direct
                # run's from their submission
                "tok_s_in_daemon": len(gen) / (gen[-1].t - bob_enabled),
                "tok_s_direct": paged["tok_s"]},
        "events": {"preempted": pre.payload, "resumed": res.payload,
                   "compile_after_preempt": comp},
        # the events' wall clocks (an "admitted" event carries its
        # submission's time, so a grant is its "approved" state event)
        "seconds": {
            "alice_submit_to_grant": state_t(alice, "approved") - t_alice,
            "alice_activation": state_t(alice, "active")
            - state_t(alice, "approved"),
            "alice_grant_to_first_step": t_of(steps)
            - state_t(alice, "approved"),
            "bob_submit_to_grant": state_t(bob, "approved") - t_bob,
            # Bob's submit to Alice's requeue, right after her suspend
            # (her "preempted" events carry the submission's time)
            "alice_suspend": t_of(_events(log, alice, "enqueued",
                                          preempted=True)) - t_bob,
            "bob_activation": state_t(bob, "active")
            - state_t(bob, "approved"),
            "bob_grant_to_first_step": t_of(b_steps)
            - state_t(bob, "approved"),
            "bob_enable_to_first_step": t_of(b_steps) - bob_enabled,
            "bob_submit_to_first_token": t_of(gen) - t_bob,
            "bob_expiry_to_alice_resumed": res.t - state_t(bob, "expired"),
            "bob_expiry_to_alice_step": t_of(
                [e for e in steps if e.seq > res.seq])
            - state_t(bob, "expired"),
            "phase": elapsed},
        "launches": launches, "card": _CARD}
    if held is not None:
        out["mem_while_bob_gb"] = (held - base) / 1e9
        out["mem_limit_gb"] = limit / 1e9
    out["overhead_us_per_step"] = control_overhead()
    emit("control", **out)
    return out


def control_overhead(n: int = 2000) -> dict:
    """The control plane's own host time per step, in microseconds: a
    block whose steps take no time (``SimJobSpec(step_s=0)``), stepped
    ``n`` times by ``run_steps`` and by inline engine rounds, every step
    through the window, the bus and the Monitor as a real block's."""
    from repro_torch.core.block import BlockState
    from repro_torch.core.daemon import ClusterDaemon
    from repro_torch.core.runtime import SimJobSpec
    from repro_torch.core.topology import Topology
    out = {}
    for driver in ("run_steps", "autostep"):
        root = tempfile.mkdtemp(prefix="chip_smoke_overhead_")
        try:
            d = ClusterDaemon(Topology(n_pods=1, pod_x=1, pod_y=1),
                              devices=["cpu"], ckpt_root=root)
            app, _ = d.submit("sim", "overhead", 1,
                              job=SimJobSpec(step_s=0.0))
            t0 = time.perf_counter()
            if driver == "run_steps":
                d.run_steps({app: n})
            else:
                d.autostep_enable(app, until_steps=n)
                while d.registry.get(app).state != BlockState.DONE:
                    d.autostep_round()
            out[driver] = (time.perf_counter() - t0) / n * 1e6
            check(d.runtime(app).step_count == n,
                  f"control overhead: {driver} ran "
                  f"{d.runtime(app).step_count} of {n} steps")
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repository)

    global _RECORD
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.jsonl"),
              "w") as record:
        _RECORD = record
        try:
            return _run_all()
        finally:
            _RECORD = None


def _free(device="cuda") -> None:
    """Release the last phase's tensors (the paged phase's taps form a
    reference cycle) so the next phase's peak memory is its own."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def emit_capture_summary(info, dense, paged, hybrid) -> None:
    """One line: each decode path's step wall time, idle share and tok/s
    run eagerly and as graph replays (the same run, the same card), its
    capture time and graph pool."""
    paths = {}
    for name, run, key in (("serve_dense", dense, "warm_decode_step"),
                           ("serve_paged", paged, "warm_decode_round"),
                           ("serve_hybrid", hybrid, "warm_decode_step")):
        eager, captured = run[key + "_eager"], run[key]
        vs = run["captured_vs_eager"]
        paths[name] = {
            "eager": {"wall_ms": eager["wall_ms"],
                      "device_ms": eager["device_ms"],
                      "idle_share": eager["idle_share"],
                      "tok_s": vs["eager_tok_s"]},
            "captured": {"wall_ms": captured["wall_ms"],
                         "device_ms": captured["device_ms"],
                         "idle_share": captured["idle_share"],
                         "tok_s": vs["captured_tok_s"]},
            "capture_ms": run["decode_graph"]["capture_ms"],
            "pool_mb": run["decode_graph"]["pool_mb"],
            "bitwise_equal": vs["tokens_equal"] and vs.get(
                "cache_bitwise_equal", vs.get("pool_bitwise_equal"))}
    emit("decode_capture", card=info["nvidia_smi"], paths=paths)


def _run_all() -> int:
    info = phase_device()
    phase_build()
    progress("kernels")
    kern = phase_kernels()
    _free()
    progress("serve_dense")
    dense = phase_serve_dense()
    _free()
    progress("serve_paged")
    paged = phase_serve_paged()
    _free()
    progress("serve_hybrid")
    hybrid = phase_serve_hybrid()
    _free()
    train = phase_train()
    _free()
    train_f32 = phase_train_f32()
    _free()
    train_hybrid = phase_train_hybrid()
    _free()
    preempt = phase_preempt(train=train_hybrid)
    _free()
    progress("control")
    control = phase_control(train=train_hybrid, paged=paged)

    nl = dense["launches"]
    check(nl["flash_attention"] >= 30 and nl["rmsnorm"] >= 61,
          f"dense path launches {nl}")
    pl = paged["launches"]
    check(pl["paged_attention"] >= 30 * paged["decode_rounds"] > 0
          and pl["flash_attention"] >= 30 * paged["admissions"]
          and pl["rmsnorm"] > 0 and pl["paged_attention_scalar"] == 0,
          f"paged path launches {pl}")
    # serve_hybrid's counts, and the train phases' per step, were held
    # exactly in their phases
    runs = {"dense": nl, "paged": pl, "hybrid": hybrid["launches"],
            "train": train["launches"], "train_f32": train_f32["launches"],
            "train_hybrid": train_hybrid["launches"],
            "preempt": preempt["launches"], "control": control["launches"]}

    def launched(counter):
        return {run: c[counter] for run, c in runs.items()}

    # the launches that ran inside decode graphs, run by run: each graph's
    # replays times its launches per replay
    graphs = {"dense": [dense["decode_graph"]],
              "paged": [paged["decode_graph"]],
              "hybrid": [hybrid["decode_graph"]],
              "preempt": [preempt[k]["decode_graph_after_resume"]
                          for k in ("serve_paged", "serve_hybrid")],
              "control": [control["bob"]["decode_graph"]]}

    def in_graphs(counter):
        if counter not in COUNTERS:    # fused_adamw: train only, eager
            return {}
        key = "{}.{}".format(*COUNTERS[counter])
        got = {run: sum(g["replays"] * g["launches_per_replay"].get(key, 0)
                        for g in gs) for run, gs in graphs.items()}
        return {run: n for run, n in got.items() if n}

    emit_capture_summary(info, dense, paged, hybrid)

    rows = []
    for name, meta in KERNEL_META.items():
        k = kern[name]
        if name == "fused_adamw":      # i8 on train, f32 on the others
            per_run = {"train": train["launches"]["fused_adamw_i8"],
                       "train_f32": train_f32["launches"]["fused_adamw_f32"],
                       "train_hybrid":
                           train_hybrid["launches"]["fused_adamw_f32"],
                       "preempt": preempt["launches"]["fused_adamw_f32"],
                       "control": control["launches"]["fused_adamw_f32"]}
        else:
            per_run = launched(name)
        total = sum(per_run.values())
        check(total > 0, f"{name} was not launched on the main path")
        row = {"name": name, "route": "cuda", **meta,
               "launches": total, "launches_by_run": per_run,
               "launches_in_graphs_by_run": in_graphs(name),
               "max_abs_err": k["max_err"], "ms": k["kernel_ms"],
               "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
               "bound_by": k["bound_by"],
               "library_ms": k["library_ms"], "shape": k["shape"]}
        if "was_route" in k:
            # a redesigned kernel: the route its main path took before
            # (flash's CUDA-core kernels, the scalar routes of the fused
            # AdamW and the paged decode kernel), timed in this run on the
            # same inputs one element off alignment
            row["was_ms"] = k["was_route"]["kernel_ms"]
        if "f32" in k:
            row["f32"] = k["f32"]
        if "passes_ms" in k:
            row["passes_ms"] = k["passes_ms"]
        row["bound_share"] = k["bound_ms"] / k["kernel_ms"]
        rows.append(row)
    line = json.dumps({"kernels": rows})
    print(line, flush=True)
    _RECORD.write(line + "\n")
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
