#!/usr/bin/env python3
"""Run the PyTorch port's serving path on one NVIDIA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and
the repository's ``src/``; imports ``repro_torch``, ``torch`` and numpy,
never JAX.  Phases, each printing one JSON line:

1. ``device``      — the card (``nvidia-smi`` name and power limit), torch
                     and CUDA versions;
2. ``build``       — builds the CUDA kernels from ``src/repro_torch/kernels/
                     csrc`` with ``nvcc`` for ``sm_90a`` (into ``build/``);
3. ``kernels``     — each kernel against its plain PyTorch version on the
                     card, element by element, at the main path's
                     full-width bf16 shapes and at edge cases (among them
                     the paged plane's admission prefill shapes and the
                     other dense configs' head groups), with its time, the
                     plain version's, one PyTorch library call's where one
                     computes the same function, and the least time the
                     card could take;
4. ``serve_dense`` — ``repro_torch.launch.serve`` on deepseek_7b at full
                     width (random bf16 weights from the seed): batched
                     prefill + greedy decode, the kernels' launch counts,
                     and the prefill logits against the same path with
                     ``impl="torch"``;
5. ``serve_paged`` — a paged serve ``BlockRuntime`` on the same model: 12
                     generate sessions through 8 slots, the launch counts,
                     the logits of two admission prefills (two prompt
                     buckets) and of the first decode round against
                     ``impl="torch"``, tokens/s and TTFT.

Then one JSON line listing every kernel, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero without that line; so does a machine without CUDA or a
directory without the package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

KERNEL_META = {
    "flash_attention": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:27"},
    "rmsnorm": {
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:19"},
    "paged_attention": {
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:40"},
}


def emit(phase: str, **data) -> None:
    print(json.dumps({"phase": phase, **data}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------- counters

def _kernel_modules():
    from repro_torch.kernels import flash_attention, paged_attention, rmsnorm
    return {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
            "paged_attention": paged_attention}


def counts():
    return {n: m.LAUNCHES for n, m in _kernel_modules().items()}


def set_counts(values):
    for n, m in _kernel_modules().items():
        m.LAUNCHES = values[n]


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


def profile_steps(fn, n: int = 3):
    """Host wall time per call of ``fn`` (warm, ending in a device sync),
    then the device kernel time per call over ``n`` more calls under
    ``torch.profiler``, the device's idle share, and the kernels that take
    the most device time."""
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
            e.count / n} for e in kern[:8]]
    return {"wall_ms": wall, "device_ms": dev,
            "idle_share": max(0.0, 1.0 - dev / wall), "top": top}


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


def logits_check(got, want) -> dict:
    """A whole path's logits against the same path with ``impl="torch"``,
    within 5% of the logits' range: each of the 30 layers rounds its bf16
    activations, and a kernel and its plain version may round a value to
    neighbouring bf16 steps; those differences pass through the rest of the
    stack.  The kernels themselves are held element by element (``close``)
    in the kernels phase."""
    err = max_err(got, want)
    tol = 5e-2 * max(1.0, float(want.float().abs().max()))
    check(bool(torch.isfinite(got).all()), "logits not finite")
    return {"max_abs_err": err, "tol": tol, "passed": err <= tol,
            "rms_err": rms(got.float() - want.float()), "rms_want": rms(want),
            "argmax_agree": float((torch.argmax(got, -1)
                                   == torch.argmax(want, -1)).float().mean())}


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
    emit("device", **info)
    return info


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.load()._name
    build_s = time.perf_counter() - t0
    log = os.path.join(os.path.dirname(path), "build.log")
    ptxas = []
    if os.path.exists(log):
        with open(log) as f:
            ptxas = [ln.strip() for ln in f
                     if "registers" in ln or "spill" in ln]
    emit("build", seconds=build_s, library=os.path.relpath(path, ROOT),
         ptxas=ptxas)
    return build_s


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _randn(shape, g, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


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
    got = paged_attention_cuda(q, k_pages, v_pages, pt, sl)
    want = paged_attention_torch(q, k_pages, v_pages, pt, sl)
    torch.cuda.synchronize()
    return (q, k_pages, v_pages, pt, sl), got, want


def phase_kernels():
    """Every kernel vs its plain version at full width (timed) and at edge
    cases.  Launches made here are checks, not the main path's."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_torch)
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_torch)
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

    # ---- flash attention: dense prefill, q/k/v (4, 32, 512, 128) causal
    (q, k, v, kw), got, want = flash_case(4, 32, 32, 512, 512, 128, 128)
    err, ratio = close(got, want, 2e-2)
    check(ratio <= 1.0 and bool(torch.isfinite(got).all()),
          f"flash_attention full width: max_abs_err {err}, {ratio} x tol")
    B, H, S, D = q.shape
    pairs = H * B * sum(min(S, i + 1) for i in range(S))
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
    b_ms, b_by = bound(nbytes, pairs * 2 * (D + D))
    out["flash_attention"] = {
        "shape": [B, H, S, D], "max_err": err, "rtol": 2e-2,
        "err_over_tol": ratio,
        "kernel_ms": time_ms(lambda: flash_attention_cuda(q, k, v, **kw)),
        "plain_ms": time_ms(lambda: flash_attention_torch(q, k, v, **kw)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        "bound_ms": b_ms, "bound_by": b_by}
    del q, k, v, got, want
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
            ("f32_small_heads", (2, 4, 2, 65, 65, 16, 8),
             dict(dtype=torch.float32))]:
        _, got, want = flash_case(*args, **kw2)
        rel = 1e-4 if kw2.get("dtype") == torch.float32 else 2e-2
        edge("flash_attention", name, got, want, rel)
        if name == "fully_masked_rows":
            check(bool((got[:, :, :10] == 0).all()),
                  "flash_attention: fully masked rows are not 0")

    # ---- rmsnorm: prefill rows (2048, 4096), decode rows (4, 4096)
    for rows, key in ((2048, "rmsnorm"), (4, "rmsnorm_decode")):
        (x, s), got, want = rms_case(rows, 4096)
        err, ratio = close(got, want, 2e-2)
        check(ratio <= 1.0, f"rmsnorm ({rows}, 4096): max_abs_err {err}, "
              f"{ratio} x tol")
        b_ms, b_by = bound(2 * (2 * x.numel() + s.numel()), 4 * x.numel(),
                           F32_FLOPS)
        out[key] = {
            "shape": [rows, 4096], "max_err": err, "rtol": 2e-2,
            "err_over_tol": ratio,
            "kernel_ms": time_ms(lambda: rmsnorm_cuda(x, s)),
            "plain_ms": time_ms(lambda: rmsnorm_torch(x, s)),
            "library_ms": time_ms(lambda: F.rms_norm(x, (4096,), s, 1e-6)),
            "bound_ms": b_ms, "bound_by": b_by}
    for name, args, kw2 in [("d8_f32", (3, 8), dict(dtype=torch.float32)),
                            ("d4100_scalar_path", (5, 4100), {}),
                            ("d8192", (7, 8192), {}),
                            ("misaligned", (6, 4096), dict(offset=3))]:
        _, got, want = rms_case(*args, **kw2)
        rel = 1e-5 if kw2.get("dtype") == torch.float32 else 2e-2
        edge("rmsnorm", name, got, want, rel)

    # ---- paged attention: 8 slots, 32 kv heads, D 128, page 16, lens 17-1000
    lens = [17, 157, 298, 438, 579, 719, 860, 1000]
    (q, kp, vp, pt, sl), got, want = paged_case(lens, 32, 32, 128, 128)
    err, ratio = close(got, want, 2e-2)
    check(ratio <= 1.0, f"paged_attention full width: max_abs_err {err}, "
          f"{ratio} x tol")
    Hkv, D = kp.shape[2], kp.shape[3]
    live = sum(lens)
    nbytes = (2 * (q.numel() + got.numel()) + 2 * live * Hkv * (D + D)
              + 4 * (len(lens) + sum(-(-n // 16) for n in lens)))
    b_ms, b_by = bound(nbytes, live * q.shape[1] * 2 * (D + D))
    out["paged_attention"] = {
        "shape": {"lens": lens, "Hq": 32, "Hkv": 32, "D": 128, "page": 16},
        "max_err": err, "rtol": 2e-2, "err_over_tol": ratio,
        "kernel_ms": time_ms(lambda: paged_attention_cuda(q, kp, vp, pt, sl)),
        "plain_ms": time_ms(lambda: paged_attention_torch(q, kp, vp, pt, sl)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    del q, kp, vp, pt, sl, got, want
    for name, args, kw2 in [
            ("empty_and_len1_slots", ([0, 1, 16, 17], 8, 8, 128, 128), {}),
            ("poisoned_trash_page", ([5, 33, 64], 4, 4, 128, 128),
             dict(poison_trash=True, maxp=8)),
            ("gqa_g4_dv_ne_d", ([40, 300], 8, 2, 128, 64), {}),
            # starcoder2_15b's group (48 / 4 = 12 runs as 2 chunks of 6)
            # and yi_34b's (56 / 8 = 7)
            ("gqa_g12_two_chunks", ([40, 300, 1], 48, 4, 128, 128), {}),
            ("gqa_g7", ([33, 200], 56, 8, 128, 128), {}),
            ("f32_g8", ([9, 100, 31], 8, 1, 64, 64),
             dict(dtype=torch.float32, page=8, maxp=16))]:
        _, got, want = paged_case(*args, **kw2)
        rel = 1e-4 if kw2.get("dtype") == torch.float32 else 2e-2
        edge("paged_attention", name, got, want, rel)
        if name == "empty_and_len1_slots":
            check(bool((got[0] == 0).all()), "paged: empty slot is not 0")

    emit("kernels", launches=counts(), full_width=out, edge_cases=edges)
    return out


def phase_serve_dense(device="cuda", smoke=False):
    """The dense data plane through the launcher's entry point."""
    from repro_torch.launch import serve
    from repro_torch.models import model
    argv = ["--arch", "deepseek_7b", "--batch", "4", "--prompt-len", "512",
            "--gen", "32", "--seed", "0", "--device", device]
    if smoke:
        argv = argv[:2] + ["--smoke", "--batch", "2", "--prompt-len", "24",
                           "--gen", "6", "--device", device]
    args = serve.parse_args(argv)
    set_counts({n: 0 for n in KERNEL_META})
    res = serve.run(args)
    launches = counts()
    rt, cfg = res["runtime"], res["cfg"]
    B, P, G = args.batch, args.prompt_len, args.gen
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
    out = {"arch": cfg.name, "batch": B, "prompt_len": P, "gen": G,
           "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
           "prefill_tok_s": B * P / res["prefill_s"],
           "decode_tok_s": B * (G - 1) / res["decode_s"],
           "launches": launches,
           "logits_check": chk}
    if rt.device.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        # warm: the timed run above includes first-call costs (cuBLAS
        # handles and heuristics, lazy module loading)
        cache = model.init_cache(cfg, B, P, rt.device)
        out["warm_prefill"] = profile_steps(
            lambda: model.prefill(params, cfg, {"tokens": tokens}, cache), 2)
        rt.prefill({"tokens": tokens})         # cache_len back to P
        out["warm_decode_step"] = profile_steps(rt.step, 3)
    emit("serve_dense", **out)
    return out


def phase_serve_paged(device="cuda", smoke=False):
    """The paged data plane: 12 generate sessions through 8 slots."""
    import repro_torch.configs as configs
    from repro_torch.core.block import BlockGrant
    from repro_torch.core.runtime import BlockRuntime, JobSpec
    from repro_torch.data import pipeline
    from repro_torch.models import model
    from repro_torch.models.config import ShapeConfig
    cfg = (configs.get_smoke("deepseek_7b") if smoke
           else configs.get("deepseek_7b"))
    max_seq, max_new, n_sess, longest = ((64, 6, 5, 40) if smoke
                                         else (1024, 32, 12, 700))
    job = JobSpec(cfg, ShapeConfig("smoke", "serve", seq_len=max_seq,
                                   global_batch=1), kind="serve", seed=0,
                  paged=True, page_size=16, max_slots=8,
                  max_seq_len=max_seq)
    rt = BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 3600.0), job,
                      devices=[device])
    rt.init_state()
    sch = rt.sessions
    toks = pipeline.synthetic_batch(
        cfg, ShapeConfig("p", "prefill", longest, n_sess), step=1,
        seed=0)["tokens"]
    lens = np.linspace(17, longest, n_sess).astype(int)
    prompts = [toks[i, :n].tolist() for i, n in enumerate(lens)]

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
    set_counts({n: 0 for n in KERNEL_META})
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
    launches = counts()
    rounds = tap["rounds"]
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
    ttft = np.asarray([first_t[s] - submit_t[s] for s in submit_t])
    out = {"arch": cfg.name, "sessions": n_sess, "slots": 8,
           "prompt_lens": lens.tolist(), "max_new_tokens": max_new,
           "n_pages": sch.n_pages, "decode_rounds": rounds,
           "admissions": sch.admissions, "evictions": sch.evictions,
           "elapsed_s": elapsed, "tokens": n_tokens,
           "tok_s": n_tokens / elapsed,
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_p99_s": float(np.percentile(ttft, 99)),
           "launches": launches, "logits_check": chk,
           "admission_logits_checks": admits}
    if rt.device.type == "cuda":
        out["pool_gb"] = sum(v.numel() * v.element_size()
                             for v in sch.pool.values()) / 1e9
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        # a warm decode round with all 8 slots busy (after their admission)
        for p in prompts[:8]:
            rt.start_session(p, max_new_tokens=max_new)
        rt.feed()
        out["warm_decode_round"] = profile_steps(rt.feed, 3)
    emit("serve_paged", **out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repository)

    info = phase_device()
    phase_build()
    kern = phase_kernels()
    torch.cuda.empty_cache()
    dense = phase_serve_dense()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    paged = phase_serve_paged()

    nl = dense["launches"]
    check(nl["flash_attention"] >= 30 and nl["rmsnorm"] >= 61,
          f"dense path launches {nl}")
    pl = paged["launches"]
    check(pl["paged_attention"] >= 30 * paged["decode_rounds"] > 0
          and pl["flash_attention"] >= 30 * paged["admissions"]
          and pl["rmsnorm"] > 0, f"paged path launches {pl}")

    rows = []
    for name, meta in KERNEL_META.items():
        k = kern[name]
        rows.append({"name": name, "route": "cuda", **meta,
                     "launches": nl[name] + pl[name],
                     "max_abs_err": k["max_err"], "ms": k["kernel_ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"],
                     "launches_dense": nl[name],
                     "launches_paged": pl[name], "shape": k["shape"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
