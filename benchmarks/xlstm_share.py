"""xlstm_350m's warm prefill on one card, and the part of it each kind of
xLSTM block takes.

Full size (24 layers, d_model 1024), random bf16 weights from seed 0,
4 prompts of 2048 tokens (``serve_xlstm``'s job).  Prints one JSON line:
the prefill's wall time (the median of 5 warm calls, each between device
syncs), its device time (the kernels' durations summed under
``torch.profiler``, one call) and idle share, and for the mLSTM and the
sLSTM blocks (``ssm.mlstm_fwd``, ``ssm.slstm_fwd``, each call timed
between device syncs in one more prefill) their milliseconds, calls and
share of that prefill's wall time; beside them the card's name and power
limit.  It reads only ``repro_torch``'s public functions, so it runs on
any tree of the port, before or after a change.

Run from the root of a tree, on a machine with one card:

    python3 benchmarks/xlstm_share.py
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.getcwd(), "src"))

import torch  # noqa: E402

B, P = 4, 2048


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def device_ms(fn) -> float:
    """The device's kernels and copies in one call of ``fn``, summed from
    the profiler's raw events (as ``chip_smoke.profile_summary``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()
               and not e.is_hidden_event()) / 1e6


def block_share(fn, block: str) -> dict:
    """One call of ``fn`` with every ``ssm.<block>_fwd`` call timed
    between device syncs."""
    from repro_torch.models import ssm
    name = f"{block}_fwd"
    spans, orig = [], getattr(ssm, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
        return out

    setattr(ssm, name, timed)
    try:
        wall = wall_ms(fn)
    finally:
        setattr(ssm, name, orig)
    return {"wall_ms": wall, "ms": sum(spans) * 1e3, "calls": len(spans),
            "share": sum(spans) * 1e3 / wall}


def main() -> int:
    if not torch.cuda.is_available():
        print("xlstm_share: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.models import model
    cfg = configs.get("xlstm_350m")
    params = model.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                           device="cuda")
    cache = model.init_cache(cfg, B, P, "cuda")

    def prefill():
        with torch.no_grad():
            model.prefill(params, cfg, {"tokens": tokens}, cache)

    for _ in range(2):
        prefill()
    walls = sorted(wall_ms(prefill) for _ in range(5))
    dev = device_ms(prefill)
    out = {"card": card(), "arch": cfg.name, "batch": B, "prompt_len": P,
           "prefill_wall_ms": walls[2], "prefill_wall_ms_all": walls,
           "prefill_device_ms": dev,
           "idle_share": max(0.0, 1.0 - dev / walls[2])}
    for block in ("mlstm", "slstm"):
        out[block] = block_share(prefill, block)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
