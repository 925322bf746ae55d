"""The phases of ``chip_smoke.py`` that run deepseek_v2_236b (MLA) through
the sharded runtime and on a B = 1 long-context cache, and the phases
they are held to, in one process on one card: ``device``, ``build``,
``serve_moe``, ``train_moe``, ``moe_sharded``, ``serve_long_mla``, then
``serve_long`` (the hybrid's B = 1 phase, on the sequence-split path at
one data rank), each checking and printing its JSON line as
``chip_smoke.py`` does.  The last line sums up the sharded runs against
the unsharded ones, the long phases' decode steps against their bounds
and their peak memory against the dry runs'.  Every line is also written
whole to ``build/mla_phases.jsonl``.

Run from the root of a tree, on a machine with one card:

    python3 benchmarks/mla_phases.py
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402


def _long(run):
    return {"positions": run["positions"], "cut": run["cut"],
            "seq_split": run["sharded"]["seq_split"],
            "decode_wall_ms": run.get("decode_wall_ms"),
            "decode_device_ms": run.get("decode_device_ms"),
            "decode_bound_ms": run["decode_bound_ms"],
            "prefill_s": run["sharded"]["prefill_s"],
            "peak_gb": run["sharded"].get("peak_mem_gb"),
            "dryrun": run["dryrun"]}


def main() -> int:
    if not cs.torch.cuda.is_available():
        print("mla_phases: CUDA is not available", file=sys.stderr)
        return 2
    info = cs.phase_device()
    cs.phase_build()
    # every line whole (a terminal's tail keeps the last few)
    out = os.path.join(cs.ROOT, "build")
    os.makedirs(out, exist_ok=True)
    cs._RECORD = open(os.path.join(out, "mla_phases.jsonl"), "w")
    cs.progress("serve_moe")
    serve = cs.phase_serve_moe()
    cs._free()
    cs.progress("train_moe")
    train = cs.phase_train_moe()
    cs._free()
    cs.progress("moe_sharded")
    sharded = cs.phase_moe_sharded(serve=serve, train=train)
    cs._free()
    cs.progress("serve_long_mla")
    long_mla = cs.phase_serve_long_mla()
    cs._free()
    cs.progress("serve_long")
    long = cs.phase_serve_long()
    cs._free()
    s, t = sharded["serve"], sharded["train"]
    print(json.dumps({
        "card": info["nvidia_smi"],
        "moe_sharded": {
            "train_steady_step_s": t["steady_step_s"],
            "train_moe_steady_step_s": t["train_moe_steady_step_s"],
            "host_probe": t["host_probe"],
            "train_moe_host_probe": t["train_moe_host_probe"],
            "replay": s.get("warm_decode_step"),
            "serve_moe_replay": s.get("serve_moe_warm_decode_step"),
            "serve_peak_gb": s.get("peak_mem_gb"),
            "train_peak_gb": t.get("peak_mem_gb")},
        "serve_long_mla": _long(long_mla),
        "serve_long": _long(long)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
