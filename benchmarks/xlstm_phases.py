"""The phases of ``chip_smoke.py`` that run xlstm_350m, alone: ``device``,
``build``, ``serve_xlstm``, ``train_xlstm`` and ``xlstm_sharded`` (the
family through the sharded runtime at (1, 1), held bit for bit to the
two before it), each checking and printing its JSON line as
``chip_smoke.py`` does.  The last line sums up the sharded runs against
the unsharded ones: train step and host enqueue, replay, peak memory
and the phase's seconds.  Every line is also written whole to
``build/xlstm_phases.jsonl``.

Run from the root of a tree, on a machine with one card:

    python3 benchmarks/xlstm_phases.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not cs.torch.cuda.is_available():
        print("xlstm_phases: CUDA is not available", file=sys.stderr)
        return 2
    info = cs.phase_device()
    cs.phase_build()
    # every line whole (a terminal's tail keeps the last few)
    out = os.path.join(cs.ROOT, "build")
    os.makedirs(out, exist_ok=True)
    cs._RECORD = open(os.path.join(out, "xlstm_phases.jsonl"), "w")
    cs.progress("serve_xlstm")
    serve = cs.phase_serve_xlstm()
    cs._free()
    train = cs.phase_train_xlstm()
    cs._free()
    cs.progress("xlstm_sharded")
    t0 = time.perf_counter()
    sharded = cs.phase_xlstm_sharded(serve=serve, train=train)
    phase_s = time.perf_counter() - t0
    cs._free()
    s, t = sharded["serve"], sharded["train"]
    print(json.dumps({
        "card": info["nvidia_smi"],
        "xlstm_sharded": {
            "phase_s": phase_s,
            "train_step_s": t["step_s"],
            "train_xlstm_step_s": t["train_xlstm_step_s"],
            "train_warm_step_s": t["warm_step_s"],
            "train_xlstm_steady_step_s": t["train_xlstm_steady_step_s"],
            "host_probe": t["host_probe"],
            "train_peak_gb": t.get("peak_mem_gb"),
            "train_xlstm_peak_gb": t.get("train_xlstm_peak_mem_gb"),
            "prefill_s": s["prefill_s"],
            "serve_xlstm_prefill_s": serve["prefill_s"],
            "replay": s.get("warm_decode_step"),
            "serve_xlstm_replay": s.get("serve_xlstm_warm_decode_step"),
            "serve_peak_gb": s.get("peak_mem_gb"),
            "serve_xlstm_peak_gb": s.get("serve_xlstm_peak_mem_gb")}}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
