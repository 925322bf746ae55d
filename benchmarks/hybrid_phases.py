"""The phases of ``chip_smoke.py`` that run the hybrid family across the
sharded runtime and a B = 1 long-context cache, and the phases they are
held to, in one process on one card: ``device``, ``build``,
``serve_hybrid``, ``train_hybrid``, ``hybrid_sharded``, ``serve_long``,
then ``train_overlap`` (with its int8 runs (a) and (b)), each checking
and printing its JSON line as ``chip_smoke.py`` does.  The last line
sums up serve_long's decode step against its bound, its peak memory
against the dry run's, and train_overlap's int8 losses of the four runs.
Every line is also written whole to ``build/hybrid_phases.jsonl``.

Run from the root of a tree, on a machine with one card:

    python3 benchmarks/hybrid_phases.py
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not cs.torch.cuda.is_available():
        print("hybrid_phases: CUDA is not available", file=sys.stderr)
        return 2
    info = cs.phase_device()
    cs.phase_build()
    # every line whole (a terminal's tail keeps the last few)
    out = os.path.join(cs.ROOT, "build")
    os.makedirs(out, exist_ok=True)
    cs._RECORD = open(os.path.join(out, "hybrid_phases.jsonl"), "w")
    cs.progress("serve_hybrid")
    serve = cs.phase_serve_hybrid()
    cs._free()
    cs.progress("train_hybrid")
    train = cs.phase_train_hybrid()
    cs._free()
    cs.progress("hybrid_sharded")
    sharded = cs.phase_hybrid_sharded(train=train, serve=serve)
    cs._free()
    cs.progress("serve_long")
    long = cs.phase_serve_long()
    cs._free()
    cs.progress("train_overlap")
    overlap = cs.phase_train_overlap()
    cs._free()
    print(json.dumps({
        "card": info["nvidia_smi"],
        "hybrid_sharded": {
            "train_steady_step_s": sharded["train"]["steady_step_s"],
            "train_hybrid_steady_step_s": train["steady_step_s"]},
        "serve_long": {k: long.get(k) for k in (
            "positions", "cut", "decode_wall_ms", "decode_device_ms",
            "decode_bound_ms", "dryrun")},
        "serve_long_peak_gb": long["sharded"].get("peak_mem_gb"),
        "train_overlap_int8_climb": overlap["int8"]["climb"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
