"""The phases of ``chip_smoke.py`` that put the last reference configs on
the card, alone: ``device``, ``build``, then ``serve_llama4``,
``serve_llama4_paged``, ``serve_dense_groups`` and ``train_vlm`` (or
the phases named as arguments, ``kernels`` among them), each checking
and printing its JSON line as ``chip_smoke.py`` does; a phase that
fails is named and the next one runs.  The last line gives each
phase's seconds and the failures.  Every line is also written whole to
``build/config_phases.jsonl``.

Run from the root of a tree, on a machine with one card:

    python3 benchmarks/config_phases.py [kernels] [serve_llama4] ...
"""
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402

PHASES = ("serve_llama4", "serve_llama4_paged", "serve_dense_groups",
          "train_vlm")


def main(argv) -> int:
    if not cs.torch.cuda.is_available():
        print("config_phases: CUDA is not available", file=sys.stderr)
        return 2
    names = argv or PHASES
    # every line whole, the build's ptxas lines among them (a terminal's
    # tail keeps the last few)
    out = os.path.join(cs.ROOT, "build")
    os.makedirs(out, exist_ok=True)
    cs._RECORD = open(os.path.join(out, "config_phases.jsonl"), "w")
    info = cs.phase_device()
    cs.phase_build()
    seconds, failed = {}, {}
    for name in names:
        cs.progress(name)
        t0 = time.perf_counter()
        try:
            getattr(cs, f"phase_{name}")()
        except (SystemExit, Exception) as e:    # the next phase runs
            failed[name] = repr(e)[:2000]
            traceback.print_exc()
        seconds[name] = time.perf_counter() - t0
        cs._free()
    line = json.dumps({"card": info["nvidia_smi"], "phase_s": seconds,
                       "failed": failed})
    print(line, flush=True)
    cs._RECORD.write(line + "\n")
    cs._RECORD.close()
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
