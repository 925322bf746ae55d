"""The phases of ``chip_smoke.py`` that run the sharded runtime, and the
phases they are held to, in one process on one card: ``device``,
``build``, ``serve_dense``, ``serve_paged``, ``serve_sharded``, ``train``,
``train_sharded``, each checking and printing its JSON line as
``chip_smoke.py`` does.  The last line sums up the host times the
sharded path adds beside the one-device phases': the train step's
steady time and enqueue (``host_probe``), and the dense decode's replay
wall and eager enqueue (``eager_probe``).

Run from the root of a tree, on a machine with one card:

    python3 benchmarks/sharded_phases.py

Two trees on one card, in one call (parent, change, change, parent):

    bash benchmarks/chip_smoke_ab.sh OLD NEW OUT benchmarks/sharded_phases.py
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not cs.torch.cuda.is_available():
        print("sharded_phases: CUDA is not available", file=sys.stderr)
        return 2
    info = cs.phase_device()
    cs.phase_build()
    cs.progress("serve_dense")
    dense = cs.phase_serve_dense()
    cs._free()
    cs.progress("serve_paged")
    paged = cs.phase_serve_paged()
    cs._free()
    cs.progress("serve_sharded")
    serve = cs.phase_serve_sharded(dense=dense, paged=paged)
    cs._free()
    cs.progress("train")
    train = cs.phase_train()
    cs._free()
    cs.progress("train_sharded")
    sharded = cs.phase_train_sharded(train=train)
    cs._free()
    sd = serve["dense"]
    print(json.dumps({
        "card": info["nvidia_smi"],
        "train": {"steady_step_s": train["steady_step_s"],
                  "enqueue_ms": train["host_probe"]["enqueue_ms"]},
        "train_sharded": {"steady_step_s": sharded["steady_step_s"],
                          "enqueue_ms": sharded["host_probe"]["enqueue_ms"],
                          "tp": sharded["tp"]},
        "serve_dense": {
            "replay_wall_ms": dense["warm_decode_step"]["wall_ms"],
            "eager_enqueue_ms": dense["host_probe_eager"]["enqueue_ms"]},
        "serve_sharded": {
            "replay_wall_ms": sd["warm_decode_step"]["wall_ms"],
            "eager_enqueue_ms": sd["host_probe_eager"]["enqueue_ms"],
            "tp": serve["tp"]["dense"]}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
