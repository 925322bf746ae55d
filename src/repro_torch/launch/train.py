"""Training launcher: one train block, real execution (the port of
``repro.launch.train``).

Until the control plane is ported, the launcher grants itself a one-chip
block and drives ``BlockRuntime.step`` directly; the reference goes
through ``ClusterDaemon``.  Its checkpoint flags (``--ckpt-*``,
``--resume``) and the daemon's ``--autostep``/``--pace`` come with the
checkpoint and control-plane slices.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_7b \\
      --smoke --steps 20 --seq-len 64 --global-batch 4 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import repro_torch.configs as configs
from repro_torch.core.block import BlockGrant
from repro_torch.core.runtime import BlockRuntime, JobSpec
from repro_torch.models import model as model_lib
from repro_torch.models.config import ShapeConfig
from repro_torch.train import optimizer as opt_lib


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Train ``--steps`` steps; returns the runtime, each step's metrics
    and the wall time of the loop."""
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    shape = ShapeConfig("cli", "train", seq_len=args.seq_len,
                        global_batch=args.global_batch,
                        microbatch=args.microbatch)
    opt_cfg = opt_lib.OptConfig(lr=args.lr,
                                warmup_steps=max(args.steps // 20, 1),
                                total_steps=args.steps)
    grant = BlockGrant.new([(0, 0, 0)], (1, 1), duration_s=3600.0)
    job = JobSpec(cfg, shape, kind="train", opt=opt_cfg, seed=args.seed,
                  collect_metrics=True)
    rt = BlockRuntime(grant, job, devices=[args.device])
    rt.init_state()
    n_params = model_lib.count_params(rt.state["params"])
    print(f"# arch={cfg.name} params={n_params/1e6:.2f}M "
          f"device={rt.device} block={grant.block_id} "
          f"tokens/step={shape.global_batch * shape.seq_len}", flush=True)

    history = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        m = rt.step()
        history.append(m)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {m['loss']:8.4f} "
                  f"gnorm {m['grad_norm']:8.3f} lr {m['lr']:.2e}",
                  flush=True)
    wall = time.perf_counter() - t0
    return {"cfg": cfg, "shape": shape, "runtime": rt, "grant": grant,
            "history": history, "wall_s": wall}


def main(argv=None) -> int:
    args = parse_args(argv)
    res = run(args)
    shape, hist, wall = res["shape"], res["history"], res["wall_s"]
    tok_s = args.steps * shape.global_batch * shape.seq_len / max(wall, 1e-9)
    span = (f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}"
            if hist else "loss n/a")
    print(f"# done: {wall:.1f}s, {tok_s:.0f} tok/s, {span}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
