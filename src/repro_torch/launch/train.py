"""Training launcher: one train block, real execution (the port of
``repro.launch.train``).

Until the control plane is ported, the launcher grants itself a one-chip
block and drives ``BlockRuntime.step`` directly; the reference goes
through ``ClusterDaemon``, and its ``--autostep``/``--pace`` (the
daemon's engine stepping the block) come with the control-plane slice.

Checkpoints are client-driven, as in the reference: with ``--ckpt-dir``
the block saves asynchronously every ``--ckpt-every`` steps under the
stable namespace ``cfg.name``, and ``--resume`` restores the latest one
and trains on to ``--steps``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_7b \\
      --smoke --steps 20 --seq-len 64 --global-batch 4 [--device cpu] \\
      [--ckpt-dir DIR --ckpt-every 10 [--resume]]
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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Train to ``--steps`` (from the latest checkpoint with ``--resume``);
    returns the runtime, each step's metrics, the step the run started at,
    the wall time of the loop and the checkpoints on disk.  However the
    loop ends, an async save it started lands before ``run`` returns or
    raises."""
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
                  collect_metrics=True,
                  # stable namespace so --resume finds earlier runs
                  ckpt_namespace=cfg.name if args.ckpt_dir else None,
                  ckpt_every=args.ckpt_every if args.ckpt_dir else 0)
    rt = BlockRuntime(grant, job, devices=[args.device],
                      ckpt_root=args.ckpt_dir)
    start_step = 0
    if args.resume and args.ckpt_dir and rt.ckpt.latest_step() is not None:
        rt.restore()                 # no init: restored into meta targets
        start_step = rt.step_count
    else:
        rt.init_state()
    n_params = model_lib.count_params(rt.state["params"])
    print(f"# arch={cfg.name} params={n_params/1e6:.2f}M "
          f"device={rt.device} block={grant.block_id} "
          f"tokens/step={shape.global_batch * shape.seq_len}", flush=True)
    if start_step:
        print(f"# resumed from step {start_step}", flush=True)

    every = args.ckpt_every if args.ckpt_dir else 0
    history = []
    t0 = time.perf_counter()
    try:
        while rt.step_count < args.steps:
            for _ in range(min(every or args.steps,
                               args.steps - rt.step_count)):
                step = rt.step_count
                m = rt.step()
                history.append(m)
                if step % args.log_every == 0 or step == args.steps - 1:
                    print(f"step {step:5d} loss {m['loss']:8.4f} "
                          f"gnorm {m['grad_norm']:8.3f} lr {m['lr']:.2e}",
                          flush=True)
            if every:
                rt.save(async_=True)
        wall = time.perf_counter() - t0
    finally:
        if rt.ckpt is not None:
            rt.ckpt.wait()           # an async save may still be landing
    return {"cfg": cfg, "shape": shape, "runtime": rt, "grant": grant,
            "history": history, "start_step": start_step, "wall_s": wall,
            "checkpoints": rt.ckpt.steps() if rt.ckpt is not None else []}


def main(argv=None) -> int:
    args = parse_args(argv)
    res = run(args)
    shape, hist, wall = res["shape"], res["history"], res["wall_s"]
    tok_s = len(hist) * shape.global_batch * shape.seq_len / max(wall, 1e-9)
    span = (f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}"
            if hist else "loss n/a")
    print(f"# done: {wall:.1f}s, {tok_s:.0f} tok/s, {span}, "
          f"checkpoints={res['checkpoints']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
