"""Training launcher: one train block, real execution (the port of
``repro.launch.train``), run through the ``ClusterDaemon`` service
layer: the job is registered, admitted and activated as a block (the
full paper lifecycle), stepped through the event-driven dispatcher, and
monitored through the event bus, like any tenant of the public cluster.
Nothing here builds a runtime or a grant itself.

The daemon's topology is one chip on ``--device``.  With ``--autostep``
the daemon runs in background mode and its autostep engine drives the
block to ``--steps`` (``--pace`` caps it at that many steps a second);
without it the launcher dispatches the steps itself with ``run_steps``.

Checkpoints: with ``--ckpt-dir`` the block saves asynchronously every
``--ckpt-every`` steps under the stable namespace ``cfg.name``, and
``--resume`` restores the latest one and trains on to ``--steps``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_7b \\
      --smoke --steps 20 --seq-len 64 --global-batch 4 [--device cpu] \\
      [--ckpt-dir DIR --ckpt-every 10 [--resume]] [--autostep [--pace HZ]]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import repro_torch.configs as configs
from repro_torch.core.block import BlockState
from repro_torch.core.daemon import ClusterDaemon
from repro_torch.core.runtime import JobSpec
from repro_torch.core.topology import Topology
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
    ap.add_argument("--autostep", action="store_true",
                    help="daemon-side stepping: the cluster's autostep "
                         "engine drives the block to --steps (checkpoints "
                         "included); no client step loop")
    ap.add_argument("--pace", type=float, default=None,
                    help="with --autostep: cap the engine at this many "
                         "steps/s")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Train to ``--steps`` (from the latest checkpoint with ``--resume``);
    returns the daemon, the block's app id and runtime, each step's
    metrics, the step the run started at, the wall time of the loop and
    the checkpoints on disk.  However the loop ends, an async save it
    started lands, and the daemon stops, before ``run`` returns or
    raises."""
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    shape = ShapeConfig("cli", "train", seq_len=args.seq_len,
                        global_batch=args.global_batch,
                        microbatch=args.microbatch)
    opt_cfg = opt_lib.OptConfig(lr=args.lr,
                                warmup_steps=max(args.steps // 20, 1),
                                total_steps=args.steps)
    # a one-chip block granted by the daemon (--autostep needs the
    # background pump: the engine steps from there)
    topo = Topology(n_pods=1, pod_x=1, pod_y=1)
    with ClusterDaemon(topo, devices=[args.device],
                       ckpt_root=args.ckpt_dir or "artifacts/train_ckpt",
                       background=args.autostep) as daemon:
        job = JobSpec(cfg, shape, kind="train", opt=opt_cfg, seed=args.seed,
                      collect_metrics=True,
                      # stable namespace so --resume finds earlier runs
                      ckpt_namespace=cfg.name if args.ckpt_dir else None,
                      # periodic checkpoints under autostep come from the
                      # engine (client-driven mode saves between chunks)
                      ckpt_every=args.ckpt_every if args.ckpt_dir else 0)
        app_id, grant = daemon.submit("cli", f"train {cfg.name}", 1,
                                      job=job)
        assert grant is not None, "single-tenant pod must admit immediately"
        rt = daemon.runtime(app_id)
        try:
            return _train(args, daemon, app_id, grant, rt, cfg, shape)
        finally:
            rt.ckpt.wait()           # an async save may still be landing


def _train(args, daemon, app_id, grant, rt, cfg, shape) -> Dict[str, Any]:
    n_params = model_lib.count_params(rt.state["params"])
    print(f"# arch={cfg.name} params={n_params/1e6:.2f}M "
          f"device={rt.device} block={grant.block_id} "
          f"tokens/step={shape.global_batch * shape.seq_len}", flush=True)
    start_step = 0
    if args.ckpt_dir and args.resume:
        if daemon.restore(app_id) is not None:
            start_step = rt.step_count
            print(f"# resumed from step {start_step}", flush=True)

    history = []

    def on_step(ev):
        """Event-bus monitoring: each completed step carries its metrics
        (collect_metrics=True) through the async dispatch window."""
        m = {"step_s": ev.payload["step_s"], **(ev.payload["metrics"] or {})}
        step = start_step + len(history)
        history.append(m)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {m['loss']:8.4f} "
                  f"gnorm {m['grad_norm']:8.3f} lr {m['lr']:.2e}",
                  flush=True)

    daemon.bus.subscribe(on_step, kinds={"step"})
    every = args.ckpt_every if args.ckpt_dir else 0
    t0 = time.perf_counter()
    if args.autostep:
        # daemon-side execution: arm the engine and watch; progress,
        # metrics and checkpoints all flow from the pump through the bus
        daemon.autostep_enable(app_id, until_steps=args.steps,
                               max_rate_hz=args.pace)
        while daemon.registry.get(app_id).state not in (
                BlockState.DONE, BlockState.FAILED, BlockState.EXPIRED):
            time.sleep(0.01)
        if every and rt.last_saved_step < rt.step_count:
            daemon.save(app_id, async_=True)   # final-step checkpoint
    else:
        while rt.step_count < args.steps:
            daemon.run_steps({app_id: min(every or args.steps,
                                          args.steps - rt.step_count)})
            if every:
                daemon.save(app_id, async_=True)
    wall = time.perf_counter() - t0
    rt.ckpt.wait()
    res = daemon.download(app_id)
    daemon.expire(app_id)
    return {"cfg": cfg, "shape": shape, "runtime": rt, "grant": grant,
            "daemon": daemon, "app_id": app_id, "history": history,
            "start_step": start_step, "wall_s": wall,
            "checkpoints": res["checkpoints"]}


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
