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
Under a process group ``--autostep`` runs the daemon's service mode
across ranks (``core.service``): rank 0's daemon leads, in background
mode, and drives the loop below; every other rank ``follow()``s its
log.  Each rank returns its own record, the same losses on every rank
(each step's metrics as the block's first rank measured them); at
world 1 too the leader's log passes through the control group.

Under ``python -m torch.distributed.run --nproc-per-node N`` every rank
runs this launcher and, without ``--autostep``, its own deterministic
daemon, so every rank
reaches the same grant: one block of N chips over every rank (a
``(data, model)`` mesh of ``mesh_shape_for(N)``), the topology built
from the world size as the reference's launcher builds it from its
device count.  The first line gives the block's tensor-parallel layout
over ``model`` (``tp_line``: M, the heads a rank computes, what it
computes sharded and the rules that kept a part gathered whole).  ``--device cpu`` runs the ranks over gloo, ``cuda`` over
NCCL, one card a rank.  Only rank 0 prints.  Without a process group the
launcher is the one-chip launcher.

Checkpoints: with ``--ckpt-dir`` the block saves asynchronously every
``--ckpt-every`` steps under the stable namespace ``cfg.name``, and
``--resume`` restores the latest one and trains on to ``--steps``.

``--arch deepseek_v2_236b`` and ``--arch llama4_maverick_400b`` train the
moe family (the loss plus the router's aux loss), ``--arch xlstm_350m``
the xlstm family (mLSTM and sLSTM blocks).  ``run(args, cfg)``
trains a config the caller made (one cut in depth, say) with the flags'
batch and optimizer, ``run(args, cfg, state_bits=8)`` with int8 AdamW
moments; ``config(args)`` is the one the flags name.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_7b \\
      --smoke --steps 20 --seq-len 64 --global-batch 4 [--device cpu] \\
      [--ckpt-dir DIR --ckpt-every 10 [--resume]] [--autostep [--pace HZ]]
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train --arch deepseek_7b \\
      --smoke --device cpu [--autostep]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import os

import torch.distributed as dist

import repro_torch.configs as configs
from repro_torch import device as device_lib
from repro_torch.core.block import BlockState
from repro_torch.core.daemon import ClusterDaemon
from repro_torch.core.runtime import JobSpec
from repro_torch.core.service import ServiceDaemon
from repro_torch.core.topology import Topology
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig, ShapeConfig
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


def config(args: argparse.Namespace) -> ModelConfig:
    """The config ``--arch`` (and ``--smoke``) name."""
    return (configs.get_smoke(args.arch) if args.smoke
            else configs.get(args.arch))


def run(args: argparse.Namespace, cfg: Optional[ModelConfig] = None, *,
        state_bits: Optional[int] = None,
        opt: Optional[opt_lib.OptConfig] = None) -> Dict[str, Any]:
    """Train ``cfg`` (``config(args)`` when None) to ``--steps`` (from the
    latest checkpoint with ``--resume``), the AdamW moments fp32 (as the
    flags give them) or, with ``state_bits=8``, int8, or with the
    optimizer config ``opt`` the caller made; returns the daemon,
    the block's app id and runtime, each step's metrics, the step the run
    started at, the wall time of the loop and the checkpoints on disk.
    However the loop ends, an async save it started lands, and the daemon
    stops, before ``run`` returns or raises."""
    cfg = config(args) if cfg is None else cfg
    shape = ShapeConfig("cli", "train", seq_len=args.seq_len,
                        global_batch=args.global_batch,
                        microbatch=args.microbatch)
    opt_cfg = opt or opt_lib.OptConfig(
        lr=args.lr, warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps, state_bits=state_bits)
    # one block spanning every rank (one chip without a process group),
    # granted by the daemon (--autostep needs the background pump: the
    # engine steps from there; under a process group, rank 0's)
    n = device_lib.world_size()
    devices = ([args.device] * n if device_lib.resolve(args.device).type
               != "cuda" or n == 1 else device_lib.cuda_devices())
    topo = Topology(n_pods=1, pod_x=n, pod_y=1)
    service = args.autostep and dist.is_initialized()
    lead = not service or device_lib.rank() == 0
    with (ServiceDaemon if service else ClusterDaemon)(
            topo, devices=devices,
            ckpt_root=args.ckpt_dir or "artifacts/train_ckpt",
            background=args.autostep and lead) as daemon:
        if not lead:
            return _follow(daemon, cfg, shape)
        job = JobSpec(cfg, shape, kind="train", opt=opt_cfg, seed=args.seed,
                      collect_metrics=True,
                      # stable namespace so --resume finds earlier runs
                      ckpt_namespace=cfg.name if args.ckpt_dir else None,
                      # periodic checkpoints under autostep come from the
                      # engine (client-driven mode saves between chunks)
                      ckpt_every=args.ckpt_every if args.ckpt_dir else 0)
        app_id, grant = daemon.submit("cli", f"train {cfg.name}", n,
                                      job=job)
        assert grant is not None, "single-tenant pod must admit immediately"
        rt = daemon.runtime(app_id)
        try:
            return _train(args, daemon, app_id, grant, rt, cfg, shape)
        finally:
            _landed(daemon, app_id, rt)   # an async save may still land


def _landed(daemon, app_id, rt) -> None:
    """The block's async save landed: under the service mode an entry of
    the leader's log (a sharded save's ranks meet at a barrier as it
    lands), else here."""
    if isinstance(daemon, ServiceDaemon):
        daemon.wait_saves(app_id)
    else:
        rt.ckpt.wait()


def _follow(daemon, cfg, shape) -> Dict[str, Any]:
    """A rank other than 0 under ``--autostep``: rank 0's log followed to
    its end, and this rank's record of the run (the block's runtime here,
    each step's metrics from this rank's bus)."""
    history, seen = [], {}

    def on_step(ev):
        history.append({"step_s": ev.payload["step_s"],
                        **(ev.payload["metrics"] or {})})

    def on_state(ev):
        if ev.payload["state"] == "running":
            seen.setdefault("app_id", ev.app_id)
            seen.setdefault("runtime", daemon.runtime(ev.app_id))

    daemon.bus.subscribe(on_step, kinds={"step"})
    daemon.bus.subscribe(on_state, kinds={"state"})
    t0 = time.perf_counter()
    daemon.follow()
    wall = time.perf_counter() - t0
    rt = seen["runtime"]
    return {"cfg": cfg, "shape": shape, "runtime": rt,
            "grant": daemon.registry.get(seen["app_id"]).grant,
            "daemon": daemon, "app_id": seen["app_id"], "history": history,
            "start_step": rt.step_count - len(history), "wall_s": wall,
            "checkpoints": rt.ckpt.steps()}


def tp_line(rt) -> str:
    """The block's tensor-parallel layout (``plans.TPLayout.summary``),
    ``tp=None`` for a block on one device without a process group."""
    return f"tp={rt.tp.summary() if rt.tp is not None else None}"


def _log(*a) -> None:
    """Print on rank 0 only."""
    if device_lib.is_writer():
        print(*a, flush=True)


def _train(args, daemon, app_id, grant, rt, cfg, shape) -> Dict[str, Any]:
    n_params = model_lib.count_params(rt.state["params"])
    _log(f"# arch={cfg.name} params={n_params/1e6:.2f}M "
         f"device={rt.device} chips={grant.n_chips} "
         f"mesh={tuple(grant.mesh_shape)} block={grant.block_id} "
         f"tokens/step={shape.global_batch * shape.seq_len} "
         f"{tp_line(rt)}")
    start_step = 0
    if args.ckpt_dir and args.resume:
        if daemon.restore(app_id) is not None:
            start_step = rt.step_count
            _log(f"# resumed from step {start_step}")

    history = []

    def on_step(ev):
        """Event-bus monitoring: each completed step carries its metrics
        (collect_metrics=True) through the async dispatch window."""
        m = {"step_s": ev.payload["step_s"], **(ev.payload["metrics"] or {})}
        step = start_step + len(history)
        history.append(m)
        if step % args.log_every == 0 or step == args.steps - 1:
            _log(f"step {step:5d} loss {m['loss']:8.4f} "
                 f"gnorm {m['grad_norm']:8.3f} lr {m['lr']:.2e}")

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
    _landed(daemon, app_id, rt)
    res = daemon.download(app_id)
    daemon.expire(app_id)
    return {"cfg": cfg, "shape": shape, "runtime": rt, "grant": grant,
            "daemon": daemon, "app_id": app_id, "history": history,
            "start_step": start_step, "wall_s": wall,
            "checkpoints": res["checkpoints"]}


def main(argv=None) -> int:
    args = parse_args(argv)
    started = "RANK" in os.environ and not dist.is_initialized()
    if started:                     # a rank of torch.distributed.run
        device_lib.init_distributed(args.device)
    try:
        res = run(args)
        shape, hist, wall = res["shape"], res["history"], res["wall_s"]
        tok_s = (len(hist) * shape.global_batch * shape.seq_len
                 / max(wall, 1e-9))
        span = (f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}"
                if hist else "loss n/a")
        _log(f"# done: {wall:.1f}s, {tok_s:.0f} tok/s, {span}, "
             f"checkpoints={res['checkpoints']}")
    finally:
        if started:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
