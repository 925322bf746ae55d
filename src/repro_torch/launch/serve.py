"""Serving driver: batched prefill + autoregressive decode (the port of
``repro.launch.serve``), run as a serve-kind block through the
``ClusterDaemon`` service layer (register -> admit -> activate ->
prefill -> decode steps -> download), so the launcher exercises the same
lifecycle, dispatcher and monitoring as any other tenant of the public
cluster.  The daemon's topology is one chip on ``--device`` (a chip a
rank under a process group).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek_7b \
      --smoke --batch 4 --prompt-len 64 --gen 32 [--device cpu]

``--arch zamba2_2p7b`` serves the hybrid family (Mamba2 + shared
attention) the same way, and ``--arch pixtral_12b`` the VLM: each prompt
of ``--prompt-len`` positions is the stub's image patches (up to 256, an
eighth of the prompt) followed by text tokens, so the prefill's tokens a
second count the patch positions, and decoding starts after both.
``--arch deepseek_v2_236b`` serves the moe family with MLA attention
(its absorbed decode scores against the compressed cache) and
``--arch llama4_maverick_400b`` the moe family with GQA.  ``--arch
xlstm_350m`` serves the xlstm family: its cache holds the mLSTM and
sLSTM states, not K/V, and each decode step updates them.  An encoder
(``--arch hubert_xlarge``) has no decode path and is refused.

``run(args, cfg)`` serves a config the caller made (one cut in depth,
say) with the flags' traffic; ``config(args)`` is the one the flags
name.

Under ``python -m torch.distributed.run --nproc-per-node N`` every rank
runs this launcher and its own deterministic daemon, so every rank
reaches the same grant: one serve block of N chips over every rank (a
``(data, model)`` mesh of ``mesh_shape_for(N)``), the params sharded as
the reference's plan shards them and gathered a group at a time, each
rank decoding its rows of the batch where they split over ``data`` and
its share of the heads, MLP widths, vocabulary and experts over
``model`` (item 8d; the first line gives the layout,
``launch.train.tp_line``).
``--device cpu`` runs the ranks over gloo, ``cuda`` over NCCL, one card
a rank.  Only rank 0 prints.  Without a process group the launcher is
the one-chip launcher.

  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 2 -m repro_torch.launch.serve --arch deepseek_7b \
      --smoke --device cpu
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch.distributed as dist

import repro_torch.configs as configs
from repro_torch import device as device_lib
from repro_torch.core.daemon import ClusterDaemon
from repro_torch.core.runtime import JobSpec
from repro_torch.core.topology import Topology
from repro_torch.data import pipeline
from repro_torch.launch.train import tp_line
from repro_torch.models.config import ModelConfig, ShapeConfig


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def config(args: argparse.Namespace) -> ModelConfig:
    """The config ``--arch`` (and ``--smoke``) name."""
    return (configs.get_smoke(args.arch) if args.smoke
            else configs.get(args.arch))


def run(args: argparse.Namespace,
        cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Prefill a synthetic prompt batch and decode ``--gen`` tokens, on
    ``cfg`` (``config(args)`` when None).  Returns the daemon, the block's
    app id and runtime, the batch, the generated tokens (B, gen) and the
    prefill/decode wall times (each ending in a device sync)."""
    cfg = config(args) if cfg is None else cfg
    if cfg.is_encoder:
        raise SystemExit("encoder-only arch has no decode path")
    B, P, G = args.batch, args.prompt_len, args.gen

    # one block spanning every rank (one chip without a process group)
    n = device_lib.world_size()
    devices = ([args.device] * n if device_lib.resolve(args.device).type
               != "cuda" or n == 1 else device_lib.cuda_devices())
    topo = Topology(n_pods=1, pod_x=n, pod_y=1)
    daemon = ClusterDaemon(topo, devices=devices,
                           ckpt_root="artifacts/serve_ckpt")
    # cache sized for prompt + generation
    job = JobSpec(cfg, ShapeConfig("cli", "serve", seq_len=P + G,
                                   global_batch=B),
                  kind="serve", seed=args.seed, decode_sample=args.sample)
    app_id, grant = daemon.submit("cli", f"serve {cfg.name}", n, job=job)
    assert grant is not None, "single-tenant pod must admit immediately"
    rt = daemon.runtime(app_id)

    prompt_shape = ShapeConfig("cli", "prefill", seq_len=P, global_batch=B)
    batch = {k: v for k, v in pipeline.synthetic_batch(
        cfg, prompt_shape, step=0, seed=args.seed).items() if k != "labels"}

    t0 = time.perf_counter()
    rt.prefill(batch)
    out_tokens = [rt.token.cpu().numpy()]       # device sync
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(G - 1):
        # one dispatch round per generated token so every token is
        # collected (decode is a serial chain: no parallelism is lost)
        daemon.run_steps({app_id: 1})
        out_tokens.append(rt.token.cpu().numpy())
    t_decode = time.perf_counter() - t0
    res = daemon.download(app_id)
    daemon.expire(app_id)
    return {"cfg": cfg, "runtime": rt, "batch": batch, "grant": grant,
            "daemon": daemon, "app_id": app_id,
            "tokens": np.concatenate(out_tokens, axis=1),
            "prefill_s": t_prefill, "decode_s": t_decode,
            "steps": res["steps"]}


def _log(*a) -> None:
    """Print on rank 0 only."""
    if device_lib.is_writer():
        print(*a, flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    started = "RANK" in os.environ and not dist.is_initialized()
    if started:                     # a rank of torch.distributed.run
        device_lib.init_distributed(args.device)
    try:
        res = run(args)
        cfg, B, P, G = res["cfg"], args.batch, args.prompt_len, args.gen
        t_prefill, t_decode = res["prefill_s"], res["decode_s"]
        _log(f"# arch={cfg.name} batch={B} prompt={P} gen={G} "
             f"block={res['grant'].block_id} device={res['runtime'].device} "
             f"chips={res['grant'].n_chips} "
             f"mesh={tuple(res['grant'].mesh_shape)} "
             f"{tp_line(res['runtime'])}")
        _log(f"# prefill: {t_prefill*1e3:.1f} ms "
             f"({B*P/t_prefill:.0f} tok/s)")
        _log(f"# decode:  {t_decode*1e3:.1f} ms "
             f"({B*(G-1)/max(t_decode,1e-9):.0f} tok/s) "
             f"steps={res['steps']}")
        _log("# first generations:", res["tokens"][:2, :10].tolist())
    finally:
        if started:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
