"""Serving driver: batched prefill + autoregressive decode (the port of
``repro.launch.serve``), run as a serve-kind block through the
``ClusterDaemon`` service layer (register -> admit -> activate ->
prefill -> decode steps -> download), so the launcher exercises the same
lifecycle, dispatcher and monitoring as any other tenant of the public
cluster.  The daemon's topology is one chip on ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek_7b \
      --smoke --batch 4 --prompt-len 64 --gen 32 [--device cpu]

``--arch zamba2_2p7b`` serves the hybrid family (Mamba2 + shared
attention) the same way.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np

import repro_torch.configs as configs
from repro_torch.core.daemon import ClusterDaemon
from repro_torch.core.runtime import JobSpec
from repro_torch.core.topology import Topology
from repro_torch.data import pipeline
from repro_torch.models.config import ShapeConfig


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


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Prefill a synthetic prompt batch and decode ``--gen`` tokens.
    Returns the daemon, the block's app id and runtime, the batch, the
    generated tokens (B, gen) and the prefill/decode wall times (each
    ending in a device sync)."""
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    if cfg.is_encoder:
        raise SystemExit("encoder-only arch has no decode path")
    B, P, G = args.batch, args.prompt_len, args.gen

    topo = Topology(n_pods=1, pod_x=1, pod_y=1)
    daemon = ClusterDaemon(topo, devices=[args.device],
                           ckpt_root="artifacts/serve_ckpt")
    # cache sized for prompt + generation
    job = JobSpec(cfg, ShapeConfig("cli", "serve", seq_len=P + G,
                                   global_batch=B),
                  kind="serve", seed=args.seed, decode_sample=args.sample)
    app_id, grant = daemon.submit("cli", f"serve {cfg.name}", 1, job=job)
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


def main(argv=None) -> int:
    args = parse_args(argv)
    res = run(args)
    cfg, B, P, G = res["cfg"], args.batch, args.prompt_len, args.gen
    t_prefill, t_decode = res["prefill_s"], res["decode_s"]
    print(f"# arch={cfg.name} batch={B} prompt={P} gen={G} "
          f"block={res['grant'].block_id} device={res['runtime'].device}")
    print(f"# prefill: {t_prefill*1e3:.1f} ms "
          f"({B*P/t_prefill:.0f} tok/s)")
    print(f"# decode:  {t_decode*1e3:.1f} ms "
          f"({B*(G-1)/max(t_decode,1e-9):.0f} tok/s) "
          f"steps={res['steps']}")
    print("# first generations:", res["tokens"][:2, :10].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
