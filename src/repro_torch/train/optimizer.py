"""AdamW over bf16 params with fp32 *or* block-quantized int8 moments,
global-norm clipping and a warmup+cosine schedule (the port of
``repro.train.optimizer``).

With ``state_bits=8`` the m/v trees hold {"q": int8, "s": f32} leaves (see
``quantized_state``), cutting optimizer memory 4x; deepseek_7b's full
state fits one 80 GB card only that way.

``apply`` updates the params and the moments IN PLACE (the reference
returns new trees, which XLA donates) and returns the same objects.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.train import quantized_state as qs


@dataclasses.dataclass(frozen=True)
class OptConfig:
    """The reference's fields, so configs move across unchanged.

    ``fused`` picks ``kernels.ops.fused_adamw``'s impl ("auto", "kernel",
    "torch"); "off", the reference's composed ``_adam_leaf``, runs the
    same plain version as "torch" (``kernels.fused_adamw.fused_adamw_torch``,
    the one copy of the update's arithmetic).  ``scan_stacked`` and ``scan_min_ndim``
    are accepted and ignored: the reference's ``lax.map`` over the layer
    stack bounds the optimizer's temporaries to one layer slice, and the
    in-place kernel makes no temporaries to bound.
    """
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_bits: Optional[int] = None     # None = fp32 moments; 8 = int8
    scan_stacked: bool = True            # ignored (class docstring)
    scan_min_ndim: int = 3               # ignored (class docstring)
    fused: str = "auto"


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def _tree_map(fn, tree):
    return {k: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def init(params, cfg: Optional[OptConfig] = None) -> Dict[str, Any]:
    cfg = cfg or OptConfig()
    if cfg.state_bits == 8:
        zeros = qs.zeros_like_quantized
    else:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(iter(_leaves(params))).device
    return {"m": _tree_map(zeros, params), "v": _tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _leaves(tree, is_leaf=lambda x: False):
    """Leaves in sorted-key order (``jax.tree`` flattening's order)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) and not is_leaf(v):
            yield from _leaves(v, is_leaf)
        else:
            yield v


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(leaf.float() ** 2) for leaf in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def apply(cfg: OptConfig, params, opt_state, grads
          ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step over the whole tree, in place; returns (params,
    opt_state, {"grad_norm", "lr"}) with the metrics as 0-d tensors."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    stepf = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, stepf)
    bc2 = 1.0 - torch.pow(cfg.b2, stepf)

    is_state_leaf = ((lambda x: "q" in x) if cfg.state_bits == 8
                     else (lambda x: False))
    flat = zip(_leaves(params), _leaves(grads),
               _leaves(opt_state["m"], is_state_leaf),
               _leaves(opt_state["v"], is_state_leaf))
    impl = "torch" if cfg.fused == "off" else cfg.fused
    for p, g, m, v in flat:
        ops.fused_adamw(p, g, m, v, lr=lr, scale=scale, bc1=bc1, bc2=bc2,
                        b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                        weight_decay=cfg.weight_decay, impl=impl)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
