"""Model configuration dataclasses for every assigned architecture family.

A ``ModelConfig`` fully determines parameter shapes, the forward pass, and the
cache layout.  Configs are plain frozen dataclasses so they hash/compare and can
be embedded in jit static args.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    causal: bool = True
    # Sliding-window attention (0 = full).  Used to bound hybrid long-context.
    sliding_window: int = 0
    # --- Multi-head Latent Attention (DeepSeek-V2) ---
    q_lora_rank: int = 0          # 0 => dense q projection
    kv_lora_rank: int = 0         # 0 => standard GQA KV
    qk_rope_head_dim: int = 0     # decoupled RoPE dims (MLA only)
    v_head_dim: int = 0           # defaults to head_dim when 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def v_dim(self) -> int:
        return self.v_head_dim or self.head_dim


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0          # defaults to d_ff_expert when 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    @property
    def shared_ff(self) -> int:
        return self.d_ff_shared or self.d_ff_expert


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (state-space dual) block config."""
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4


@dataclass(frozen=True)
class XLSTMConfig:
    n_heads: int = 4
    proj_factor: float = 2.0      # mLSTM inner = proj_factor * d_model
    qk_factor: float = 0.5        # qk dim = qk_factor * inner
    slstm_every: int = 8          # 1 sLSTM per this many layers (rest mLSTM)
    chunk: int = 256


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: runs of Mamba2 blocks + one weight-SHARED attention block."""
    mamba_per_group: int = 5      # 5 mamba + 1 shared-attn application per group
    # shared attention block params are applied (n_layers // (mamba_per_group+1)) times


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | xlstm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    vocab_size: int
    d_ff: int                     # dense-family MLP width (0 => no MLP, e.g. xlstm)
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    hybrid: Optional[HybridConfig] = None
    norm: str = "rms"             # rms | layer
    act: str = "silu"             # silu (gated) | gelu (plain)
    mlp_gated: bool = True
    tie_embeddings: bool = False
    # Modality frontend stub: "none" | "patch" (vlm) | "frame" (audio)
    frontend: str = "none"
    frontend_dim: int = 0         # embedding dim delivered by the stub (== d_model)
    # encoder-only models have no causal mask / no decode
    is_encoder: bool = False
    # remat policy for the layer scan: "full" | "dots" | "none"
    remat: str = "full"
    logits_softcap: float = 0.0
    param_dtype: str = "bfloat16"    # bfloat16 | float32

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameter count (exact, mirrors init shapes)."""
        from repro_torch.models import model as _m
        return _m.count_params(_m.abstract_params(self))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k routed)."""
        from repro_torch.models import model as _m
        return _m.count_active_params(self)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                     # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                     # train | prefill | decode
    seq_len: int
    global_batch: int
    # decode shapes: cache holds `seq_len` tokens, one new token generated
    microbatch: int = 1           # grad-accumulation steps (train only)

    def replace(self, **kw) -> "ShapeConfig":
        return dataclasses.replace(self, **kw)


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", seq_len=4_096, global_batch=256, microbatch=8),
    ShapeConfig("prefill_32k", "prefill", seq_len=32_768, global_batch=32),
    ShapeConfig("decode_32k", "decode", seq_len=32_768, global_batch=128),
    ShapeConfig("long_500k", "decode", seq_len=524_288, global_batch=1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
