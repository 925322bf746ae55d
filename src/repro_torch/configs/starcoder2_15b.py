"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE, LayerNorm, non-gated GELU MLP.
[arXiv:2402.19173; hf]
"""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2_15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    vocab_size=49_152,
    d_ff=24_576,
    attention=AttentionConfig(n_heads=48, n_kv_heads=4, head_dim=128,
                              rope_theta=100_000.0),
    norm="layer",
    act="gelu",
    mlp_gated=False,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2_15b_smoke",
        family="dense",
        n_layers=3,
        d_model=96,
        vocab_size=256,
        d_ff=384,
        attention=AttentionConfig(n_heads=6, n_kv_heads=2, head_dim=16),
        norm="layer",
        act="gelu",
        mlp_gated=False,
    )
