"""yi-34b [dense] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 —
llama architecture with GQA.  [arXiv:2403.04652; hf]
"""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="yi_34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    vocab_size=64_000,
    d_ff=20_480,
    attention=AttentionConfig(n_heads=56, n_kv_heads=8, head_dim=128,
                              rope_theta=5_000_000.0),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi_34b_smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        vocab_size=256,
        d_ff=192,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
    )
