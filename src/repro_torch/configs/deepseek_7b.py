"""deepseek-7b [dense] — 30L d_model=4096 32H (MHA kv=32) d_ff=11008
vocab=102400 — llama architecture.  [arXiv:2401.02954; hf]
"""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek_7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    vocab_size=102_400,
    d_ff=11_008,
    attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=128,
                              rope_theta=10_000.0),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek_7b_smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        vocab_size=256,
        d_ff=192,
        attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16),
    )
