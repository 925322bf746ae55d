"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8, head_dim=128)
d_ff=14336 vocab=131072 — 128k ctx (rope_theta=1e6).
[hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="mistral_nemo_12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    vocab_size=131_072,
    d_ff=14_336,
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                              rope_theta=1_000_000.0),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral_nemo_12b_smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        vocab_size=256,
        d_ff=192,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
    )
