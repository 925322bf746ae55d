"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 + 1 shared, alternating
dense/MoE layers (interleave=2, Maverick layout).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.models.config import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4_maverick_400b",
    family="moe",
    n_layers=48,
    d_model=5120,
    vocab_size=202_048,
    d_ff=8192,                      # dense (non-MoE) layers' MLP width
    attention=AttentionConfig(n_heads=40, n_kv_heads=8, head_dim=128,
                              rope_theta=500_000.0),
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4_maverick_400b_smoke",
        family="moe",
        n_layers=4,
        d_model=64,
        vocab_size=256,
        d_ff=128,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=1, d_ff_expert=128, n_shared=1),
    )
