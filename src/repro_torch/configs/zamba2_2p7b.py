"""zamba2-2.7b [hybrid] — 54L d_model=2560 ssm_state=64, Mamba2 backbone with
a weight-SHARED attention(32H kv=32)+MLP(d_ff=10240) block applied once per
group of 5 Mamba2 blocks (9 applications, one parameter set — Zamba2's
shared-block design).  vocab=32000.  [arXiv:2411.15242; hf]
"""
from repro_torch.models.config import (AttentionConfig, HybridConfig,
                                       ModelConfig, SSMConfig)

CONFIG = ModelConfig(
    name="zamba2_2p7b",
    family="hybrid",
    n_layers=54,                   # 54 = 9 groups x (5 mamba + 1 shared attn)
    d_model=2560,
    vocab_size=32_000,
    d_ff=10_240,                   # shared block MLP width
    attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=80,
                              rope_theta=10_000.0),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=256),
    hybrid=HybridConfig(mamba_per_group=5),
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2_2p7b_smoke",
        family="hybrid",
        n_layers=6,
        d_model=64,
        vocab_size=256,
        d_ff=128,
        attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16),
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk=16),
        hybrid=HybridConfig(mamba_per_group=2),
        tie_embeddings=True,
    )
