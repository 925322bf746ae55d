"""deepseek-v2-236b [moe] — 60L d_model=5120 128H, MLA kv_lora=512
(q_lora=1536, qk_rope=64), d_ff_expert=1536, vocab=102400,
MoE 2 shared + 160 routed top-6.  [arXiv:2405.04434; hf]
"""
from repro_torch.models.config import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek_v2_236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    vocab_size=102_400,
    d_ff=0,                         # every layer MoE (first-layer-dense of the
                                    # HF release folded into MoE; see DESIGN.md)
    attention=AttentionConfig(n_heads=128, n_kv_heads=128, head_dim=128,
                              rope_theta=10_000.0,
                              q_lora_rank=1536, kv_lora_rank=512,
                              qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek_v2_236b_smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        d_ff=0,
        attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                                  q_lora_rank=32, kv_lora_rank=16,
                                  qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=2),
    )
