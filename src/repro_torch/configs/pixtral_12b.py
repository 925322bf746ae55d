"""pixtral-12b [vlm] — mistral-nemo-12b text backbone (40L d_model=5120 32H
GQA kv=8 d_ff=14336 vocab=131072) + pixtral-ViT patch frontend.
The vision tower is a STUB per the assignment: ``input_specs()`` delivers
precomputed patch embeddings (n_patches x 1024) which a learned projection
maps into the backbone.  [hf:mistralai/Pixtral-12B-2409; unverified]
"""
from repro_torch.models.config import AttentionConfig, ModelConfig

N_PATCHES = 256          # image tokens occupying the sequence prefix
PATCH_DIM = 1024         # pixtral ViT hidden size delivered by the stub

CONFIG = ModelConfig(
    name="pixtral_12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    vocab_size=131_072,
    d_ff=14_336,
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                              rope_theta=1_000_000.0),
    frontend="patch",
    frontend_dim=PATCH_DIM,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral_12b_smoke",
        family="vlm",
        n_layers=3,
        d_model=64,
        vocab_size=256,
        d_ff=192,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
        frontend="patch",
        frontend_dim=32,
    )
