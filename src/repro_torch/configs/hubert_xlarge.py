"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 —
encoder-only (wav2vec2 architecture), masked cluster prediction.
The conv waveform frontend is a STUB per the assignment: ``input_specs()``
delivers precomputed frame embeddings (T x 1280).  [arXiv:2106.07447; unverified]
"""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="hubert_xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    vocab_size=504,
    d_ff=5120,
    attention=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=80,
                              causal=False),
    norm="layer",
    act="gelu",
    mlp_gated=False,
    frontend="frame",
    frontend_dim=1280,
    is_encoder=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert_xlarge_smoke",
        family="encoder",
        n_layers=3,
        d_model=64,
        vocab_size=32,
        d_ff=128,
        attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                                  causal=False),
        norm="layer",
        act="gelu",
        mlp_gated=False,
        frontend="frame",
        frontend_dim=64,
        is_encoder=True,
    )
