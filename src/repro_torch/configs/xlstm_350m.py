"""xlstm-350m [ssm] — 24L d_model=1024 4H vocab=50304, sLSTM + mLSTM blocks
(xLSTM[7:1]: one sLSTM per 8 blocks).  d_ff=0 (blocks carry their own
projections).  [arXiv:2405.04517; unverified]
"""
from repro_torch.models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm_350m",
    family="xlstm",
    n_layers=24,
    d_model=1024,
    vocab_size=50_304,
    d_ff=0,
    xlstm=XLSTMConfig(n_heads=4, proj_factor=2.0, qk_factor=0.5,
                      slstm_every=8, chunk=256),
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm_350m_smoke",
        family="xlstm",
        n_layers=4,
        d_model=64,
        vocab_size=256,
        d_ff=0,
        xlstm=XLSTMConfig(n_heads=2, proj_factor=2.0, qk_factor=0.5,
                          slstm_every=2, chunk=16),
        tie_embeddings=True,
    )
