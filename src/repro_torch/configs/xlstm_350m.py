"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks, alternating 1:1 [arXiv:2405.04517; unverified]. d_ff=0: projections
live inside the xLSTM blocks (mLSTM pf=2, sLSTM GeGLU pf=4/3·2)."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="xlstm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, vocab=512,
        dtype="float32",
    )
