"""gemma-7b [dense]: 28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000
— GeGLU, head_dim=256 [arXiv:2403.08295]. Full attention → long_500k skipped
(DESIGN.md §6)."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab=256000,
    head_dim=256,
    act="gelu",
    embed_scale=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, head_dim=32, dtype="float32",
    )
