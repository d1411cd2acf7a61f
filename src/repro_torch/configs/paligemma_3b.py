"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216
— SigLIP frontend (STUB: input_specs() provides patch embeddings
[B, 256, 1152]) + gemma backbone [arXiv:2407.07726]. Full attention →
long_500k skipped."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257216,
    act="gelu",
    embed_scale=True,
    img_tokens=256,
    img_dim=1152,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab=512, img_tokens=8, img_dim=48, dtype="float32",
    )
