"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6 — kimi/moonlight
[hf:moonshotai/Moonlight-16B-A3B]."""

import dataclasses

from repro_torch.configs.base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    moe=MoESpec(num_experts=64, top_k=6),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=48,
        vocab=512, moe=MoESpec(num_experts=4, top_k=2), dtype="float32",
    )
