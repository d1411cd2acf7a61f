"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base].
The assignment line says 40e top-8 (source comment says 32e) — we follow the
spec line. 40 experts are padded to 48 for the 16-way EP axis (router masks
the 8 dead experts)."""

import dataclasses

from repro_torch.configs.base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    moe=MoESpec(num_experts=40, top_k=8, padded_experts=48),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
        vocab=512, moe=MoESpec(num_experts=5, top_k=2, padded_experts=6),
        dtype="float32",
    )
