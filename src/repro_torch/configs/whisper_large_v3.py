"""whisper-large-v3 [audio]: enc-dec, 32 enc + 32 dec layers, d_model=1280,
20H, d_ff=5120, vocab=51866 [arXiv:2212.04356]. The conv/mel frontend is a
STUB: input_specs() provides precomputed frame embeddings [B, 1500, 1280].
Full attention → long_500k skipped."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    enc_layers=32,
    enc_len=1500,
    norm="layernorm",
    act="gelu",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, enc_len=12, dtype="float32",
    )
