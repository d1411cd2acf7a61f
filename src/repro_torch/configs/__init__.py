"""Config registry: ``get_config(name)`` / ``get_smoke_config(name)``.

Port copy of ``repro/configs``: one module per architecture the reference
supports, with its ``smoke()`` reduction, plus the paper's own graph
workloads (``ssumm_paper``). Pure data; the port's model constructor
(:func:`repro_torch.models.api.build_model`) takes the dense family only.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    MoESpec,
    RunConfig,
    SHAPES,
    ShapeSpec,
    applicable_shapes,
)

ARCHS = [
    "xlstm_350m",
    "granite_moe_3b_a800m",
    "moonshot_v1_16b_a3b",
    "gemma_7b",
    "deepseek_coder_33b",
    "qwen2_5_14b",
    "h2o_danube_1_8b",
    "zamba2_7b",
    "whisper_large_v3",
    "paligemma_3b",
]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}
_ALIAS.update(
    {
        "xlstm-350m": "xlstm_350m",
        "granite-moe-3b-a800m": "granite_moe_3b_a800m",
        "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
        "gemma-7b": "gemma_7b",
        "deepseek-coder-33b": "deepseek_coder_33b",
        "qwen2.5-14b": "qwen2_5_14b",
        "h2o-danube-1.8b": "h2o_danube_1_8b",
        "zamba2-7b": "zamba2_7b",
        "whisper-large-v3": "whisper_large_v3",
        "paligemma-3b": "paligemma_3b",
    }
)


def _module(name: str):
    mod = _ALIAS.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
