"""Model API of the port: ``build_model(cfg, device)`` for the dense family.

Port of ``repro/models/api.py``'s serving half. :class:`Model` gives

    init(seed)                        → params (a dict tree of tensors)
    forward(params, batch)            → (logits, aux)           train/prefill
    prefill_step(params, batch)       → last-position logits [B, V]
    serve_step(params, batch)         → (logits [B, V], cache)   decode
    init_cache(batch, seq_len)        → decode cache (dict tree)

on the model's device (``"cuda"`` unless the caller asks for the CPU).
``loss`` and ``train_step`` come with the training slice. Only
``family == "dense"`` builds here; every other family raises
``NotImplementedError`` naming the ROADMAP Queue 1 entry that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import DTYPES

# ROADMAP Queue 1's entry for each family not ported yet.
NOT_PORTED = {
    "moe": "the MoE family (models/moe.py: granite, moonshot)",
    "hybrid": "the hybrid family (models/mamba2.py, models/zamba2.py)",
    "xlstm": "the xLSTM family (models/xlstm.py)",
    "encdec": "the encoder-decoder family (models/whisper.py, cross_attention)",
    "vlm": "the VLM family (paligemma's image prefix)",
}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init_fn: Callable  # (generator) -> params
    forward: Callable  # (params, batch, last_only=False) -> (logits, aux)
    decode: Callable  # (params, batch) -> (logits, cache)
    init_cache: Callable  # (batch, seq_len) -> cache
    # Admission seam for recurrent families: clear_slot(cache, s) zeroes slot
    # s's state; restore_slots(new, old, s) keeps slot s of ``new`` and every
    # other slot of ``old``. A KV cache needs neither (position masking).
    clear_slot: Callable | None = None
    restore_slots: Callable | None = None

    def init(self, seed: int = 0):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return self.init_fn(gen)

    def serve_step(self, params, batch):
        return self.decode(params, batch)

    def prefill_step(self, params, batch):
        """Prefill: full-sequence forward, last-position logits only."""
        logits, _ = self.forward(params, batch, last_only=True)
        return logits[:, -1]


def _dense_family(cfg: ModelConfig, dev: torch.device) -> Model:
    dtype = DTYPES[cfg.dtype]

    def fwd(params, batch, last_only=False):
        return transformer.forward(params, batch["tokens"], cfg, last_only=last_only)

    def dec(params, batch):
        return transformer.decode_step(params, batch["token"], batch["cache"], batch["pos"],
                                       cfg)

    return Model(
        cfg=cfg,
        device=dev,
        init_fn=lambda gen: transformer.init_lm(gen, cfg, dtype, dev),
        forward=fwd,
        decode=dec,
        init_cache=lambda b, s: transformer.init_cache(cfg, b, s, dtype, dev),
    )


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda") -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; ROADMAP Queue 1 lists "
            f"{NOT_PORTED.get(cfg.family, cfg.family)}")
    return _dense_family(cfg, resolve_device(device))
