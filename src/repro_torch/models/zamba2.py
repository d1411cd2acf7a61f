"""Zamba2 hybrid: Mamba2 blocks + one *shared* attention block applied
every ``attn_every`` blocks.

Port of ``repro/models/zamba2.py``. The shared block is a full GQA
transformer block (attention + gated MLP, ``transformer.apply_block``) with
the same weights at every site; when decoding, each site keeps its own KV
cache under ``attn_{i}``. The token embedding is a plain gather (no √d
scale) and the head is tied to it (``transformer.embed_tokens`` and
``unembed``, which also split them over a model group). Under a serve
table's model group the decode step keeps each Mamba2 state whole on every
rank (``mamba2.ssd_decode_tp``) and splits each site's KV cache.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.models import mamba2, transformer
from repro_torch.models.common import (apply_norm, embed_init, init_norm, norm_axes, norm_shapes,
                                       remat_call)


def attn_sites(cfg) -> list[int]:
    period = max(cfg.attn_every, 1)
    return [i for i in range(cfg.n_layers) if (i + 1) % period == 0]


def init_zamba2(gen, cfg, dtype=torch.bfloat16, device="cuda", place=None):
    """The parameter tree, drawn in the reference's order; ``place(key,
    subtree)`` as in ``transformer.init_lm``."""
    place = place or (lambda key, tree: tree)
    p = {
        "embed": place("embed", embed_init(gen, (cfg.vocab, cfg.d_model), dtype, device)),
        "ln_f": place("ln_f", init_norm(cfg.d_model, cfg.norm, device)),
        "shared": place("shared", transformer.init_block(gen, cfg, dtype, device)),
    }
    for i in range(cfg.n_layers):
        p[f"ssm_{i}"] = place(f"ssm_{i}", mamba2.init_mamba2(gen, cfg, dtype, device))
    return p


def param_shapes(cfg) -> dict:
    """The shape of every leaf :func:`init_zamba2` makes."""
    out = {"embed": (cfg.vocab, cfg.d_model), "ln_f": norm_shapes(cfg.d_model, cfg.norm),
           "shared": transformer.block_shapes(cfg)}
    out.update({f"ssm_{i}": mamba2.param_shapes(cfg) for i in range(cfg.n_layers)})
    return out


def param_axes(cfg) -> dict:
    """The logical axes of every leaf :func:`init_zamba2` makes."""
    out = {"embed": ("vocab", "embed"), "ln_f": norm_axes(cfg.norm),
           "shared": transformer.block_axes(cfg)}
    out.update({f"ssm_{i}": mamba2.param_axes(cfg) for i in range(cfg.n_layers)})
    return out


def _logits(params, h, cfg, tp=None):
    h = apply_norm(params["ln_f"], h, cfg.norm, cfg.norm_eps)
    return transformer.unembed(params, h, cfg, tp)


def forward(params, tokens, cfg, *, last_only: bool = False, remat: bool = False, tp=None):
    """``remat``: each Mamba2 block and each shared-block site under
    ``torch.utils.checkpoint``. ``tp``: the model group (``params`` then
    this rank's view of the stored leaves): the embedding and the tied head
    vocab-parallel (the logits this rank's vocab part), the Mamba2 blocks
    head-parallel (``mamba2.ssd_forward_tp``), the shared block's attention
    and MLP split as the dense family's."""
    h = transformer.embed_tokens(params, tokens, cfg, tp)
    sites = set(attn_sites(cfg))
    ssm = functools.partial(mamba2.ssd_forward, cfg=cfg, tp=tp)
    blk = functools.partial(transformer.apply_block, cfg=cfg, tp=tp)
    for i in range(cfg.n_layers):
        h = remat_call(ssm, remat, params[f"ssm_{i}"], h)
        if i in sites:
            h, _ = remat_call(blk, remat, params["shared"], h)
    if last_only:
        h = h[:, -1:]
    return _logits(params, h, cfg, tp), {}


def decode_step(params, token, cache, pos, cfg, tp=None, kv_len=None):
    """One-token decode. ``tp``: a serve table's model group (``params``
    this rank's stored leaves, ``cache`` its shard of a ``kv_len``-position
    cache): the embedding and the tied head vocab-parallel, each Mamba2
    block through ``mamba2.ssd_decode_tp`` (its state whole on every rank),
    the shared block's sites as the dense family's decode (each site's KV
    cache split by ``transformer.kv_split``); every rank returns the whole
    logits."""
    h = transformer.embed_tokens(params, token[:, None], cfg, tp)
    split = None if tp is None else transformer.kv_split(cfg, tp, kv_len)
    sites = set(attn_sites(cfg))
    new_cache = {}
    for i in range(cfg.n_layers):
        h, new_cache[f"ssm_{i}"] = mamba2.ssd_decode(params[f"ssm_{i}"], h, cfg,
                                                      cache[f"ssm_{i}"], tp)
        if i in sites:
            h, new_cache[f"attn_{i}"] = transformer.apply_block_decode(
                params["shared"], h, cfg, cache[f"attn_{i}"], pos, tp=tp, kv_split=split)
    return transformer.whole_logits(_logits(params, h, cfg, tp)[:, 0], cfg, tp), new_cache


def cache_axes(cfg) -> dict:
    """The logical axes of every leaf :func:`init_cache` makes."""
    axes = {f"ssm_{i}": dict(mamba2.SSM_STATE_AXES) for i in range(cfg.n_layers)}
    axes.update({f"attn_{i}": dict(transformer.KV_AXES) for i in attn_sites(cfg)})
    return axes


def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16, device="cuda"):
    c = {f"ssm_{i}": mamba2.init_ssm_state(cfg, batch, dtype, device)
         for i in range(cfg.n_layers)}
    shape = (batch, seq_len, cfg.n_kv_heads, cfg.hd)
    for i in attn_sites(cfg):
        c[f"attn_{i}"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)}
    return c
