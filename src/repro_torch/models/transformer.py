"""Dense / MoE decoder-only transformer (gemma, deepseek, qwen, danube,
granite, moonshot).

Port of ``repro/models/transformer.py``: pre-norm attention and gated MLP
or MoE blocks with residuals, a python loop over the layers, tied or untied
unembedding, and the one-token decode step over a per-layer KV cache. An
MoE model's forward returns the mean of its layers' load-balance losses as
``moe_aux``; a dense model's returns no aux.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import apply_mlp, apply_norm, embed_init, init_mlp, init_norm


def init_block(gen, cfg, dtype=torch.bfloat16, device="cuda"):
    p = {
        "ln1": init_norm(cfg.d_model, cfg.norm, device),
        "attn": attn.init_attention(gen, cfg, dtype=dtype, device=device),
        "ln2": init_norm(cfg.d_model, cfg.norm, device),
    }
    if cfg.moe is not None:
        p["moe"] = moe_lib.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def _ffn(p, h, cfg):
    """The block's MoE or MLP half: (y, aux)."""
    if "moe" in p:
        return moe_lib.apply_moe(p["moe"], h, cfg)
    return apply_mlp(p["mlp"], h, cfg.act), {}


def apply_block(p, x, cfg, *, window=None):
    """Train/prefill block: pre-norm attention + (MoE|MLP), residual."""
    h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
    x = x + attn.attention(p["attn"], h, cfg, window=window)
    h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
    y, aux = _ffn(p, h, cfg)
    return x + y, aux


def apply_block_decode(p, x, cfg, cache, pos, *, window=None):
    """One-token decode block. cache = {"k": [B,T,K,hd], "v": ...}, updated in place."""
    h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
    a, new_k, new_v = attn.attention_decode(p["attn"], h, cfg, cache["k"], cache["v"], pos,
                                            window=window)
    x = x + a
    h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
    x = x + _ffn(p, h, cfg)[0]
    return x, {"k": new_k, "v": new_v}


def init_lm(gen, cfg, dtype=torch.bfloat16, device="cuda"):
    p = {
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dtype, device),
        "ln_f": init_norm(cfg.d_model, cfg.norm, device),
    }
    for i in range(cfg.n_layers):
        p[f"layer_{i}"] = init_block(gen, cfg, dtype, device)
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, (cfg.vocab, cfg.d_model), dtype, device)
    return p


def param_shapes(cfg) -> dict:
    """The shape of every leaf :func:`init_lm` makes, in the same tree."""
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    norm = {"scale": (d,)} if cfg.norm == "rmsnorm" else {"scale": (d,), "bias": (d,)}
    att = {"wq": (d, h, hd), "wk": (d, k, hd), "wv": (d, k, hd), "wo": (h, hd, d)}
    if cfg.qkv_bias:
        att.update(bq=(h, hd), bk=(k, hd), bv=(k, hd))
    block = {"ln1": norm, "attn": att, "ln2": norm}
    if cfg.moe is not None:
        block["moe"] = moe_lib.moe_param_shapes(cfg)
    else:
        block["mlp"] = {"wi": (d, cfg.d_ff), "wg": (d, cfg.d_ff), "wo": (cfg.d_ff, d)}
    out = {"embed": (cfg.vocab, d), "ln_f": norm}
    out.update({f"layer_{i}": block for i in range(cfg.n_layers)})
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.vocab, d)
    return out


def _window(cfg, i: int):
    return cfg.swa_window  # uniform SWA (danube); None = full attention


def embed_tokens(params, tokens, cfg):
    h = params["embed"][tokens]
    if cfg.embed_scale:
        scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32))
        h = h * scale.to(h.dtype).to(h.device)
    return h


def unembed(params, h, cfg):
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(h, table.t()).float()  # the product in the working type, then f32


def forward(params, tokens, cfg, *, last_only: bool = False):
    """Token logits for train/prefill; ``last_only`` keeps the last position.
    The aux: ``{"moe_aux": mean over layers}`` for an MoE model, else ``{}``."""
    h = embed_tokens(params, tokens, cfg)
    aux_tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_layers):
        h, aux = apply_block(params[f"layer_{i}"], h, cfg, window=_window(cfg, i))
        if "moe_aux" in aux:
            aux_tot = aux_tot + aux["moe_aux"]
    h = apply_norm(params["ln_f"], h, cfg.norm, cfg.norm_eps)
    if last_only:  # prefill: only the last position's logits are served
        h = h[:, -1:]
    out = {"moe_aux": aux_tot / max(cfg.n_layers, 1)} if cfg.moe is not None else {}
    return unembed(params, h, cfg), out


def decode_step(params, token, cache, pos, cfg):
    """token: [B] int; cache: {"layer_i": {"k","v"}}; pos: scalar or [B]."""
    h = embed_tokens(params, token[:, None], cfg)
    new_cache = {}
    for i in range(cfg.n_layers):
        h, c = apply_block_decode(params[f"layer_{i}"], h, cfg, cache[f"layer_{i}"], pos,
                                  window=_window(cfg, i))
        new_cache[f"layer_{i}"] = c
    h = apply_norm(params["ln_f"], h, cfg.norm, cfg.norm_eps)
    return unembed(params, h, cfg)[:, 0], new_cache


def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16, device="cuda"):
    shape = (batch, seq_len, cfg.n_kv_heads, cfg.hd)
    return {f"layer_{i}": {"k": torch.zeros(shape, dtype=dtype, device=device),
                           "v": torch.zeros(shape, dtype=dtype, device=device)}
            for i in range(cfg.n_layers)}


def kv_cache_bytes(cfg, batch: int, seq_len: int, dtype=torch.bfloat16) -> int:
    elem = torch.empty((), dtype=dtype).element_size()
    return 2 * cfg.n_layers * batch * seq_len * cfg.n_kv_heads * cfg.hd * elem
