"""Dense / MoE decoder-only transformer (gemma, deepseek, qwen, danube,
granite, moonshot, paligemma's backbone, zamba2's shared block).

Port of ``repro/models/transformer.py``: pre-norm attention and gated MLP
or MoE blocks with residuals, a python loop over the layers, tied or untied
unembedding, an optional embedded prefix (paligemma's image) before the
tokens, and the one-token decode step over a per-layer KV cache. An
MoE model's forward returns the mean of its layers' load-balance losses as
``moe_aux``; a dense model's returns no aux.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (MLP_AXES, apply_mlp, apply_mlp_tp, apply_norm, embed_init,
                                       init_mlp, init_norm, norm_axes, norm_shapes, remat_call)


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


def _ffn(p, h, cfg, dp=None, tp=None):
    """The block's MoE or MLP half: (y, aux); ``dp``: the MoE block's
    data-parallel group (``models/moe.py::apply_moe``); ``tp``: the model
    group (tensor parallelism)."""
    if "moe" in p:
        return moe_lib.apply_moe(p["moe"], h, cfg, dp=dp, tp=tp)
    if tp is not None:
        return apply_mlp_tp(p["mlp"], h, cfg.act, tp, cfg.d_ff), {}
    return apply_mlp(p["mlp"], h, cfg.act), {}


def apply_block(p, x, cfg, *, window=None, dp=None, tp=None):
    """Train/prefill block: pre-norm attention + (MoE|MLP), residual.
    ``tp``: the model group, over which attention, MLP and MoE split."""
    h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
    x = x + attn.attention(p["attn"], h, cfg, window=window, tp=tp)
    h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
    y, aux = _ffn(p, h, cfg, dp, tp)
    return x + y, aux


def apply_block_decode(p, x, cfg, cache, pos, *, window=None, tp=None, kv_split=None):
    """One-token decode block. cache = {"k": [B,T,K,hd], "v": ...}, updated
    in place. ``tp``: the model group (``p`` then this rank's stored
    leaves, ``cache`` its shard, split on dimension ``kv_split``;
    :func:`~repro_torch.models.attention.attention_decode_tp`)."""
    h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
    if tp is None:
        a, new_k, new_v = attn.attention_decode(p["attn"], h, cfg, cache["k"], cache["v"], pos,
                                                window=window)
    else:
        a, new_k, new_v = attn.attention_decode_tp(p["attn"], h, cfg, cache["k"], cache["v"],
                                                   pos, tp, kv_split, window=window)
    x = x + a
    h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
    x = x + _ffn(p, h, cfg, tp=tp)[0]
    return x, {"k": new_k, "v": new_v}


def init_lm(gen, cfg, dtype=torch.bfloat16, device="cuda", place=None):
    """The parameter tree, drawn in the reference's order. ``place(key,
    subtree)``, when given, takes each top-level entry as it is drawn (a
    rank's shard of it): a model that fits a device only sharded is never
    whole there."""
    place = place or (lambda key, tree: tree)
    p = {
        "embed": place("embed", embed_init(gen, (cfg.vocab, cfg.d_model), dtype, device)),
        "ln_f": place("ln_f", init_norm(cfg.d_model, cfg.norm, device)),
    }
    for i in range(cfg.n_layers):
        p[f"layer_{i}"] = place(f"layer_{i}", init_block(gen, cfg, dtype, device))
    if not cfg.tie_embeddings:
        p["lm_head"] = place("lm_head", embed_init(gen, (cfg.vocab, cfg.d_model), dtype, device))
    return p


def block_shapes(cfg) -> dict:
    """The shape of every leaf :func:`init_block` makes."""
    d = cfg.d_model
    norm = norm_shapes(d, cfg.norm)
    block = {"ln1": norm, "attn": attn.attention_shapes(cfg, cfg.qkv_bias), "ln2": norm}
    if cfg.moe is not None:
        block["moe"] = moe_lib.moe_param_shapes(cfg)
    else:
        block["mlp"] = {"wi": (d, cfg.d_ff), "wg": (d, cfg.d_ff), "wo": (cfg.d_ff, d)}
    return block


def param_shapes(cfg) -> dict:
    """The shape of every leaf :func:`init_lm` makes, in the same tree."""
    block = block_shapes(cfg)
    out = {"embed": (cfg.vocab, cfg.d_model), "ln_f": norm_shapes(cfg.d_model, cfg.norm)}
    out.update({f"layer_{i}": block for i in range(cfg.n_layers)})
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.vocab, cfg.d_model)
    return out


def block_axes(cfg) -> dict:
    """The logical axes of every leaf :func:`init_block` makes."""
    norm = norm_axes(cfg.norm)
    block = {"ln1": norm, "attn": attn.attention_axes(cfg.qkv_bias), "ln2": norm}
    if cfg.moe is not None:
        block["moe"] = dict(moe_lib.MOE_AXES)
    else:
        block["mlp"] = dict(MLP_AXES)
    return block


def param_axes(cfg) -> dict:
    """The logical axes of every leaf :func:`init_lm` makes, in the same tree."""
    out = {"embed": ("vocab", "embed"), "ln_f": norm_axes(cfg.norm)}
    out.update({f"layer_{i}": block_axes(cfg) for i in range(cfg.n_layers)})
    if not cfg.tie_embeddings:
        out["lm_head"] = ("vocab", "embed")
    return out


def _window(cfg, i: int):
    return cfg.swa_window  # uniform SWA (danube); None = full attention


#: the logical axes of the embedding and of an untied head
TABLE_AXES = ("vocab", "embed")


def embed_part(table, tokens, start: int):
    """A vocab part's lookup: the rows of the tokens in ``[start, start +
    len(table))``, zeros for the others."""
    n = table.shape[0]
    local = tokens - start
    hit = ((local >= 0) & (local < n))[..., None]
    rows = table[torch.clamp(local, 0, n - 1)]
    return torch.where(hit, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))


def _table(params, key: str, cfg, tp):
    """The embedding (or head) as this model rank reads it: its vocab part
    where ``tp`` splits the vocab, else the whole table."""
    shape = (cfg.vocab, cfg.d_model)
    if tp.splits(cfg.vocab):
        return tp.take(params[key], TABLE_AXES, shape, 0)
    return tp.take(params[key], TABLE_AXES, shape, None, partial=False)


def embed_tokens(params, tokens, cfg, tp=None):
    """The token embeddings; under a model group ``tp`` that splits the
    vocab, each rank looks up its part and one reduce adds them."""
    if tp is None:
        h = params["embed"][tokens]
    elif tp.splits(cfg.vocab):
        start = tp.part(cfg.vocab)[0]
        h = tp.reduce(embed_part(_table(params, "embed", cfg, tp), tokens, start))
    else:
        h = _table(params, "embed", cfg, tp)[tokens]
    return scale_embedding(h, cfg)


def scale_embedding(h, cfg):
    """√d_model times the embeddings where the config asks for it (gemma)."""
    if cfg.embed_scale:
        scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32))
        h = h * scale.to(h.dtype).to(h.device)
    return h


def unembed(params, h, cfg, tp=None):
    """Logits in float32; under a model group ``tp`` that splits the vocab,
    this rank's vocab part ``[..., V/M]`` (the loss is then
    ``losses.causal_lm_loss_parallel``)."""
    key = "embed" if cfg.tie_embeddings else "lm_head"
    if tp is None:
        table = params[key]
    else:
        table = _table(params, key, cfg, tp)
        if tp.splits(cfg.vocab):
            h = tp.copy(h)
    return torch.matmul(h, table.t()).float()  # the product in the working type, then f32


def forward(params, tokens, cfg, *, prefix_emb=None, last_only: bool = False,
            remat: bool = False, dp=None, tp=None):
    """Token logits for train/prefill; ``last_only`` keeps the last position.
    ``prefix_emb`` (the VLM's projected image): embeddings put before the
    token embeddings in sequence order, cast to their type. The aux:
    ``{"moe_aux": mean over layers}`` for an MoE model, else ``{}``.
    ``remat``: each block under ``torch.utils.checkpoint``. ``dp``: the
    data-parallel group, passed to every MoE block as the reference passes
    its ``rules``. ``tp``: the model group (``dist/tensor_parallel.py``);
    ``params`` is then this rank's view of the stored leaves, and the
    logits are its vocab part where the group splits the vocab."""
    h = embed_tokens(params, tokens, cfg, tp)
    if prefix_emb is not None:
        h = torch.cat([prefix_emb.to(h.dtype), h], dim=1)
    aux_tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_layers):
        blk = functools.partial(apply_block, cfg=cfg, window=_window(cfg, i), dp=dp, tp=tp)
        h, aux = remat_call(blk, remat, params[f"layer_{i}"], h)
        if "moe_aux" in aux:
            aux_tot = aux_tot + aux["moe_aux"]
    h = apply_norm(params["ln_f"], h, cfg.norm, cfg.norm_eps)
    if last_only:  # prefill: only the last position's logits are served
        h = h[:, -1:]
    out = {"moe_aux": aux_tot / max(cfg.n_layers, 1)} if cfg.moe is not None else {}
    return unembed(params, h, cfg, tp), out


def kv_split(cfg, tp, kv_len: int):
    """The dimension of a ``kv_len``-position KV cache leaf the serve table
    of ``tp.rules`` splits over ``model``: 1 (positions) where the ranks
    divide ``kv_len``, else 2 (KV heads) where they divide those, else None."""
    return tp.rules.split_dim(KV_AXES["k"], (1, kv_len, cfg.n_kv_heads, cfg.hd), "model")


def decode_step(params, token, cache, pos, cfg, tp=None, kv_len=None):
    """token: [B] int; cache: {"layer_i": {"k","v"}}; pos: scalar or [B].
    ``tp``: the model group of a serve table (``params`` this rank's stored
    leaves, ``cache`` its shard of a ``kv_len``-position cache): the
    vocab-parallel embedding and head, attention on the split cache
    (:func:`kv_split`), the MLP over ``ff`` and the MoE block over its
    experts or ``ff``; every rank returns the whole logits."""
    h = embed_tokens(params, token[:, None], cfg, tp)
    split = None if tp is None else kv_split(cfg, tp, kv_len)
    new_cache = {}
    for i in range(cfg.n_layers):
        h, c = apply_block_decode(params[f"layer_{i}"], h, cfg, cache[f"layer_{i}"], pos,
                                  window=_window(cfg, i), tp=tp, kv_split=split)
        new_cache[f"layer_{i}"] = c
    h = apply_norm(params["ln_f"], h, cfg.norm, cfg.norm_eps)
    return whole_logits(unembed(params, h, cfg, tp)[:, 0], cfg, tp), new_cache


def whole_logits(logits, cfg, tp=None):
    """A decode step's logits over the whole vocab on every model rank: the
    ranks' vocab parts gathered in rank order where ``tp`` split the head."""
    if tp is not None and logits.shape[-1] != cfg.vocab:
        return tp.gather_dim(logits, -1)
    return logits


#: the logical axes of a layer's KV cache: its positions are the serve
#: table's ``kvseq`` (flash-decoding), split over ``model`` before its heads
KV_AXES = {"k": ("batch", "kvseq", "kv_heads", None), "v": ("batch", "kvseq", "kv_heads", None)}


def cache_axes(cfg) -> dict:
    """The logical axes of every leaf :func:`init_cache` makes."""
    return {f"layer_{i}": dict(KV_AXES) for i in range(cfg.n_layers)}


def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16, device="cuda"):
    shape = (batch, seq_len, cfg.n_kv_heads, cfg.hd)
    return {f"layer_{i}": {"k": torch.zeros(shape, dtype=dtype, device=device),
                           "v": torch.zeros(shape, dtype=dtype, device=device)}
            for i in range(cfg.n_layers)}


def kv_cache_bytes(cfg, batch: int, seq_len: int, dtype=torch.bfloat16) -> int:
    elem = torch.empty((), dtype=dtype).element_size()
    return 2 * cfg.n_layers * batch * seq_len * cfg.n_kv_heads * cfg.hd * elem
