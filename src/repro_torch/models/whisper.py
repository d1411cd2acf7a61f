"""Whisper-large-v3 backbone: 32-layer encoder + 32-layer decoder, d=1280.

Port of ``repro/models/whisper.py``. The conv/mel frontend is a stub, as in
the reference: the encoder takes precomputed frame embeddings [B, enc_len,
d]. Pre-LN LayerNorm blocks, non-gated GELU MLPs (``jax.nn.gelu``'s tanh
form in float32), sinusoidal positions, a bias on every attention. The
decoder's head is tied to its embedding.

Decode keeps, per decoder layer, a self-attention KV cache of the serving
length (written in place at each slot's position) and a cross-attention
K/V of ``enc_len`` positions. ``init_cache`` leaves the cross K/V at zero;
the conditioned path fills it from ``project_cross_kv(encode(frames))``.
Under a model group ``encode`` and ``decode_train`` split attention and
cross attention over their heads, the MLP over ``ff`` and the tied head
over the vocab where the group divides it (:func:`enc_block` and
:func:`dec_block` take the layers, so ``models/tp_ranks.py`` runs the same
blocks with every rank in one process); ``decode_step`` under a serve
table's model group splits the self-attention cache as the dense family's
and the cross K/V on their KV heads.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import transformer
from repro_torch.models.common import (apply_norm, dense_init, embed_init, init_norm, mlp_tp,
                                       norm_axes, norm_shapes, sinusoidal_pos)


def init_plain_mlp(gen, d, f, dtype=torch.bfloat16, device="cuda"):
    return {"wi": dense_init(gen, (d, f), 0, dtype, device),
            "wo": dense_init(gen, (f, d), 0, dtype, device)}


def apply_plain_mlp(p, x):
    h = torch.matmul(x, p["wi"])
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return torch.matmul(h, p["wo"])


def plain_mlp(p, x, cfg, tp=None):
    """:func:`apply_plain_mlp`; under a model group ``tp`` column-parallel
    ``wi`` and row-parallel ``wo`` over ``ff`` (``common.mlp_tp``)."""
    if tp is None:
        return apply_plain_mlp(p, x)
    return mlp_tp(p, x, tp, cfg.d_ff, apply_plain_mlp)


def init_enc_block(gen, cfg, dtype=torch.bfloat16, device="cuda"):
    d = cfg.d_model
    return {
        "ln1": init_norm(d, "layernorm", device),
        "attn": attn.init_attention(gen, cfg, dtype=dtype, bias=True, device=device),
        "ln2": init_norm(d, "layernorm", device),
        "mlp": init_plain_mlp(gen, d, cfg.d_ff, dtype, device),
    }


def init_dec_block(gen, cfg, dtype=torch.bfloat16, device="cuda"):
    d = cfg.d_model
    return {
        "ln1": init_norm(d, "layernorm", device),
        "self_attn": attn.init_attention(gen, cfg, dtype=dtype, bias=True, device=device),
        "ln2": init_norm(d, "layernorm", device),
        "cross_attn": attn.init_attention(gen, cfg, dtype=dtype, bias=True, device=device),
        "ln3": init_norm(d, "layernorm", device),
        "mlp": init_plain_mlp(gen, d, cfg.d_ff, dtype, device),
    }


def init_whisper(gen, cfg, dtype=torch.bfloat16, device="cuda", place=None):
    """The parameter tree, drawn in the reference's order; ``place(key,
    subtree)`` as in ``transformer.init_lm``."""
    place = place or (lambda key, tree: tree)
    p = {
        "embed": place("embed", embed_init(gen, (cfg.vocab, cfg.d_model), dtype, device)),
        "ln_enc": place("ln_enc", init_norm(cfg.d_model, "layernorm", device)),
        "ln_dec": place("ln_dec", init_norm(cfg.d_model, "layernorm", device)),
    }
    for i in range(cfg.enc_layers):
        p[f"enc_{i}"] = place(f"enc_{i}", init_enc_block(gen, cfg, dtype, device))
    for i in range(cfg.n_layers):
        p[f"dec_{i}"] = place(f"dec_{i}", init_dec_block(gen, cfg, dtype, device))
    return p


def param_shapes(cfg) -> dict:
    """The shape of every leaf :func:`init_whisper` makes."""
    d, f = cfg.d_model, cfg.d_ff
    norm = norm_shapes(d, "layernorm")
    att = attn.attention_shapes(cfg, True)
    mlp = {"wi": (d, f), "wo": (f, d)}
    out = {"embed": (cfg.vocab, d), "ln_enc": norm, "ln_dec": norm}
    out.update({f"enc_{i}": {"ln1": norm, "attn": att, "ln2": norm, "mlp": mlp}
                for i in range(cfg.enc_layers)})
    out.update({f"dec_{i}": {"ln1": norm, "self_attn": att, "ln2": norm, "cross_attn": att,
                             "ln3": norm, "mlp": mlp} for i in range(cfg.n_layers)})
    return out


def param_axes(cfg) -> dict:
    """The logical axes of every leaf :func:`init_whisper` makes."""
    norm = norm_axes("layernorm")
    att = attn.attention_axes(True)
    mlp = {"wi": ("embed", "ff"), "wo": ("ff", "embed")}
    out = {"embed": ("vocab", "embed"), "ln_enc": norm, "ln_dec": norm}
    out.update({f"enc_{i}": {"ln1": norm, "attn": att, "ln2": norm, "mlp": mlp}
                for i in range(cfg.enc_layers)})
    out.update({f"dec_{i}": {"ln1": norm, "self_attn": att, "ln2": norm, "cross_attn": att,
                             "ln3": norm, "mlp": mlp} for i in range(cfg.n_layers)})
    return out


def enc_block(p, h, attend, mlp):
    """An encoder block around its layers: ``attend(p_attn, a)`` and
    ``mlp(p_mlp, a)`` (whole, head- and ff-parallel, or a test's ranks in
    one process)."""
    a = apply_norm(p["ln1"], h, "layernorm")
    h = h + attend(p["attn"], a)
    return h + mlp(p["mlp"], apply_norm(p["ln2"], h, "layernorm"))


def dec_block(p, h, enc_out, self_attend, cross, mlp):
    """A decoder block around its layers: ``self_attend(p_attn, a)``,
    ``cross(p_cross, a, enc_out)`` and ``mlp(p_mlp, a)``."""
    a = apply_norm(p["ln1"], h, "layernorm")
    h = h + self_attend(p["self_attn"], a)
    a = apply_norm(p["ln2"], h, "layernorm")
    h = h + cross(p["cross_attn"], a, enc_out)
    return h + mlp(p["mlp"], apply_norm(p["ln3"], h, "layernorm"))


def block_layers(cfg, tp, causal: bool):
    """A block's layers under the model group ``tp`` (None: whole)."""
    attend = functools.partial(attn.attention, cfg=cfg, causal=causal, use_rope=False, tp=tp)
    cross = (attn.cross_attend if tp is None
             else functools.partial(attn.cross_attend_tp, cfg=cfg, tp=tp))
    return attend, cross, functools.partial(plain_mlp, cfg=cfg, tp=tp)


def encode(params, frames, cfg, tp=None):
    """frames: [B, enc_len, d] (the stub frontend's output). ``tp``: the
    model group, over which attention (heads) and the MLP (``ff``) split;
    ``params`` then this rank's view of the stored leaves."""
    attend, _, mlp = block_layers(cfg, tp, causal=False)
    h = frames + sinusoidal_pos(frames.shape[1], cfg.d_model, frames.device).to(frames.dtype)
    for i in range(cfg.enc_layers):
        h = enc_block(params[f"enc_{i}"], h, attend, mlp)
    return apply_norm(params["ln_enc"], h, "layernorm")


def _logits(params, h, cfg, tp=None):
    h = apply_norm(params["ln_dec"], h, "layernorm")
    return transformer.unembed(params, h, cfg, tp)


def decode_train(params, tokens, enc_out, cfg, *, last_only: bool = False, tp=None):
    """Teacher-forced decoder over the whole token sequence (train/prefill);
    each layer projects its cross K/V from ``enc_out``. ``tp``: the model
    group: self and cross attention head-parallel, the MLP over ``ff``, the
    tied embedding and head vocab-parallel where the group splits the vocab
    (the logits then this rank's vocab part)."""
    attend, cross, mlp = block_layers(cfg, tp, causal=True)
    h = transformer.embed_tokens(params, tokens, cfg, tp)
    h = h + sinusoidal_pos(tokens.shape[1], cfg.d_model, h.device).to(h.dtype)
    for i in range(cfg.n_layers):
        h = dec_block(params[f"dec_{i}"], h, enc_out, attend, cross, mlp)
    if last_only:
        h = h[:, -1:]
    return _logits(params, h, cfg, tp)


def decode_step(params, token, cache, pos, cfg, tp=None, kv_len=None):
    """One-token decode. cache: per layer the self ``k``/``v`` (written in
    place) and the cross ``xk``/``xv``; pos: scalar or [B]. ``tp``: a serve
    table's model group (``params`` this rank's stored leaves, ``cache`` its
    shard of a ``kv_len``-position cache): the embedding and the tied head
    vocab-parallel, self attention on the split cache
    (``attention.attention_decode_tp``, split by ``transformer.kv_split``),
    cross attention over the rank's KV heads of the cross cache
    (``attention.cross_attention_decode_tp``), the MLP over ``ff``; every
    rank returns the whole logits. The positions' table is ``kv_len`` long
    (the cache's own length without a group)."""
    b = token.shape[0]
    h = transformer.embed_tokens(params, token[:, None], cfg, tp)
    kv_len = cache["dec_0"]["k"].shape[1] if kv_len is None else kv_len
    pos_emb = sinusoidal_pos(kv_len, cfg.d_model, h.device)
    posv = torch.as_tensor(pos, dtype=torch.int64, device=h.device).expand(b)
    h = h + pos_emb[posv][:, None].to(h.dtype)
    split = None if tp is None else transformer.kv_split(cfg, tp, kv_len)
    new_cache = {}
    for i in range(cfg.n_layers):
        p, c = params[f"dec_{i}"], cache[f"dec_{i}"]
        a = apply_norm(p["ln1"], h, "layernorm")
        if tp is None:
            o, nk, nv = attn.attention_decode(p["self_attn"], a, cfg, c["k"], c["v"], pos,
                                              use_rope=False)
        else:
            o, nk, nv = attn.attention_decode_tp(p["self_attn"], a, cfg, c["k"], c["v"], pos,
                                                 tp, split, use_rope=False)
        h = h + o
        a = apply_norm(p["ln2"], h, "layernorm")
        if tp is None:
            h = h + attn.cross_attention(p["cross_attn"], a, c["xk"], c["xv"])
        else:
            h = h + attn.cross_attention_decode_tp(p["cross_attn"], a, cfg, c["xk"], c["xv"], tp)
        h = h + plain_mlp(p["mlp"], apply_norm(p["ln3"], h, "layernorm"), cfg, tp)
        new_cache[f"dec_{i}"] = {"k": nk, "v": nv, "xk": c["xk"], "xv": c["xv"]}
    return transformer.whole_logits(_logits(params, h, cfg, tp)[:, 0], cfg, tp), new_cache


def cache_axes(cfg) -> dict:
    """The logical axes of every leaf :func:`init_cache` makes: the self
    K/V split as the dense family's, the cross K/V on their heads only."""
    cross = ("batch", None, "kv_heads", None)
    return {f"dec_{i}": dict(transformer.KV_AXES, xk=cross, xv=cross)
            for i in range(cfg.n_layers)}


def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16, device="cuda"):
    def zeros(t):
        return torch.zeros((batch, t, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=device)

    return {f"dec_{i}": {"k": zeros(seq_len), "v": zeros(seq_len), "xk": zeros(cfg.enc_len),
                         "xv": zeros(cfg.enc_len)} for i in range(cfg.n_layers)}


def fill_cross_cache(params, cache, enc_out, cfg):
    """Write every decoder layer's ``project_cross_kv(enc_out)`` into the
    cache's ``xk``/``xv`` in place (the audio-conditioned decode)."""
    for i in range(cfg.n_layers):
        k, v = attn.project_cross_kv(params[f"dec_{i}"]["cross_attn"], enc_out)
        cache[f"dec_{i}"]["xk"].copy_(k)
        cache[f"dec_{i}"]["xv"].copy_(v)
    return cache
