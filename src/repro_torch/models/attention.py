"""GQA/MQA/SWA attention with train/prefill and cached-decode paths.

Port of ``repro/models/attention.py``: self-attention, and whisper's
``cross_attention`` and ``project_cross_kv`` (the reference's ``_mask`` is
called nowhere there and is left out); under a model group both are
head-parallel (:func:`attention_tp`, :func:`cross_attend_tp`).
Layouts are the reference's:

    q        [B, S, H, hd]          k/v  [B, T, K, hd]
    scores   [B, K, g, S, T]        (g = H // K query groups)

Softmax runs in float32. The decode path writes the new token's K/V into
the cache in place at each slot's own position.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import dense_init, rope
from repro_torch.models.flash import blockwise_attention

NEG_INF = -1e30


def init_attention(gen, cfg, d_model=None, dtype=torch.bfloat16, bias=None, device="cuda"):
    d = d_model or cfg.d_model
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    use_bias = cfg.qkv_bias if bias is None else bias
    p = {
        "wq": dense_init(gen, (d, h, hd), 0, dtype, device),
        "wk": dense_init(gen, (d, k, hd), 0, dtype, device),
        "wv": dense_init(gen, (d, k, hd), 0, dtype, device),
        "wo": dense_init(gen, (h, hd, d), None, dtype, device),
    }
    if use_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((k, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((k, hd), dtype=dtype, device=device)
    return p


def attention_axes(bias: bool) -> dict:
    """The logical axes of :func:`init_attention`'s leaves: q, k and v are
    stored split on ``attn_embed`` (d_model) first, ``wo`` on its heads."""
    out = {"wq": ("attn_embed", "heads", None), "wk": ("attn_embed", "kv_heads", None),
           "wv": ("attn_embed", "kv_heads", None), "wo": ("heads", None, "attn_embed")}
    if bias:
        out.update(bq=("heads", None), bk=("kv_heads", None), bv=("kv_heads", None))
    return out


def _proj(x, w):
    """``einsum("bsd,dhx->bshx")`` as one matmul over the flattened heads."""
    d, h, hd = w.shape
    return torch.matmul(x, w.reshape(d, h * hd)).unflatten(-1, (h, hd))


def _project_qkv(p, x):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _out(p, o):
    """``einsum("bsy,yd->bsd")`` with the heads of ``wo`` flattened."""
    return torch.matmul(o, p["wo"].reshape(-1, p["wo"].shape[-1]))


def mha(q, k, v, mask):
    """Grouped attention core; softmax in f32."""
    b, s, h, hd = q.shape
    kk = k.shape[2]
    g = h // kk
    q = q.reshape(b, s, kk, g, hd)
    scores = torch.einsum("bskgx,btkx->bkgst", q, k).float()
    scores = scores / float(np.sqrt(np.float32(hd)))
    scores = scores + mask  # broadcast [S, T] or [B, 1, 1, 1, T]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkx->bskgx", w.to(v.dtype), v)
    return out.reshape(b, s, h * hd)


def attention_shapes(cfg, bias: bool, d_model=None) -> dict:
    """The shape of every leaf :func:`init_attention` makes."""
    d = d_model or cfg.d_model
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = {"wq": (d, h, hd), "wk": (d, k, hd), "wv": (d, k, hd), "wo": (h, hd, d)}
    if bias:
        out.update(bq=(h, hd), bk=(k, hd), bv=(k, hd))
    return out


def attention(p, x, cfg, *, positions=None, causal: bool = True, window=None,
              use_rope: bool = True, kv_idx=None, tp=None):
    """Full-sequence attention (train / prefill): blockwise online softmax
    (models/flash.py; full scores are never materialized). ``kv_idx``: the
    KV heads each query head of ``p`` attends to (a rank's part of the
    heads, when its KV heads are the whole set). ``tp``: the model group,
    over which the heads are split (:func:`attention_tp`)."""
    if tp is not None:
        return attention_tp(p, x, cfg, tp, positions=positions, causal=causal, window=window,
                            use_rope=use_rope)
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x)
    if kv_idx is not None:
        k, v = k.index_select(2, kv_idx), v.index_select(2, kv_idx)
    pos = positions if positions is not None else torch.arange(s, device=x.device)
    if use_rope:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    out = blockwise_attention(q, k, v, causal=causal, window=window)
    return _out(p, out.reshape(b, s, -1))


def head_part(cfg, rank: int, size: int) -> tuple[tuple[int, int], object]:
    """Model rank ``rank``'s query heads ``[h0, h1)`` of ``size`` ranks, and
    the KV heads they read: None where the ranks split the KV heads too
    (the rank's own), else the index of each query head's KV head."""
    per = cfg.n_heads // size
    h0, h1 = rank * per, (rank + 1) * per
    if cfg.n_kv_heads % size == 0:
        return (h0, h1), None
    return (h0, h1), torch.arange(h0, h1) // (cfg.n_heads // cfg.n_kv_heads)


def _tree(p, cfg, d: int) -> tuple[dict, dict]:
    """The logical axes and global shapes of an attention's leaves ``p`` of
    width ``d``."""
    return attention_axes("bq" in p), attention_shapes(cfg, "bq" in p, d)


def _head_leaves(p, cfg, tp, d: int):
    """This model rank's leaves of a head-parallel attention of width ``d``
    (its query heads, ``wo`` rows and biases; its KV heads where the ranks
    split them, else every KV head) and the KV index of its query heads
    (None where it has its own KV heads). ``wq``/``wk``/``wv`` are stored
    split on ``d_model`` and gathered first."""
    axes, shapes = _tree(p, cfg, d)
    _, kv_idx = head_part(cfg, tp.rank, tp.size)
    kv = (1, 0) if kv_idx is None else (None, None)  # (wk/wv, bk/bv) part dims
    dims = {"wq": 1, "wo": 0, "bq": 0, "wk": kv[0], "wv": kv[0], "bk": kv[1], "bv": kv[1]}
    local = {k: tp.take(v, axes[k], shapes[k], dims.get(k)) for k, v in p.items()}
    return local, None if kv_idx is None else kv_idx.to(tp.device)


def attention_tp(p, x, cfg, tp, **kw):
    """Head-parallel attention over the model group ``tp``: each rank
    projects and attends with its query heads (and its KV heads, or every
    KV head where the ranks do not split them), then ``wo`` on its heads and
    one reduce. ``kw`` (``causal``, ``use_rope``, ``window``, ``positions``)
    reaches every rank's :func:`attention`. Where the group does not split
    the heads, every rank computes the whole attention."""
    if not tp.splits(cfg.n_heads):
        return attention(tp.whole(p, *_tree(p, cfg, x.shape[-1])), x, cfg, **kw)
    local, kv_idx = _head_leaves(p, cfg, tp, x.shape[-1])
    return tp.reduce(attention(local, tp.copy(x), cfg, kv_idx=kv_idx, **kw))


def attention_decode(p, x, cfg, cache_k, cache_v, pos, *, window=None,
                     use_rope: bool = True):
    """One-token decode against a pre-filled KV cache.

    cache_k/v: [B, T, K, hd], written in place at each slot's position.
    ``pos`` may be a scalar (lockstep decode) or an int tensor [B] (continuous
    batching: each slot advances independently). Returns
    (out [B, 1, d], cache_k, cache_v)."""
    b, t, kk, hd = cache_k.shape
    q, k_new, v_new = _project_qkv(p, x)  # S = 1
    posv = torch.as_tensor(pos, dtype=torch.int64, device=x.device).expand(b)  # [B]
    if use_rope:
        q = rope(q, posv[:, None], cfg.rope_theta)
        k_new = rope(k_new, posv[:, None], cfg.rope_theta)
    idx = torch.arange(b, device=x.device)
    cache_k[idx, posv] = k_new[:, 0]
    cache_v[idx, posv] = v_new[:, 0]
    pos_k = torch.arange(t, device=x.device)
    # per-sequence causal (+ window) mask: [B, 1, 1, 1, T] broadcast over
    # the [B, K, g, S, T] score layout
    m = pos_k[None, :] <= posv[:, None]
    if window is not None:
        m &= (posv[:, None] - pos_k[None, :]) < window
    mask = torch.where(m, 0.0, NEG_INF)[:, None, None, None, :]
    out = mha(q, cache_k, cache_v, mask)
    return _out(p, out), cache_k, cache_v


def cross_attention(p, x, kv_cache_k, kv_cache_v):
    """Encoder-decoder cross attention (whisper): the cache is the projected
    encoder output; no masking, no RoPE, ``bq`` where the tree has one."""
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    mask = torch.zeros((x.shape[1], kv_cache_k.shape[1]), dtype=torch.float32, device=x.device)
    return _out(p, mha(q, kv_cache_k, kv_cache_v, mask))


def project_cross_kv(p, enc_out):
    """The encoder output's cross K/V, [B, T, K, hd] each, with ``bk``/``bv``."""
    k, v = _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    return k, v


def cross_attend(p, x, enc_out, kv_idx=None):
    """Train/prefill cross attention of the heads whose leaves ``p`` holds
    (every head, or a model rank's part): the encoder output's K/V
    projected (:func:`project_cross_kv`) and attended
    (:func:`cross_attention`). ``kv_idx``: as in :func:`attention`."""
    k, v = project_cross_kv(p, enc_out)
    if kv_idx is not None:
        k, v = k.index_select(2, kv_idx), v.index_select(2, kv_idx)
    return cross_attention(p, x, k, v)


def cross_attend_tp(p, x, enc_out, cfg, tp):
    """:func:`cross_attend` head-parallel over the model group ``tp``: each
    rank projects the encoder output to its KV heads and attends with its
    query heads, ``bq``/``bk``/``bv`` entries and ``wo`` rows; one reduce.
    The decoder's and the encoder's outputs enter through ``tp.copy``, so
    their gradients are summed over the ranks. Where the group does not
    split the heads, every rank computes the whole cross attention."""
    if not tp.splits(cfg.n_heads):
        return cross_attend(tp.whole(p, *_tree(p, cfg, x.shape[-1])), x, enc_out)
    local, kv_idx = _head_leaves(p, cfg, tp, x.shape[-1])
    return tp.reduce(cross_attend(local, tp.copy(x), tp.copy(enc_out), kv_idx))
