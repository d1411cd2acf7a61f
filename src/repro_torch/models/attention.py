"""GQA/MQA/SWA attention with train/prefill and cached-decode paths.

Port of ``repro/models/attention.py``: self-attention, and whisper's
``cross_attention`` and ``project_cross_kv`` (the reference's ``_mask`` is
called nowhere there and is left out); under a model group both are
head-parallel (:func:`attention_tp`, :func:`cross_attend_tp`), and the
cached decode runs on a KV cache split by the serve table
(:func:`attention_decode_tp`: over its positions, flash-decoding, or over
its KV heads).
Layouts are the reference's:

    q        [B, S, H, hd]          k/v  [B, T, K, hd]
    scores   [B, K, g, S, T]        (g = H // K query groups)

Softmax runs in float32. The decode path writes the new token's K/V into
the cache in place at each slot's own position.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist.data_parallel import add_in_order
from repro_torch.models.common import dense_init, matmul_rows, rope
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


def _decode_qkv(p, x, cfg, tp):
    """The new token's q, k and v for every head, on every model rank,
    from the stored ``d_model`` rows of ``wq``/``wk``/``wv``."""
    axes, shapes = _tree(p, cfg, x.shape[-1])
    q, k, v = (matmul_rows(x, p[w], axes[w], shapes[w], tp) for w in ("wq", "wk", "wv"))
    if "bq" in p:
        q, k, v = (t + tp.take(p[b], axes[b], shapes[b], None, partial=False)
                   for t, b in ((q, "bq"), (k, "bk"), (v, "bv")))
    return q, k, v


def _decode_mask(pos_k, posv, window):
    """The per-slot causal (+ window) mask of positions ``pos_k``:
    [B, 1, 1, 1, T] over the [B, K, g, S, T] score layout."""
    m = pos_k[None, :] <= posv[:, None]
    if window is not None:
        m &= (posv[:, None] - pos_k[None, :]) < window
    return torch.where(m, 0.0, NEG_INF)[:, None, None, None, :]


def softmax_part(q, k, v, mask):
    """One block of positions' part of the grouped decode softmax, float32:
    the block's max score ``m`` [B, K, g, 1, 1], its sum of exponentials
    ``l`` (same shape) and ``Σ exp(s - m)·v`` ``o`` [B, K, g, 1, hd]."""
    b, s, h, hd = q.shape
    kk = k.shape[2]
    qg = q.reshape(b, s, kk, h // kk, hd)
    scores = torch.einsum("bskgx,btkx->bkgst", qg, k).float()
    scores = scores / float(np.sqrt(np.float32(hd))) + mask
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    return m, e.sum(dim=-1, keepdim=True), torch.einsum("bkgst,btkx->bkgsx", e, v.float())


def combine_parts(ms, ls, os_, dtype):
    """The blocks' parts (lists in block order) as one softmax over every
    position: each part rescaled by ``exp(m - max m)``, numerators and
    denominators added in block order; [B, 1, H·hd] in ``dtype``."""
    top = ms[0]
    for m in ms[1:]:
        top = torch.maximum(top, m)
    scales = [torch.exp(m - top) for m in ms]
    num = add_in_order([o * sc for o, sc in zip(os_, scales)])
    den = add_in_order([l * sc for l, sc in zip(ls, scales)])
    out = (num / den).to(dtype)  # [B, K, g, 1, hd]
    b, kk, g, s, hd = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, kk * g * hd)


def attention_decode_tp(p, x, cfg, cache_k, cache_v, pos, tp, split, *, window=None,
                        use_rope: bool = True):
    """:func:`attention_decode` on model rank ``tp.rank`` of the model group
    ``tp``, its KV cache stored as the serve table splits it: ``split`` is
    the cache dimension split over ``model`` (1: positions, 2: KV heads,
    None: whole on every rank). ``x`` [B, 1, d] is the same on every rank,
    and so is the result.

    Every rank projects the new token's q, k and v for every head (the
    stored ``d_model`` rows of ``wq``/``wk``/``wv``: partial products added
    in rank order). Split on positions (flash-decoding), rank ``r`` holds
    positions ``[r·T/m, (r+1)·T/m)`` of every KV head: it writes the new
    K/V only where it holds a slot's position, takes its block's part of
    the softmax for every query head on global positions, and the parts are
    combined over the group (the max, a rescale, the numerators and
    denominators added in rank order). Split on KV heads, a rank writes and
    attends its own KV heads with their query groups. Then ``wo`` on each
    rank's query heads and one sum over the group (``wo`` read whole where
    the group does not split the heads)."""
    b = cache_k.shape[0]
    h, hd = cfg.n_heads, cfg.hd
    q, k_new, v_new = _decode_qkv(p, x, cfg, tp)
    posv = torch.as_tensor(pos, dtype=torch.int64, device=x.device).expand(b)
    if use_rope:
        q = rope(q, posv[:, None], cfg.rope_theta)
        k_new = rope(k_new, posv[:, None], cfg.rope_theta)
    idx = torch.arange(b, device=x.device)
    heads = tp.part(h) if tp.splits(h) else (0, h)
    if split == 1:
        tl = cache_k.shape[1]
        t0 = tp.rank * tl
        local = posv - t0
        mine = ((local >= 0) & (local < tl))[:, None, None]
        at = torch.clamp(local, 0, tl - 1)
        cache_k[idx, at] = torch.where(mine, k_new[:, 0], cache_k[idx, at])
        cache_v[idx, at] = torch.where(mine, v_new[:, 0], cache_v[idx, at])
        mask = _decode_mask(t0 + torch.arange(tl, device=x.device), posv, window)
        m, l, o = softmax_part(q, cache_k, cache_v, mask)
        ms, ls, os_ = (list(tp.gather(t).unbind(0)) for t in (m, l, o))
        out = combine_parts(ms, ls, os_, cache_v.dtype)[..., heads[0] * hd:heads[1] * hd]
    else:
        kv = tp.part(cfg.n_kv_heads) if split == 2 else (0, cfg.n_kv_heads)
        cache_k[idx, posv] = k_new[:, 0, kv[0]:kv[1]]
        cache_v[idx, posv] = v_new[:, 0, kv[0]:kv[1]]
        mask = _decode_mask(torch.arange(cache_k.shape[1], device=x.device), posv, window)
        ck, cv = cache_k, cache_v
        if split is None and heads != (0, h):  # this rank's query heads read their KV heads
            kv_idx = torch.arange(*heads, device=x.device) // (h // cfg.n_kv_heads)
            ck, cv = ck.index_select(2, kv_idx), cv.index_select(2, kv_idx)
        out = mha(q[:, :, heads[0]:heads[1]], ck, cv, mask)
    return _decode_out(p, out, cfg, tp, heads, x.shape[-1]), cache_k, cache_v


def _decode_out(p, out, cfg, tp, heads, d: int):
    """``wo`` on the attention output ``out`` of query heads ``heads``
    (every head, or this rank's part): the partial products of the rank's
    ``wo`` rows added in rank order, or, where every rank holds every
    head's output, ``wo`` read as the table stores it (its ``d_model``
    columns' products gathered where they are split, else whole)."""
    axes, shapes = _tree(p, cfg, d)
    if heads != (0, cfg.n_heads):
        return tp.sum(_out({"wo": tp.take(p["wo"], axes["wo"], shapes["wo"], 0)}, out))
    if tp.rules.split_dim(axes["wo"], shapes["wo"], "model") == 2:
        return tp.gather_dim(_out(p, out), -1)
    wo = tp.take(p["wo"], axes["wo"], shapes["wo"], None, partial=False)
    return _out({"wo": wo}, out)


def cross_attention(p, x, kv_cache_k, kv_cache_v):
    """Encoder-decoder cross attention (whisper): the cache is the projected
    encoder output; no masking, no RoPE, ``bq`` where the tree has one."""
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    mask = torch.zeros((x.shape[1], kv_cache_k.shape[1]), dtype=torch.float32, device=x.device)
    return _out(p, mha(q, kv_cache_k, kv_cache_v, mask))


def cross_attention_decode_tp(p, x, cfg, kv_cache_k, kv_cache_v, tp):
    """:func:`cross_attention` on rank ``tp.rank`` of a serve table's model
    group, over a stored cross K/V cache (``xk``/``xv``, this rank's shard:
    its KV heads where the table splits them, else every KV head). Every
    rank projects q for every head (``wq``'s stored ``d_model`` rows:
    partial products added in rank order) and attends with the query heads
    of its part (:func:`head_part`'s bookkeeping, as
    :func:`cross_attend_tp`'s): with its own KV heads, or every KV head
    indexed by each query head. Then its rows of ``wo`` and one sum; where
    the group does not split the heads, every rank attends with every head."""
    axes, shapes = _tree(p, cfg, x.shape[-1])
    q = matmul_rows(x, p["wq"], axes["wq"], shapes["wq"], tp)
    if "bq" in p:
        q = q + tp.take(p["bq"], axes["bq"], shapes["bq"], None, partial=False)
    h = cfg.n_heads
    heads, ck, cv = (0, h), kv_cache_k, kv_cache_v
    if tp.splits(h):
        # the table splits the cache's KV heads where the ranks divide them
        heads, kv_idx = head_part(cfg, tp.rank, tp.size)
        if kv_idx is not None:  # every KV head on every rank: those of its query heads
            kv_idx = kv_idx.to(x.device)
            ck, cv = ck.index_select(2, kv_idx), cv.index_select(2, kv_idx)
    mask = torch.zeros((x.shape[1], ck.shape[1]), dtype=torch.float32, device=x.device)
    out = mha(q[:, :, heads[0]:heads[1]], ck, cv, mask)
    return _decode_out(p, out, cfg, tp, heads, x.shape[-1])


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
