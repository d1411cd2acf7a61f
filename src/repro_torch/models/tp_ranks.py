"""The ranks of a tensor-parallel layer, one after another in one process.

Each function runs the per-rank code of one of the model group's layers
(``dist/tensor_parallel.py``) for every rank of a group of ``size``, on the
part of the whole leaves that rank reads, and combines the parts in rank
order, as the layer's collective does: the MLP on each rank's ``ff``
columns, attention and cross attention on its heads, the embedding lookup
and the loss on its vocab part, the MoE block's products on its experts
(or on each expert's ``ff`` part), the Mamba2, mLSTM and sLSTM blocks on
their heads (an RMSNorm's sums of squares added over the ranks between two
stages), whisper's blocks around those layers. A rank's leaves are slices
of the whole leaves (the blocks' own maps, read by :func:`_read` as
``TensorParallel.read`` reads them), so the gradients come back as the
whole leaves'. ``chip_smoke.py`` phases 19b and 20a and the CPU tests hold
these against the unsplit layers; the trainer runs the same per-rank code,
one rank a process.

:class:`DecodeRanks` runs a serve table's tensor-parallel decode step
(``Model.serve_step`` under a model group, every family) with its ``m``
model ranks as threads of this process: each thread stores its rank's
shards of the parameters and the cache and runs the per-rank code the
server runs one rank a process, its group's collectives (:class:`ThreadRank`)
taken over shared memory in rank order. ``chip_smoke.py`` phase 21 holds it
against the unsplit step on one card.
"""

from __future__ import annotations

import concurrent.futures
import functools
import threading

import torch

from repro_torch.dist.data_parallel import add_in_order
from repro_torch.dist.sharding import make_rules
from repro_torch.dist.tensor_parallel import TensorParallel
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, whisper, xlstm
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import apply_mlp, apply_norm, rmsnorm_part, sum_squares
from repro_torch.models.losses import lm_total, sum_exp, target_logit
from repro_torch.models.transformer import embed_part, scale_embedding


def _part(n: int, rank: int, size: int) -> slice:
    """Rank ``rank``'s part of a dimension of ``n`` split over ``size``."""
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def _read(p: dict, reads: dict, rank: int, size: int) -> dict:
    """What rank ``rank`` of ``size`` reads of whole leaves ``p`` by a
    block's map (``TensorParallel.read``'s: a dimension whose part the rank
    takes, ``(dim, index)``, or a subtree)."""
    out = {}
    for k, how in reads.items():
        if isinstance(how, dict):
            out[k] = _read(p[k], how, rank, size)
        elif isinstance(how, tuple):
            out[k] = p[k].index_select(how[0], how[1])
        else:
            sl = _part(p[k].shape[how], rank, size)
            out[k] = p[k].narrow(how, sl.start, sl.stop - sl.start)
    return out


def mlp(p, x, act: str, size: int, fn=None):
    """The MLP (gated, or ``fn(p, x)`` on ``wi``/``wo``), ``ff`` split over
    ``size`` ranks: column-parallel ``wi``/``wg``, row-parallel ``wo``, the
    partial outputs added."""
    fn = fn or functools.partial(apply_mlp, act=act)
    reads = {k: 0 if k == "wo" else 1 for k in p}
    return add_in_order([fn(_read(p, reads, m, size), x) for m in range(size)])


def _attention_leaves(p, cfg, m: int, size: int):
    """Rank ``m``'s leaves of a head-parallel attention and its KV index."""
    (h0, h1), kv_idx = attn.head_part(cfg, m, size)
    local = {"wq": p["wq"][:, h0:h1], "wo": p["wo"][h0:h1]}
    if "bq" in p:
        local["bq"] = p["bq"][h0:h1]
    kv = _part(cfg.n_kv_heads, m, size) if kv_idx is None else slice(None)
    local.update(wk=p["wk"][:, kv], wv=p["wv"][:, kv])
    if "bk" in p:
        local.update(bk=p["bk"][kv], bv=p["bv"][kv])
    return local, None if kv_idx is None else kv_idx.to(p["wq"].device)


def attention(p, x, cfg, size: int, **kw):
    """Head-parallel attention: each rank's query heads (its KV heads where
    the ranks split them, else every KV head), ``wo`` on its heads, the
    partial outputs added."""
    parts = []
    for m in range(size):
        local, kv_idx = _attention_leaves(p, cfg, m, size)
        parts.append(attn.attention(local, x, cfg, kv_idx=kv_idx, **kw))
    return add_in_order(parts)


def cross_attention(p, x, enc_out, cfg, size: int):
    """Head-parallel cross attention: each rank projects the encoder output
    to its KV heads and attends with its query heads; the parts added."""
    parts = []
    for m in range(size):
        local, kv_idx = _attention_leaves(p, cfg, m, size)
        parts.append(attn.cross_attend(local, x, enc_out, kv_idx))
    return add_in_order(parts)


def embed_and_loss(table, h_of, tokens, cfg, size: int, *, z_loss: float = 1e-4):
    """The vocab-parallel embedding, head and loss of a tied ``table``
    [V, d]: each rank looks up its vocab part (the parts added), ``h_of``
    maps the embeddings to the final hidden states, each rank's logits are
    its vocab part, and the loss takes the max of the parts' maxima, the sum
    of their ``Σ exp`` and the target logit from its part. Returns ``(h,
    logits parts, (loss, metrics))``."""
    parts = [_part(cfg.vocab, m, size) for m in range(size)]
    h = add_in_order([embed_part(table[sl], tokens, sl.start) for sl in parts])
    h = h_of(scale_embedding(h, cfg))
    logits = [torch.matmul(h, table[sl].t()).float() for sl in parts]
    lg = [x[:, :-1] for x in logits]
    tg = tokens[:, 1:].long()
    mx = torch.stack([x.amax(dim=-1) for x in lg]).amax(dim=0).detach()
    lse = mx + torch.log(add_in_order([sum_exp(x, mx) for x in lg]))
    ll = add_in_order([target_logit(x, tg, sl.start) for x, sl in zip(lg, parts)])
    return h, logits, lm_total(lse, ll, z_loss=z_loss)


def moe(p, x, cfg, size: int, capacity_factor: float | None = None):
    """The MoE block with its experts' products split over ``size`` ranks:
    each rank multiplies its experts' buckets and the buckets are
    concatenated in rank order before the combine (where ``size`` divides
    the padded experts), else each rank computes its ``ff`` part of every
    product and the parts are added."""
    e = p["wi"].shape[0]

    def experts(x_e, q):
        if e % size == 0:
            return torch.cat([moe_lib._expert_ffn(x_e[sl], {k: q[k][sl] for k in
                                                            ("wi", "wg", "wo")})
                              for sl in (_part(e, m, size) for m in range(size))], dim=0)
        sls = [_part(cfg.d_ff, m, size) for m in range(size)]
        return add_in_order([moe_lib._expert_ffn(x_e, {"wi": q["wi"][..., sl],
                                                       "wg": q["wg"][..., sl],
                                                       "wo": q["wo"][:, sl]}) for sl in sls])

    return moe_lib.apply_moe_gspmd(p, x, cfg, capacity_factor, experts=experts)


def plain_mlp(p, x, size: int):
    """whisper's plain GELU MLP, ``ff`` split over ``size`` ranks."""
    return mlp(p, x, "gelu", size, fn=whisper.apply_plain_mlp)


def whisper_encoder_block(p, h, cfg, size: int):
    """whisper's encoder block with its attention and MLP split over
    ``size`` ranks (``whisper.enc_block``)."""
    return whisper.enc_block(
        p, h, lambda q, a: attention(q, a, cfg, size, causal=False, use_rope=False),
        lambda q, a: plain_mlp(q, a, size))


def whisper_decoder_block(p, h, enc_out, cfg, size: int):
    """whisper's decoder block with self attention, cross attention and
    MLP split over ``size`` ranks (``whisper.dec_block``)."""
    return whisper.dec_block(
        p, h, enc_out, lambda q, a: attention(q, a, cfg, size, causal=True, use_rope=False),
        lambda q, a, e: cross_attention(q, a, e, cfg, size),
        lambda q, a: plain_mlp(q, a, size))


def _bounds(n: int, rank: int, size: int) -> tuple[int, int]:
    sl = _part(n, rank, size)
    return sl.start, sl.stop


def mamba2_block(p, x, cfg, size: int, chunk=None):
    """The Mamba2 block with its heads split over ``size`` ranks: each
    rank's SSD (``mamba2.ssd_heads`` on its ``head_reads``), the sums of
    squares of ``out_norm`` added over the ranks, each rank's norm and
    ``out_proj`` rows, the partial outputs added."""
    _, di, h, _, _ = mamba2.dims(cfg)
    u = apply_norm(p["ln"], x, cfg.norm, cfg.norm_eps)
    local = [_read(p, mamba2.head_reads(cfg, *_bounds(h, m, size), x.device), m, size)
             for m in range(size)]
    ys = [mamba2.ssd_heads(q, u, cfg, chunk=chunk) for q in local]
    ss = add_in_order([sum_squares(y) for y in ys])
    return x + add_in_order([
        torch.matmul(rmsnorm_part(y, q["out_norm"]["scale"], ss, di, cfg.norm_eps),
                     q["out_proj"]) for y, q in zip(ys, local)])


def mlstm_block(p, x, cfg, size: int, chunk: int = 256):
    """The mLSTM block with its heads split over ``size`` ranks: each
    rank's up projections, ``u`` gathered, each rank's chunk loop, the sums
    of squares of ``out_norm`` added over the ranks, each rank's gate and
    ``down`` rows, the partial outputs added."""
    _, di, h, _ = xlstm.mlstm_dims(cfg)
    xin = apply_norm(p["ln"], x, cfg.norm, cfg.norm_eps)
    local = [_read(p, xlstm.mlstm_reads(cfg, *_bounds(h, m, size), x.device), m, size)
             for m in range(size)]
    ups = [xlstm.mlstm_up(q, xin) for q in local]
    u = torch.cat([uu for uu, _ in ups], dim=-1)
    hs = [xlstm.mlstm_cell(q, u, cfg, chunk=chunk).to(x.dtype) for q in local]
    ss = add_in_order([sum_squares(hh) for hh in hs])
    return x + add_in_order([
        xlstm.mlstm_gate_down(q, rmsnorm_part(hh, q["out_norm"]["scale"], ss, di,
                                              cfg.norm_eps), z)
        for hh, q, (_, z) in zip(hs, local, ups)])


def slstm_block(p, x, cfg, size: int):
    """The sLSTM block with its heads split over ``size`` ranks: each
    rank's step loop over its heads, the sums of squares of ``out_norm``
    added over the ranks, the normed parts concatenated for the residual,
    then the GeGLU FFN split over ``ff``."""
    d = cfg.d_model
    xin = apply_norm(p["ln"], x, cfg.norm, cfg.norm_eps)
    local = [_read(p, xlstm.SLSTM_READS, m, size) for m in range(size)]
    hs = [xlstm.slstm_scan(q["r"], xlstm.slstm_gates(q, xin)).to(x.dtype) for q in local]
    ss = add_in_order([sum_squares(hh) for hh in hs])
    x = x + torch.cat([rmsnorm_part(hh, q["out_norm"]["scale"], ss, d, cfg.norm_eps)
                       for hh, q in zip(hs, local)], dim=-1)
    hf = apply_norm(p["ln_ffn"], x, cfg.norm, cfg.norm_eps)
    return x + mlp(xlstm.ffn_leaves(p), hf, "gelu", size)


# ---------------------------------------------------------------------------
# A serve table's decode step, its model ranks as threads
# ---------------------------------------------------------------------------


class _Shared:
    """What the threads of one in-process group exchange through."""

    def __init__(self, size: int):
        self.size = size
        self.slots = [None] * size
        self.barrier = threading.Barrier(size)


class ThreadRank(TensorParallel):
    """Rank ``rank`` of a model group whose ranks are threads of this
    process: :class:`~repro_torch.dist.tensor_parallel.TensorParallel`'s
    collectives, every rank's tensor read from shared memory in rank order
    (so every rank holds the same bits, as over a process group)."""

    def __init__(self, device, shared: _Shared, rank: int, rules):
        self.device, self.pg, self.rules = torch.device(device), None, rules
        self.rank, self.size, self._shared = rank, shared.size, shared

    def _swap(self, x, pick):
        sh = self._shared
        sh.slots[self.rank] = x
        sh.barrier.wait()
        out = torch.stack([pick(t) for t in sh.slots])
        sh.barrier.wait()  # no rank writes its slot again before every rank has read
        return out

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return x[None] if self.size == 1 else self._swap(x, lambda t: t)

    def exchange(self, chunks: torch.Tensor) -> torch.Tensor:
        return chunks if self.size == 1 else self._swap(chunks, lambda t: t[self.rank])

    def barrier(self) -> None:
        self._shared.barrier.wait()


class DecodeRanks:
    """A serve table's decode step on ``(data 1, model size)``, its ranks as
    threads of this process, for every family. Each rank stores its shards
    of ``params`` (whole, on the model's device) and of a ``slots`` ×
    ``max_len`` cache: the family's initial cache, or ``cache`` (whole;
    whisper's cross K/V filled from an encoder output) where given;
    :meth:`step` runs every rank's ``Model.serve_step`` together and
    returns rank 0's logits (every rank's are the same)."""

    def __init__(self, model, params, slots: int, max_len: int, size: int, cache=None):
        from repro_torch.models.api import shard_cache, shard_params
        from repro_torch.runtime import plan_mesh

        self.model, self.max_len, self.size = model, max_len, size
        self.rules = make_rules(plan_mesh(size, global_batch=slots, want_model=size), "serve")
        shared = _Shared(size)
        self.groups = [ThreadRank(model.device, shared, r, self.rules) for r in range(size)]
        self.params = [shard_params(model, self.rules, r, params) for r in range(size)]
        self.caches = [shard_cache(model, self.rules, r, slots, max_len, cache)
                       for r in range(size)]
        self._pool = concurrent.futures.ThreadPoolExecutor(size)

    def kv_split(self) -> int | None:
        """The cache dimension the ranks split (``transformer.kv_split``)."""
        from repro_torch.models.transformer import kv_split

        return kv_split(self.model.cfg, self.groups[0], self.max_len)

    def step(self, token: torch.Tensor, pos) -> torch.Tensor:
        def one(r):
            try:
                with torch.no_grad():
                    logits, self.caches[r] = self.model.serve_step(
                        self.params[r], {"token": token, "pos": pos, "cache": self.caches[r]},
                        self.groups[r], self.max_len)
                return logits
            except BaseException:
                self.groups[r]._shared.barrier.abort()  # the other ranks raise too
                raise

        futures = [self._pool.submit(one, r) for r in range(self.size)]
        return [f.result() for f in futures][0]

    def close(self) -> None:
        self._pool.shutdown(wait=True)
