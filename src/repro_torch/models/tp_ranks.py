"""The ranks of a tensor-parallel layer, one after another in one process.

Each function runs the per-rank code of one of the model group's layers
(``dist/tensor_parallel.py``) for every rank of a group of ``size``, on the
part of the whole leaves that rank reads, and combines the parts in rank
order, as the layer's collective does: the MLP on each rank's ``ff``
columns, attention on its heads, the embedding lookup and the loss on its
vocab part, the MoE block's products on its experts (or on each expert's
``ff`` part). A rank's leaves are slices of the whole leaves, so the
gradients come back as the whole leaves'. ``chip_smoke.py`` phase 19b and
the CPU tests hold these against the unsplit layers; the trainer runs the
same per-rank code, one rank a process.
"""

from __future__ import annotations

import torch

from repro_torch.dist.data_parallel import add_in_order
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import apply_mlp
from repro_torch.models.losses import lm_total, sum_exp, target_logit
from repro_torch.models.transformer import embed_part, scale_embedding


def _part(n: int, rank: int, size: int) -> slice:
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def mlp(p, x, act: str, size: int):
    """The gated MLP, ``ff`` split over ``size`` ranks: column-parallel
    ``wi``/``wg``, row-parallel ``wo``, the partial outputs added."""
    parts = []
    for m in range(size):
        sl = _part(p["wi"].shape[1], m, size)
        parts.append(apply_mlp({"wi": p["wi"][:, sl], "wg": p["wg"][:, sl], "wo": p["wo"][sl]},
                               x, act))
    return add_in_order(parts)


def attention(p, x, cfg, size: int, **kw):
    """Head-parallel attention: each rank's query heads (its KV heads where
    the ranks split them, else every KV head), ``wo`` on its heads, the
    partial outputs added."""
    parts = []
    for m in range(size):
        (h0, h1), kv_idx = attn.head_part(cfg, m, size)
        local = {"wq": p["wq"][:, h0:h1], "wo": p["wo"][h0:h1]}
        if "bq" in p:
            local["bq"] = p["bq"][h0:h1]
        kv = _part(cfg.n_kv_heads, m, size) if kv_idx is None else slice(None)
        local.update(wk=p["wk"][:, kv], wv=p["wv"][:, kv])
        if "bk" in p:
            local.update(bk=p["bk"][kv], bv=p["bv"][kv])
        parts.append(attn.attention(local, x, cfg, kv_idx=None if kv_idx is None
                                    else kv_idx.to(x.device), **kw))
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
