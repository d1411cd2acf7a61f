"""Mixture-of-Experts FFN: top-k router + sort-based dispatch.

Port of ``repro/models/moe.py``. Its GSPMD path (``apply_moe_gspmd``), the
one the reference takes without a mesh and so in every serving call:

    1. router: float32 logits [N, E] → top-k (expert, weight) records (N·k)
    2. sort records by (expert, token); rank-in-segment gives per-expert slots
    3. scatter tokens into capacity buckets  x_e [E, C, d]
    4. two batched products with the expert weights, SiLU gate, a third
    5. add the weighted outputs back to token order, in a fixed order.

Tokens beyond an expert's capacity ``C = int(k·N·cf/E_real)`` are dropped
(counted in ``moe_drop_frac``); single-token decode is dropless. Padded
experts get a ``-1e30`` logit, an exact 0 after the softmax, so they are
never chosen. Ties in the top-k go to the lower expert id, as
``jax.lax.top_k`` resolves them.

Step 5 is where the card would part from the reference: a float32
``index_add_`` on the card adds with atomics, in an order that changes from
run to run. :func:`combine_in_order` adds each token's ``k`` contributions
one after another in the order of the records, which is XLA:CPU's order for
the reference's ``zeros.at[t].add(v)``, on every device.

Under a data-parallel group (``dp``, :class:`~repro_torch.dist.data_parallel.DataParallel`)
the block gives the reference's GSPMD step on the global batch, where rank
``r`` holds the ``r``-th part of the global tokens: the capacity comes from
the global token count; a record's slot is its rank-local slot plus the
records the lower ranks hold for its expert (an all-gather of per-expert
counts), which is its place in the global (expert, token) order; the
drop fraction is the global one. The load-balance loss is a product of two
global means: each rank takes ``E·Σ frac_tokens_global·frac_probs_local``
(the top-1 counts summed over the ranks; they carry no gradient), whose
mean over the ranks is the global value, and whose rank-averaged gradient
is the global gradient. A token's expert output does not depend on its
bucket-mates, so each rank multiplies only its own records.

:func:`apply_moe_a2a` is the reference's expert-parallel path: each of
``ep`` ranks holds a token shard and ``e_pad/ep`` experts; records travel to
their expert's rank and back through ``all_to_all`` (an autograd function
whose backward is the reverse exchange), or, for ``ep`` ranks run in one
process, a stacked transpose. :func:`apply_moe` is the reference's
selector.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.utils.segments import boundaries_from_keys, rank_in_segment


# Experts are padded up to a multiple of the reference's 16-way expert axis.
EP = 16


def init_moe(gen, cfg, dtype=torch.bfloat16, device="cuda"):
    d, f = cfg.d_model, cfg.d_ff
    e = cfg.moe.experts_padded(EP)
    return {
        "router": dense_init(gen, (d, e), 0, torch.float32, device),
        "wi": dense_init(gen, (e, d, f), 1, dtype, device),
        "wg": dense_init(gen, (e, d, f), 1, dtype, device),
        "wo": dense_init(gen, (e, f, d), 1, dtype, device),
    }


def moe_param_shapes(cfg) -> dict:
    """The shape of every leaf :func:`init_moe` makes."""
    d, f = cfg.d_model, cfg.d_ff
    e = cfg.moe.experts_padded(EP)
    return {"router": (d, e), "wi": (e, d, f), "wg": (e, d, f), "wo": (e, f, d)}


#: the logical axes of :func:`init_moe`'s leaves
MOE_AXES = {"router": ("embed", "experts"), "wi": ("experts", "embed", "ff"),
            "wg": ("experts", "embed", "ff"), "wo": ("experts", "ff", "embed")}


def _router_probs(router_w, xt, e_real: int):
    """Masked router softmax in float32 (padding experts get -1e30 logits)."""
    e_pad = router_w.shape[-1]
    logits = xt.float() @ router_w
    if e_pad > e_real:
        pad = torch.arange(e_pad, device=xt.device) >= e_real
        logits = logits.masked_fill(pad, -1e30)
    return torch.softmax(logits, dim=-1)


def route(router_w, xt, e_real: int, k: int):
    """(probs [N, E], top-k weights [N, k] normalised, top-k experts [N, k]).

    ``torch.topk`` promises no order among equal values; the first ``k`` of a
    stable descending sort take the lower expert id first, as ``lax.top_k``."""
    probs = _router_probs(router_w, xt, e_real)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, top_w, top_e


def _one_hot(idx, n: int):
    """``F.one_hot(idx, n)`` as one comparison on every device (ATen's
    ``one_hot`` takes another path on ``meta`` than on a card, so a traced
    step's count would not be the card's)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.int64)


def _load_balance_aux(probs, e_real: int):
    """Switch-style load-balance loss from the (masked) router probs."""
    e_pad = probs.shape[-1]
    frac_tokens = _one_hot(torch.argmax(probs, dim=-1), e_pad).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return e_real * torch.sum(frac_tokens * frac_probs)


def combine_in_order(values, index, n: int, k: int):
    """``zeros([n, d]).index_add_(0, index, values)`` for an ``index`` that
    names every row exactly ``k`` times, with each row's values added one
    after another in the order they come (XLA:CPU's order for
    ``zeros.at[index].add(values)``), starting from 0.0, on every device."""
    order = torch.sort(index, stable=True).indices.view(n, k)  # row t's records, in order
    out = torch.zeros((n, values.shape[-1]), dtype=values.dtype, device=values.device)
    for j in range(k):
        out = out + values[order[:, j]]
    return out


def apply_moe(p, x, cfg, capacity_factor: float | None = None, *, dp=None, ep=None, tp=None):
    """x: [B, S, d] → ([B, S, d], aux dict). The reference's selector: the
    expert-parallel path when the config asks for it (``moe.impl ==
    "a2a"``) and there is an expert group ``ep`` (``p`` and ``x`` are then
    this rank's experts and token shard, or lists of the hosted ranks');
    else the GSPMD path, under the data-parallel group ``dp`` when given.
    The reference takes the a2a path only when its expert axis divides the
    sequence; a shard here is already the sequence split over ``ep``, and a
    one-position step (decode, where the reference's S = 1 divides no expert
    axis above 1) takes the GSPMD path, over the model group ``tp`` when
    given."""
    x0 = x[0] if isinstance(x, (list, tuple)) else x
    if cfg.moe.impl == "a2a" and ep is not None and (x0.shape[1] > 1 or ep.size == 1):
        return apply_moe_a2a(p, x, cfg, ep, capacity_factor, dp=dp)
    return apply_moe_gspmd(p, x, cfg, capacity_factor, group=dp, tp=tp)


def _true_div(num: torch.Tensor, den: int) -> torch.Tensor:
    # a true division (a Python divisor becomes a reciprocal product on the card)
    return num.float() / torch.full((), max(den, 1), dtype=torch.float32, device=num.device)


def _expert_ffn(x_e, p):
    """The experts' gated products on their buckets: [E, C, d] → [E, C, d]."""
    h = torch.bmm(x_e, p["wi"])
    g = torch.bmm(x_e, p["wg"])
    h = F.silu(g.float()).to(x_e.dtype) * h
    return torch.bmm(h, p["wo"])


def _experts_tp(x_e, p, cfg, tp):
    """The experts' products on the buckets ``x_e`` [E, C, d] (the same on
    every model rank) under the model group ``tp``. Where the group splits
    the padded experts, each rank multiplies its experts' buckets and an
    all-gather returns every bucket (the combine then runs as on one
    device); where it splits each expert's ``ff`` instead, each rank
    computes its part of every product and one reduce adds them; otherwise
    every rank multiplies every bucket."""
    e, _, d = x_e.shape
    f = cfg.d_ff
    shapes = {"wi": (e, d, f), "wg": (e, d, f), "wo": (e, f, d)}
    w = {k: p[k] for k in shapes}
    if tp.splits(e):
        local = {k: tp.take(v, MOE_AXES[k], shapes[k], 0) for k, v in w.items()}
        return tp.gather_dim(_expert_ffn(tp.scatter(x_e, 0), local), 0)
    if tp.splits(f):
        local = {k: tp.take(v, MOE_AXES[k], shapes[k], 1 if k == "wo" else 2)
                 for k, v in w.items()}
        return tp.reduce(_expert_ffn(tp.copy(x_e), local))
    whole = tp.whole(w, MOE_AXES, shapes)
    return _expert_ffn(x_e, whole)


def _top1_counts(probs):
    """Tokens whose largest router probability is each expert's: [E] int64."""
    e_pad = probs.shape[-1]
    return _one_hot(torch.argmax(probs, dim=-1), e_pad).sum(dim=0)


def _aux_from_counts(counts, n: int, probs, e_real: int):
    """``E·Σ frac_tokens·frac_probs`` with the top-1 counts of ``n`` tokens
    (every rank's) and this rank's router probabilities."""
    return e_real * torch.sum(_true_div(counts, n) * probs.mean(dim=0))


def apply_moe_gspmd(p, x, cfg, capacity_factor: float | None = None, group=None, tp=None,
                    experts=None):
    """x: [B, S, d] → ([B, S, d], {"moe_aux", "moe_drop_frac"}). ``group``:
    a data-parallel group over which ``x`` is this rank's part of the global
    tokens; the block then gives the global step's capacity, slots and drop
    fraction and this rank's term of its load-balance loss (the module's
    docstring). Every rank issues the same collectives in the same order
    (the block runs again under remat). ``tp``: the model group; ``p`` is
    then this model rank's view of the stored leaves. Routing, capacity,
    slots and the load-balance loss are computed alike on every model rank,
    the experts' products are split (:func:`_experts_tp`). ``experts``:
    ``(x_e [E, C, d], p) -> y_e``, the experts' products on the buckets, in
    place of every bucket multiplied here (``models/tp_ranks.py`` runs a
    model group's ranks through it in one process)."""
    ranks = 1 if group is None else group.size
    b, s, d = x.shape
    n_l = b * s
    n = n_l * ranks  # the global token count
    e_real = cfg.moe.num_experts
    if tp is not None:  # the router whole on every model rank
        p = dict(p, router=tp.take(p["router"], MOE_AXES["router"],
                                   (d, cfg.moe.experts_padded(EP)), None, partial=False))
    e_pad = p["router"].shape[-1]
    k = cfg.moe.top_k
    cf = capacity_factor or cfg.moe.capacity_factor
    if s == 1:
        # single-token decode: dropless (capacity drops would make decode
        # diverge from the training forward)
        cap = n * k
    else:
        cap = max(int(k * n * cf / e_real), 1)
    # the rank's buckets: it keeps at most n_l records an expert (a token's
    # top-k experts are distinct)
    cap_l = cap if ranks == 1 else min(cap, n_l)

    xt = x.reshape(n_l, d)
    probs, top_w, top_e = route(p["router"], xt, e_real, k)

    # ---- sort-based dispatch -------------------------------------------
    dev = x.device
    rec_e = top_e.reshape(-1)  # [N·k] int64
    rec_t = torch.arange(n_l, device=dev)[:, None].expand(n_l, k).reshape(-1)  # no host sync
    rec_w = top_w.reshape(-1)
    perm = torch.argsort(rec_e * (n_l + 1) + rec_t)  # unique keys: (expert, token) order
    e_s, t_s, w_s = rec_e[perm], rec_t[perm], rec_w[perm]
    slot = rank_in_segment(boundaries_from_keys(e_s))
    if ranks == 1:
        ok = slot < cap
    else:
        # the lower ranks hold the earlier global tokens: their records of an
        # expert come first in the global (expert, token) order
        counts = torch.zeros(e_pad, dtype=torch.int64, device=dev).index_add_(
            0, rec_e, torch.ones_like(rec_e))
        ok = slot + group.gather(counts)[:group.rank].sum(dim=0)[e_s] < cap
    flat = torch.where(ok, e_s * cap_l + slot, e_pad * cap_l)  # overflow row, dropped
    x_e = torch.zeros((e_pad * cap_l + 1, d), dtype=x.dtype, device=dev)
    x_e[flat] = xt[t_s]
    x_e = x_e[:-1].view(e_pad, cap_l, d)

    # ---- expert computation ----------------------------------------------
    if experts is None:
        experts = _expert_ffn if tp is None else lambda x_, p_: _experts_tp(x_, p_, cfg, tp)
    y_e = experts(x_e, p)

    # ---- combine back to token order, in a fixed order --------------------
    # clamped gather and a select (not a multiply): a dropped record adds an
    # exact 0 whatever its bucket row holds
    y_flat = y_e.reshape(e_pad * cap_l, d)
    src = torch.where(ok, flat, 0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    gathered = torch.where(ok[:, None], y_flat[src].float(), zero)
    contrib = gathered * torch.where(ok, w_s, zero)[:, None]
    y = combine_in_order(contrib, t_s, n_l, k)

    if ranks == 1:
        aux_loss, n_drop = _load_balance_aux(probs, e_real), (~ok).sum()
    else:
        aux_loss = _aux_from_counts(group.sum(_top1_counts(probs)), n, probs, e_real)
        n_drop = group.sum((~ok).sum())
    dropped = _true_div(n_drop, n * k)
    return y.view(b, s, d).to(x.dtype), {"moe_aux": aux_loss, "moe_drop_frac": dropped}


# ---------------------------------------------------------------------------
# The expert-parallel path: explicit all_to_all dispatch
# ---------------------------------------------------------------------------
#
# Layout (the reference's): tokens enter as this rank's shard [B/dp, S/ep, d];
# the experts are split over the ep ranks (e_local = e_pad/ep each). Each rank
#   1. routes its n_local tokens (the router is replicated),
#   2. packs per-destination-rank buckets [ep, cap_r, d] (overflow dropped),
#   3. exchanges them (all_to_all) with the records' local expert ids,
#   4. dispatches what it received over its e_local experts (a second
#      capacity, cap_e) and runs them,
#   5. sends the outputs back and adds them, weighted, in token order.


def _dispatch_to_buckets(vals, keys, n_buckets: int, cap: int, fill=0.0):
    """Scatter ``vals`` rows into ``[n_buckets, cap, ...]`` by ``keys`` in a
    stable sorted order; returns ``(buckets, sort_order, flat_slot_per_row,
    ok_mask)``. Rows past a bucket's capacity, or with a key of
    ``n_buckets`` or more, are dropped (their flat slot is the overflow row
    ``n_buckets·cap``)."""
    order = torch.sort(keys, stable=True).indices
    k_s = keys[order]
    slot = rank_in_segment(boundaries_from_keys(k_s))
    ok = (slot < cap) & (k_s < n_buckets)
    flat = torch.where(ok, k_s * cap + slot, n_buckets * cap)
    buckets = torch.full((n_buckets * cap + 1,) + tuple(vals.shape[1:]), fill,
                         dtype=vals.dtype, device=vals.device)
    buckets[flat] = vals[order]
    return buckets[:-1].reshape((n_buckets, cap) + tuple(vals.shape[1:])), order, flat, ok


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 (``x[d]`` goes to rank ``d``); its
    gradient is the reverse exchange."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=pg)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.pg)
        return out, None


def _exchange(ep, bucks: list) -> list:
    """The hosted ranks' ``[ep, ...]`` buckets → what each received: row
    ``s`` of rank ``d``'s result is row ``d`` of rank ``s``'s buckets. A
    stacked transpose when every rank is in this process, else
    ``all_to_all_single`` over the group (also a group of one)."""
    if ep.group is None:
        stacked = torch.stack(bucks)  # [src, dst, ...]
        return list(stacked.transpose(0, 1).unbind(0))
    if not ep.group.active:  # a world of one with no process group
        return bucks
    return [_AllToAll.apply(bucks[0], ep.group.pg)]


def _rank_sum(ep, dp, parts: list) -> torch.Tensor:
    """The hosted ranks' values summed over every expert rank in rank order,
    then over the data-parallel ranks."""
    g = ep.gather(parts)
    acc = g[0]
    for r in range(1, g.shape[0]):
        acc = acc + g[r]
    return acc if dp is None else dp.sum(acc)


def apply_moe_a2a(p_local, x_local, cfg, ep, capacity_factor: float | None = None, dp=None):
    """Expert-parallel MoE: the reference's ``apply_moe_a2a``, one rank's
    part (or, with every rank in this process, lists of every rank's).

    ``ep``: a :class:`~repro_torch.core.query_engine.RankSet` of the expert
    ranks, over a process group or with every rank hosted here. ``p_local``:
    the router and this rank's ``e_pad/ep`` experts' ``wi``, ``wg``, ``wo``;
    ``x_local``: this rank's token shard ``[B_l, S_l, d]``. ``dp``: the
    data-parallel group across replicas of the expert group, if any. Returns
    ``(y_local, {"moe_aux", "moe_drop_frac"})`` (lists of ``y`` and of aux
    dicts for hosted ranks): ``moe_drop_frac`` is the mean over every rank
    of each shard's two-stage drop fraction (the reference's ``pmean``), and
    ``moe_aux`` this rank's term of the load-balance loss of the global
    tokens, whose mean over the ranks is the reference's value.
    """
    hosted = len(ep.hosted)
    ps = [p_local] if hosted == 1 else list(p_local)
    xs = [x_local] if hosted == 1 else list(x_local)
    epn = ep.size
    e_pad = ps[0]["router"].shape[-1]
    e_real = cfg.moe.num_experts
    k = cfg.moe.top_k
    cf = capacity_factor or cfg.moe.capacity_factor
    if e_pad % epn:
        raise ValueError(f"{e_pad} padded experts do not split over {epn} expert ranks")
    e_local = e_pad // epn
    b_l, s_l, d = xs[0].shape
    n_l = b_l * s_l
    cap_r = max(int(k * n_l * cf / epn), 1)  # per destination rank
    cap_e = max(int(2 * epn * cap_r / e_local), 1)  # per local expert
    dev = xs[0].device

    # ---- route and pack per-rank buckets ------------------------------------
    sent = []
    for p, x in zip(ps, xs):
        xt = x.reshape(n_l, d)
        probs, top_w, top_e = route(p["router"], xt, e_real, k)
        rec_e = top_e.reshape(-1)
        rec_t = torch.arange(n_l, device=dev)[:, None].expand(n_l, k).reshape(-1)
        buckets, order, flat, ok = _dispatch_to_buckets(xt[rec_t], rec_e // e_local, epn,
                                                        cap_r)
        eid = torch.full((epn * cap_r + 1,), -1, dtype=torch.int64, device=dev)
        eid[flat] = torch.where(ok, (rec_e % e_local)[order], -1)
        sent.append({"probs": probs, "w": top_w.reshape(-1), "t": rec_t, "order": order,
                     "flat": flat, "ok": ok, "buckets": buckets,
                     "eid": eid[:-1].reshape(epn, cap_r)})
    recv = _exchange(ep, [r["buckets"] for r in sent])
    recv_eid = [e.reshape(-1) for e in _exchange(
        ep, [r["eid"].to(torch.int32) for r in sent])]

    # ---- each rank's experts on what it received ----------------------------
    y_recv, drop2 = [], []
    for p, rx, reid in zip(ps, recv, recv_eid):
        rx = rx.reshape(epn * cap_r, d)
        key2 = torch.where(reid >= 0, reid.to(torch.int64), e_local)
        x_e, order2, flat2, ok2 = _dispatch_to_buckets(rx, key2, e_local, cap_e)
        y_e = _expert_ffn(x_e, p).reshape(e_local * cap_e, d)
        y_pad = torch.cat([y_e, y_e.new_zeros((1, d))])
        back = torch.zeros((epn * cap_r, d), dtype=y_e.dtype, device=dev)
        back[order2] = y_pad[torch.clamp(flat2, max=e_local * cap_e)]
        y_recv.append(back.reshape(epn, cap_r, d))
        # ok2 is False for overflowed and for empty slots: count only the
        # slots that carried a record
        drop2.append((reid >= 0).sum() - ok2.sum())
    back = _exchange(ep, y_recv)

    # ---- combine in token order, and the accounting --------------------------
    ys, drops, top1 = [], [], []
    for r, bk, d2 in zip(sent, back, drop2):
        bk = bk.reshape(epn * cap_r, d)
        back_pad = torch.cat([bk, bk.new_zeros((1, d))])
        per_rec = back_pad[torch.clamp(r["flat"], max=epn * cap_r)]
        w = torch.where(r["ok"], r["w"][r["order"]], torch.zeros((), device=dev))
        contrib = per_rec.float() * w[:, None]
        y = combine_in_order(contrib, r["t"][r["order"]], n_l, k)
        ys.append(y.view(b_l, s_l, d).to(xs[0].dtype))
        drops.append(_true_div((~r["ok"]).sum(), n_l * k) + _true_div(d2, n_l * k))
        top1.append(_top1_counts(r["probs"]))
    n_ranks = epn * (1 if dp is None else dp.size)
    dropped = _rank_sum(ep, dp, drops) / torch.full((), n_ranks, dtype=torch.float32,
                                                     device=dev)
    counts = _rank_sum(ep, dp, top1)
    auxes = [{"moe_aux": _aux_from_counts(counts, n_l * n_ranks, r["probs"], e_real),
              "moe_drop_frac": dropped} for r in sent]
    if hosted == 1:
        return ys[0], auxes[0]
    return ys, auxes
