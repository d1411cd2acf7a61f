"""Mixture-of-Experts FFN: top-k router + sort-based dispatch.

Port of ``repro/models/moe.py``'s GSPMD path (``apply_moe_gspmd``), the one
the reference takes without a mesh, so in every serving call:

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
the reference's ``zeros.at[t].add(v)``, on every device. The expert-parallel
path (``apply_moe_a2a``) runs only under a mesh and is not ported here.
"""

from __future__ import annotations

import torch
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


def _load_balance_aux(probs, e_real: int):
    """Switch-style load-balance loss from the (masked) router probs."""
    e_pad = probs.shape[-1]
    frac_tokens = F.one_hot(torch.argmax(probs, dim=-1), e_pad).float().mean(dim=0)
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


def apply_moe(p, x, cfg, capacity_factor: float | None = None):
    """x: [B, S, d] → ([B, S, d], aux dict). The reference's selector takes
    the GSPMD path whenever there is no mesh; the port has none."""
    return apply_moe_gspmd(p, x, cfg, capacity_factor)


def apply_moe_gspmd(p, x, cfg, capacity_factor: float | None = None):
    """x: [B, S, d] → ([B, S, d], {"moe_aux", "moe_drop_frac"})."""
    b, s, d = x.shape
    n = b * s
    e_real = cfg.moe.num_experts
    e_pad = p["router"].shape[-1]
    k = cfg.moe.top_k
    cf = capacity_factor or cfg.moe.capacity_factor
    if s == 1:
        # single-token decode: dropless (capacity drops would make decode
        # diverge from the training forward)
        cap = n * k
    else:
        cap = max(int(k * n * cf / e_real), 1)

    xt = x.reshape(n, d)
    probs, top_w, top_e = route(p["router"], xt, e_real, k)

    # ---- sort-based dispatch -------------------------------------------
    dev = x.device
    rec_e = top_e.reshape(-1)  # [N·k] int64
    rec_t = torch.arange(n, device=dev)[:, None].expand(n, k).reshape(-1)  # no host sync
    rec_w = top_w.reshape(-1)
    perm = torch.argsort(rec_e * (n + 1) + rec_t)  # unique keys: (expert, token) order
    e_s, t_s, w_s = rec_e[perm], rec_t[perm], rec_w[perm]
    slot = rank_in_segment(boundaries_from_keys(e_s))
    ok = slot < cap
    flat = torch.where(ok, e_s * cap + slot, e_pad * cap)  # overflow row, dropped
    x_e = torch.zeros((e_pad * cap + 1, d), dtype=x.dtype, device=dev)
    x_e[flat] = xt[t_s]
    x_e = x_e[:-1].view(e_pad, cap, d)

    # ---- expert computation ----------------------------------------------
    h = torch.bmm(x_e, p["wi"])
    g = torch.bmm(x_e, p["wg"])
    h = F.silu(g.float()).to(x.dtype) * h
    y_e = torch.bmm(h, p["wo"])

    # ---- combine back to token order, in a fixed order --------------------
    # clamped gather and a select (not a multiply): a dropped record adds an
    # exact 0 whatever its bucket row holds
    y_flat = y_e.reshape(e_pad * cap, d)
    src = torch.where(ok, flat, 0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    gathered = torch.where(ok[:, None], y_flat[src].float(), zero)
    contrib = gathered * torch.where(ok, w_s, zero)[:, None]
    y = combine_in_order(contrib, t_s, n, k)

    aux_loss = _load_balance_aux(probs, e_real)
    # a true division (a Python divisor becomes a reciprocal product on the card)
    dropped = (~ok).sum().float() / torch.full((), max(n * k, 1), dtype=torch.float32,
                                              device=dev)
    return y.view(b, s, d).to(x.dtype), {"moe_aux": aux_loss, "moe_drop_frac": dropped}
