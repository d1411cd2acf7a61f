"""Plain SSumM quantities of a partition, worked out from the input edge list.

Straight from the paper's definitions (SSumM, KDD 2020, Sect. 3): the
supernode-pair table ``{A,B} → |E_AB|``, ``|Π_AB|``, the tight per-superedge
cost C̄ (footnote 3), the optimal pair cost, Cost*_A (Eq. 16), the keep rule
(Eq. 11 with the RE guard of footnote 3), the drop increase of footnote 4,
and Size (Eq. 4), RE₁ and RE₂ (Eq. 2) of a summary. Plain PyTorch on the CPU,
in the dtype asked for: float64 for the reference, bfloat16 for the control.
Nothing here reads anything the program made but what is judged.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench.reference import kernels


def sizes(node2super: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Subnodes in each supernode id, int64[V]."""
    return torch.bincount(node2super.long(), minlength=num_nodes)


def pair_table(src: torch.Tensor, dst: torch.Tensor, node2super: torch.Tensor,
               num_nodes: int):
    """``(lo, hi, cnt)`` of every supernode pair with at least one edge,
    ascending by ``lo·V + hi``; self pairs have ``lo == hi``."""
    n2s = node2super.long()
    su, sv = n2s[src], n2s[dst]
    key = torch.minimum(su, sv) * num_nodes + torch.maximum(su, sv)
    key, cnt = np.unique(key.numpy(), return_counts=True)  # sorted
    key, cnt = torch.from_numpy(key), torch.from_numpy(cnt).long()
    return key // num_nodes, key % num_nodes, cnt


def pair_pi(lo, hi, size) -> torch.Tensor:
    """|Π_AB| as exact int64: n_A·n_B, or n_A(n_A − 1)/2 for the self pair."""
    na, nb = size[lo], size[hi]
    return torch.where(lo == hi, na * (na - 1) // 2, na * nb)


def log2_clamped(x, dtype) -> torch.Tensor:
    return torch.log2(torch.clamp(torch.as_tensor(x, dtype=dtype), min=2.0))


def cbar_tight(num_supernodes, omega_max, dtype) -> torch.Tensor:
    """C̄ = 2log₂|S| + log₂ω_max (footnote 3), each at least 1 bit."""
    return 2.0 * log2_clamped(num_supernodes, dtype) + log2_clamped(omega_max, dtype)


def total_costs(lo, hi, cnt, pi, cbar, log2v, num_nodes: int, dtype) -> torch.Tensor:
    """Cost*_A (Eq. 16) of every supernode id: each pair's optimal cost added
    to both its ends, a self pair's once."""
    cost = kernels.pair_cost(cnt.to(dtype), pi.to(dtype), cbar, log2v)
    out = torch.zeros(num_nodes, dtype=dtype)
    out.index_add_(0, lo, cost)
    out.index_add_(0, hi, torch.where(lo != hi, cost, torch.zeros((), dtype=dtype)))
    return out


def mdl_keep(cnt, pi, size, lo, hi, cbar, log2v):
    """Eq. (11) with the RE₁ guard on pairs touching a merged supernode; a
    pair of two singletons stays. Returns ``(keep, margin)``: ``margin`` is
    how far each touched pair's decision lies from its nearest tie, as a
    share of the compared bits (``inf`` where no tie is near), float64."""
    cnt_f, pi_f = cnt.double(), pi.double()
    lhs = cbar + kernels.entropy_bits(cnt_f, pi_f)
    rhs = 2.0 * cnt_f * log2v
    sigma = cnt_f / torch.clamp(pi_f, min=1.0)
    decided = (lhs < rhs) & (cnt > 0) & (2.0 * sigma - 1.0 >= 0.0)
    touched = (size[lo] > 1) | (size[hi] > 1)
    keep = torch.where(touched, decided, cnt > 0)
    margin = torch.minimum((lhs - rhs).abs() / torch.clamp(rhs, min=1.0),
                           (2.0 * sigma - 1.0).abs())
    margin = torch.where(touched, margin, torch.full((), math.inf, dtype=torch.float64))
    return keep, margin


def drop_increase(cnt, pi) -> torch.Tensor:
    """Footnote 4's ΔRE₁ of dropping a kept superedge, (2σ − 1)·|E_AB|, float64."""
    cnt_f = cnt.double()
    return (2.0 * cnt_f / torch.clamp(pi.double(), min=1.0) - 1.0) * cnt_f


def summary_metrics(num_nodes: int, num_supernodes, kept_cnt, kept_pi, dropped_cnt,
                    dtype) -> dict[str, torch.Tensor]:
    """Size (Eq. 4), RE₁ and RE₂ (Eq. 2) of a summary whose kept superedges
    have weights ``kept_cnt`` over ``kept_pi`` subnode pairs and whose other
    pairs hold ``dropped_cnt`` edges, which the summary reconstructs as 0.
    A kept superedge of density σ reconstructs each of its pairs as σ: its ℓ1
    error is 2|E|(1 − σ) and its squared ℓ2 error |E|(1 − σ), per unordered
    pair set; the full matrix counts each twice."""
    cnt = kept_cnt.to(dtype)
    pi = kept_pi.to(dtype)
    v = torch.as_tensor(num_nodes, dtype=dtype)
    log2s = log2_clamped(num_supernodes, dtype)
    omega = cnt.max() if cnt.numel() else torch.zeros((), dtype=dtype)
    size_bits = cnt.numel() * (2.0 * log2s + log2_clamped(omega, dtype)) + v * log2s
    one_m = 1.0 - cnt / torch.clamp(pi, min=1.0)
    dropped = dropped_cnt.to(dtype).sum()
    l1 = (2.0 * cnt * one_m).sum() + dropped
    l2 = (cnt * one_m).sum() + dropped
    denom = v * (v - 1.0)
    return {"size_bits": size_bits, "re1": 2.0 * l1 / denom,
            "re2": torch.sqrt(2.0 * l2) / denom}


def group_tables(lo, hi, cnt, size, members, max_neighbors: int, union_size: int,
                 num_nodes: int):
    """The union-space tables of the groups ``members`` (int64 [G, C], -1 a
    padding member) at a partition with pair table ``(lo, hi, cnt)``
    (ascending by ``lo·V + hi``) and sizes ``size``. Each live member keeps
    its ``D`` heaviest neighbouring supernodes, equal counts in the pair
    table's order (first the pairs where it is the lower end, then those
    where it is the upper); a group's union columns are its members' kept
    neighbours in ascending id order, cut to the first ``U``. Returns int64
    ``(m [G,C,U], n_u [G,U], cidx [G,C], w [G,C,C])``: each member's count
    at each column, each column's size, each live member's own column (``U``
    where absent) and each member pair's count as either row holds it."""
    v, d, u = num_nodes, max_neighbors, union_size
    g, c = members.shape
    mid = members.clamp(0, v - 1)
    live = (members >= 0) & (size[mid] > 0)
    ids = torch.unique(mid[live])
    nonself = lo != hi
    pos = torch.arange(lo.numel())
    as_lo = nonself & torch.isin(lo, ids)
    as_hi = nonself & torch.isin(hi, ids)
    owner = torch.cat([lo[as_lo], hi[as_hi]])
    other = torch.cat([hi[as_lo], lo[as_hi]])
    count = torch.cat([cnt[as_lo], cnt[as_hi]])
    tie = torch.cat([pos[as_lo], lo.numel() + pos[as_hi]])
    order = torch.from_numpy(np.lexsort((tie.numpy(), -count.numpy(), owner.numpy())))
    owner, other, count = owner[order], other[order], count[order]
    rank = torch.arange(owner.numel()) - torch.searchsorted(owner, owner)
    keep = rank < d
    row = torch.searchsorted(ids, owner[keep])
    nbr = torch.full((ids.numel(), d), v, dtype=torch.int64)
    nbr_cnt = torch.zeros((ids.numel(), d), dtype=torch.int64)
    nbr[row, rank[keep]] = other[keep]
    nbr_cnt[row, rank[keep]] = count[keep]

    r = torch.searchsorted(ids, mid).clamp(max=max(ids.numel() - 1, 0))
    if ids.numel() == 0:
        nbr, nbr_cnt = torch.full((1, d), v), torch.zeros((1, d), dtype=torch.int64)
    tab_id = torch.where(live[..., None], nbr[r], v)  # [G, C, D]
    tab_cnt = torch.where(live[..., None], nbr_cnt[r], 0)
    m = torch.zeros((g, c, u), dtype=torch.int64)
    uid = torch.full((g, u), v, dtype=torch.int64)
    for k in range(g):
        cols = torch.unique(tab_id[k][tab_id[k] < v])[:u]
        uid[k, :cols.numel()] = cols
        at = torch.searchsorted(cols, tab_id[k]).clamp(max=max(cols.numel() - 1, 0))
        hit = (tab_id[k] < v) & (at < cols.numel())
        hit &= cols[at] == tab_id[k] if cols.numel() else torch.zeros_like(hit)
        i, j = torch.nonzero(hit, as_tuple=True)
        m[k, i, at[i, j]] = tab_cnt[k, i, j]
    n_u = torch.where(uid < v, size[uid.clamp(max=v - 1)], 0)
    own = (uid[:, None, :] == mid[:, :, None]) & live[..., None]  # [G, C, U]
    cidx = torch.where(own.any(-1), own.to(torch.int64).argmax(-1), u)
    w1 = torch.gather(m, 2, cidx.clamp(max=u - 1)[:, None, :].expand(g, c, c))
    w1 = torch.where((cidx < u)[:, None, :], w1, 0)
    return m, n_u, cidx, torch.maximum(w1, w1.transpose(1, 2))
