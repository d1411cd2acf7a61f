"""Per-group neighbor tables: the operands of the merge-gain kernel.

Port of ``repro/core/tables.py`` (``GroupTables``, ``build_neighbor_tables``,
``build_neighbor_tables_compact``, ``supernode_total_costs_compact``,
``build_group_tables``, ``assemble_group_tables``). For every candidate group
of ``C`` supernodes, the distinct neighbors of all members are given up to
``U`` columns, so member ``i``'s neighbor multiset is a row ``m[i]`` and a
merged pair's is ``m[i] + m[j]``.

Scoring sees the top-``D`` heaviest neighbors of each member; what falls off
the tables is carried by the exact per-supernode totals ``t`` as a tail held
constant under a hypothetical merge.

The reference's ``.at[...].set/min/add(mode="drop")`` scatters become
``scatter_``, ``scatter_reduce_`` (``amin``, ``include_self=True``) and
``index_add_`` onto a tensor with one sentinel slot that is then sliced off.
The union-space part of the assembly is a hand kernel
(``kernels/csrc/group_tables.cu``), its plain version
``kernels/ref.py::group_tables_ref``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import costs
from repro_torch.core.types import PairTable, SummaryState
from repro_torch.kernels import ops
from repro_torch.utils import boundaries_from_keys, rank_in_segment
from repro_torch.utils.spans import span

F32 = torch.float32


@dataclasses.dataclass
class GroupTables:
    """Operands for one merge-gain evaluation over all groups."""

    m: torch.Tensor  # float32[G, C, U]  member→union-neighbor subedge counts
    n: torch.Tensor  # float32[G, C]    member supernode sizes (0 = padding)
    s: torch.Tensor  # float32[G, C]    member self-loop subedge counts
    t: torch.Tensor  # float32[G, C]    exact Cost*_A(S) totals
    n_u: torch.Tensor  # float32[G, U]  union-neighbor supernode sizes
    cidx: torch.Tensor  # int32[G, C]   member's own column in U (U = absent)
    w: torch.Tensor  # float32[G, C, C] within-group pair subedge counts
    members: torch.Tensor  # int64[G, C] supernode ids (-1 = padding)


def build_neighbor_tables(pt: PairTable, num_nodes: int, max_neighbors: int
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-``D`` heaviest neighbors per supernode + self-loop counts.

    Returns ``(nbr_id int64[V, D], nbr_cnt float32[V, D], self_cnt
    float32[V])`` with ``nbr_id == V`` marking empty slots.
    """
    v, d = num_nodes, max_neighbors
    nonself = pt.valid & (pt.lo != pt.hi)
    # two directed entries per undirected pair
    owner = torch.cat([pt.lo, pt.hi])
    other = torch.cat([pt.hi, pt.lo])
    cnt = torch.cat([pt.cnt, pt.cnt])
    val = torch.cat([nonself, nonself])
    owner_k = torch.where(val, owner, v)  # invalid entries last
    neg_cnt = torch.where(val, -cnt.to(torch.int64), 0)
    # The order of (owner, -cnt) decides which neighbors survive the top-D
    # cut, and among equal counts ties keep concatenation order (every hub
    # loses some). One composite int64 key — cnt is an exact integer, at
    # most cmax — under a *stable* sort reproduces the reference's order.
    cmax = cnt.max().to(torch.int64)
    key = owner_k * (cmax + 1) + (neg_cnt + cmax)
    order = torch.sort(key, stable=True).indices
    owner_s, other_s, cnt_s, val_s = owner_k[order], other[order], cnt[order], val[order]
    rank = rank_in_segment(boundaries_from_keys(owner_s))
    keep = (rank < d) & val_s
    flat = torch.where(keep, owner_s * d + rank, v * d)  # sentinel slot v*d
    nbr_id = torch.full((v * d + 1,), v, dtype=torch.int64, device=owner.device)
    nbr_id = nbr_id.scatter_(0, flat, other_s)[:-1]
    nbr_cnt = torch.zeros(v * d + 1, dtype=F32, device=owner.device)
    nbr_cnt = nbr_cnt.scatter_(0, flat, cnt_s)[:-1]

    # a supernode has at most one self pair, so a scatter does what the
    # reference's scatter-add does, without atomics piling onto the sentinel
    is_self = pt.valid & (pt.lo == pt.hi)
    self_cnt = torch.zeros(v + 1, dtype=F32, device=owner.device).scatter_(
        0, torch.where(is_self, pt.lo, v), pt.cnt)[:-1]
    return nbr_id.reshape(v, d), nbr_cnt.reshape(v, d), self_cnt


def build_neighbor_tables_compact(plo, phi, cnt, valid, slot_of: torch.Tensor,
                                  n_rows: int, num_nodes: int, max_neighbors: int
                                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-``D`` neighbor tables of the rows one rank owns (the compact
    grouping): ``[n_rows, D]`` instead of ``[V, D]``, rows mapped through
    ``slot_of`` (``int64[V]``, -1 = not owned here). The pair rows must be
    in range (``plo``/``phi`` in ``[0, V)``, invalid rows masked by
    ``valid``). Returns ``(nbr_id int64[n_rows, D], nbr_cnt float32[n_rows,
    D], self_cnt float32[n_rows])``; ``nbr_id == V`` marks an empty slot.
    """
    v, d = num_nodes, max_neighbors
    nonself = valid & (plo != phi)
    owner = torch.cat([plo, phi])
    other = torch.cat([phi, plo])
    cnt2 = torch.cat([cnt, cnt])
    row = slot_of[owner]
    val = torch.cat([nonself, nonself]) & (row >= 0)
    row_k = torch.where(val, row, n_rows)  # invalid entries last
    neg_cnt = torch.where(val, -cnt2.to(torch.int64), 0)
    # (row, -cnt) as one int64 key under a stable sort: the reference's order
    cmax = cnt2.max().to(torch.int64)
    key = row_k * (cmax + 1) + (neg_cnt + cmax)
    order = torch.sort(key, stable=True).indices
    row_s, other_s, cnt_s, val_s = row_k[order], other[order], cnt2[order], val[order]
    rank = rank_in_segment(boundaries_from_keys(row_s))
    keep = (rank < d) & val_s
    flat = torch.where(keep, row_s * d + rank, n_rows * d)  # sentinel slot
    nbr_id = torch.full((n_rows * d + 1,), v, dtype=torch.int64, device=plo.device)
    nbr_id = nbr_id.scatter_(0, flat, other_s)[:-1]
    nbr_cnt = torch.zeros(n_rows * d + 1, dtype=F32, device=plo.device)
    nbr_cnt = nbr_cnt.scatter_(0, flat, cnt_s)[:-1]

    # at most one self pair a row: a scatter, as in build_neighbor_tables
    self_row = slot_of[plo]
    ok_self = valid & (plo == phi) & (self_row >= 0)
    self_cnt = torch.zeros(n_rows + 1, dtype=F32, device=plo.device).scatter_(
        0, torch.where(ok_self, self_row, n_rows), cnt)[:-1]
    return nbr_id.reshape(n_rows, d), nbr_cnt.reshape(n_rows, d), self_cnt


def supernode_total_costs_compact(plo, phi, cnt, valid, slot_of: torch.Tensor,
                                  n_rows: int, num_nodes: int, sizes: torch.Tensor,
                                  scal: torch.Tensor, num_edges: int,
                                  backend: str | None = None) -> torch.Tensor:
    """``Cost*_A(S)`` per owned row from the rank's pair records, float32[n_rows].

    The per-pair cost is the pair-cost kernel (``ops.pair_cost``), where the
    reference computes ``pair_cost_star`` with jnp (``tables.py:135``);
    ``scal = (cbar, log2v)``. As in ``costs.supernode_total_costs``, the
    totals must not depend on the order of the adds: on the CPU they take
    the reference's float32 chain (every ``lo`` add in row order, then every
    ``hi`` add), on the card :func:`~repro_torch.core.costs.exact_index_sum`.
    ``num_edges`` (the global |E|) bounds every total by 2|E|log₂V.
    """
    zero = torch.zeros((), dtype=F32, device=cnt.device)
    na = sizes[plo].to(F32)
    nb = sizes[phi].to(F32)
    pi = torch.where(plo == phi, na * (na - 1.0) * 0.5, na * nb)
    cost = torch.where(valid, ops.pair_cost(cnt, pi, scal, backend=backend), zero)
    row_lo = torch.where(valid, slot_of[plo], -1)
    row_hi = torch.where(valid & (plo != phi), slot_of[phi], -1)
    idx = tuple(torch.where(r >= 0, r, n_rows) for r in (row_lo, row_hi))  # sentinel
    vals = tuple(torch.where(r >= 0, cost, zero) for r in (row_lo, row_hi))
    if cnt.is_cuda:
        bound = 2.0 * max(num_edges, 1) * math.log2(max(num_nodes, 2))
        return costs.exact_index_sum(n_rows + 1, idx, vals, bound)[:-1]
    out = torch.zeros(n_rows + 1, dtype=F32, device=cnt.device)
    for i, x in zip(idx, vals):
        out.index_add_(0, i, x)
    return out[:-1]


def build_group_tables(pt: PairTable, state: SummaryState, groups: torch.Tensor,
                       max_neighbors: int, union_size: int, scal: torch.Tensor,
                       num_nodes: int, backend: str | None = None) -> GroupTables:
    """Assemble the dense union-space operands for every group.

    ``scal = (cbar, log2v)`` feeds the pair-cost kernel of the exact totals.
    """
    with span("ssumm.neighbor_tables"):
        nbr_id, nbr_cnt, self_cnt = build_neighbor_tables(pt, num_nodes, max_neighbors)
    with span("ssumm.total_costs"):
        pi = costs.pair_pi(pt, state.size)
        t_all = costs.supernode_total_costs(pt, pi, scal, num_nodes, backend=backend)
    with span("ssumm.assemble_tables"):
        return assemble_group_tables(nbr_id, nbr_cnt, self_cnt, t_all, state.size,
                                     groups, union_size, num_nodes, backend=backend)


def assemble_group_tables(nbr_id, nbr_cnt, self_cnt, t_all, sizes,
                          groups: torch.Tensor, union_size: int,
                          num_nodes: int, *, row_of_member: torch.Tensor | None = None,
                          backend: str | None = None) -> GroupTables:
    """Union-space assembly, shared by the ``[V, D]`` tables (row = supernode
    id, ``row_of_member`` None) and the compact ``[n_rows, D]`` tables of one
    rank (``row_of_member``: global id → table row, -1 = not a row here;
    members without a row count as dead).

    The per-member prologue (``n``, ``s``, ``t``, each member's row and
    liveness) is ``[G, C]`` work here; ``m``, ``n_u``, ``cidx`` and ``w`` come
    from the group-table kernel (``ops.assemble_tables``)."""
    v = num_nodes
    zero = torch.zeros((), dtype=F32, device=groups.device)

    members = groups
    mvalid = members >= 0
    midx = torch.where(mvalid, members, 0)
    n = torch.where(mvalid, sizes[midx], 0).to(F32)
    alive = n > 0
    if row_of_member is None:
        rows = midx
    else:
        row = row_of_member[midx]
        rows = torch.clamp(row, 0, nbr_id.shape[0] - 1)
        alive = alive & (row >= 0)
        n = torch.where(alive, n, zero)
    s = torch.where(alive, self_cnt[rows], zero)
    t = torch.where(alive, t_all[rows], zero)

    m, n_u, cidx, w = ops.assemble_tables(nbr_id, nbr_cnt, rows, midx, alive, sizes,
                                          union_size, v, backend=backend)
    return GroupTables(m=m, n=n, s=s, t=t, n_u=n_u, cidx=cidx, w=w, members=members)
