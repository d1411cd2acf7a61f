"""Merging phase (Sect. 3.2.3, Alg. 2): one parallel coarsening round.

Port of ``repro/core/merge.py`` (``theta_schedule``, ``select_matching``,
``apply_merges``, ``merge_iteration``). Every candidate group scores all its
pairs with the merge-gain kernel (``ops.merge_gain``), and the round merges
the mutually-best pairs whose Relative_Reduction (Eq. 20) exceeds θ(t)
(Eq. 21). Mutual argmax makes the merge set disjoint, so applying it is one
gather.

Nothing in a round reads a value back to the host: every table keeps its
capacity and the round's scalars stay 0-d tensors on the device.
"""

from __future__ import annotations

import torch

from repro_torch.core import costs, shingles, tables
from repro_torch.core.shingles import PermutationSource
from repro_torch.core.types import SummaryConfig, SummaryState
from repro_torch.kernels import ops

F32 = torch.float32


def theta_schedule(t: int, big_t: int, device) -> torch.Tensor:
    """Eq. (21): θ(t) = (1+t)⁻¹ for t < T, 0 at t ≥ T, as a float32 tensor.

    θ is compared with float32 gains, so it must be float32 itself: ``1/3``
    in float64 and in float32 differ, and the reference compares with the
    float32 value.
    """
    return costs.f32_scalar(1.0 / (1.0 + t) if t < big_t else 0.0, device)


def select_matching(rel: torch.Tensor, members: torch.Tensor, theta: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mutually-best pairs above θ → disjoint merge list ``(a, b, sel)``.

    ``torch.argmax`` returns the first maximal index, as ``jnp.argmax`` does:
    rows with equal maxima pick the lowest column, and an all ``-inf`` row
    picks column 0 (and is never accepted, since -inf > θ is false).
    """
    g, c, _ = rel.shape
    best_j = torch.argmax(rel, dim=-1)  # [G, C]
    best_v = torch.amax(rel, dim=-1)
    idx = torch.arange(c, device=rel.device)[None, :]
    partner_best = torch.gather(best_j, 1, best_j)
    mutual = partner_best == idx
    accept = mutual & (best_v > theta) & (idx < best_j)
    a = members
    b = torch.gather(members, 1, best_j)
    accept = accept & (a >= 0) & (b >= 0)
    return a.reshape(-1), b.reshape(-1), accept.reshape(-1)


def apply_merges(state: SummaryState, a: torch.Tensor, b: torch.Tensor,
                 sel: torch.Tensor) -> tuple[SummaryState, torch.Tensor]:
    """Union each selected pair: supernode ``b`` is absorbed into ``a``."""
    v = state.node2super.shape[0]
    dev = a.device
    b_idx = torch.where(sel, b, v)  # sentinel slot v
    a_idx = torch.where(sel, a, v)
    parent = torch.arange(v + 1, device=dev).scatter_(0, b_idx, torch.where(sel, a, 0))
    node2super = parent[:v][state.node2super]
    moved = torch.where(sel, state.size[torch.clamp(b, min=0, max=v - 1)], 0)
    size = torch.cat([state.size, state.size.new_zeros(1)])
    size.index_add_(0, a_idx, moved)
    size.scatter_(0, b_idx, 0)
    nmerges = sel.sum()
    return SummaryState(node2super=node2super, size=size[:v], t=state.t), nmerges


def merge_iteration(src: torch.Tensor, dst: torch.Tensor, state: SummaryState,
                    cfg: SummaryConfig, theta: torch.Tensor,
                    perms: PermutationSource) -> tuple[SummaryState, dict]:
    """One candidate-generation + merging round (Alg. 1 lines 5–7).

    ``theta`` is a float32 tensor; ``perms`` supplies the round's ``(h, tie)``.
    Returns the new state and the round's stats as 0-d device tensors.
    """
    v = state.node2super.shape[0]
    e = src.shape[0]

    pt = costs.build_pair_table(src, dst, state)
    metrics = costs.summary_metrics(pt, state, v, e, cbar_mode=cfg.cbar_mode,
                                    re_guard=cfg.re_guard)
    cbar = metrics["cbar"]
    log2v = costs.log2_f32(v, src.device)
    scal = torch.stack([cbar, log2v])  # (cbar, log2v) stay on the device

    groups = shingles.build_groups(src, dst, state, perms, cfg.group_size)
    gt = tables.build_group_tables(pt, state, groups, cfg.max_neighbors,
                                   cfg.union_size, scal, v,
                                   backend=cfg.kernel_backend)
    rel, red = ops.merge_gain(gt.m, gt.n, gt.s, gt.t, gt.n_u, gt.cidx, gt.w, scal,
                              backend=cfg.kernel_backend)
    a, b, sel = select_matching(rel, gt.members, theta)
    new_state, nmerges = apply_merges(state, a, b, sel)
    # summed Eq. 17 reduction (bits) of the accepted pairs: each row's
    # best-partner red, by the same argmax select_matching used
    best_j = torch.argmax(rel, dim=-1)
    red_best = torch.gather(red, 2, best_j[..., None])[..., 0]
    total_reduction = torch.sum(torch.where(sel, red_best.reshape(-1),
                                            torch.zeros((), dtype=F32, device=rel.device)))
    new_state = SummaryState(node2super=new_state.node2super, size=new_state.size,
                             t=state.t + 1)
    stats = {
        "nmerges": nmerges,
        "size_bits": metrics["size_bits"],
        "mdl_cost": metrics["mdl_cost"],
        "re1": metrics["re1"],
        "re2": metrics["re2"],
        "num_supernodes": metrics["num_supernodes"],
        "num_superedges": metrics["num_superedges"],
        "total_reduction": total_reduction,
    }
    return new_state, stats
