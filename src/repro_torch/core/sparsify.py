"""Further sparsification (Sect. 3.2.4): drop superedges until Size(Ḡ) ≤ k.

Port of ``repro/core/sparsify.py`` (``sparsify_deltas``, ``sparsify_xi``,
``drop_from_threshold``, ``further_sparsify``), with the single-device,
sort-based order statistic:

  1. the closed-form RE_p increase of dropping each kept superedge
     (footnote 4): ΔRE₁ = (2|E_AB|/|Π_AB| - 1)·|E_AB|, ΔRE₂² = |E_AB|²/|Π_AB|;
  2. Δ_ξ, the ξ-th smallest increase, by a sort;
  3. drop every kept superedge with ΔRE ≤ Δ_ξ.
"""

from __future__ import annotations

import torch

from repro_torch.core import costs
from repro_torch.core.types import PairTable, SummaryState
from repro_torch.utils import f32math

F32 = torch.float32


def sparsify_deltas(cnt: torch.Tensor, pi: torch.Tensor, error_p: int) -> torch.Tensor:
    """Footnote-4 ΔRE_p of dropping each superedge (ΔRE₂² for ``error_p == 2``)."""
    sigma = cnt / torch.clamp(pi, min=1.0)
    if error_p == 1:
        return (2.0 * sigma - 1.0) * cnt
    return cnt * sigma


def sparsify_xi(size_bits: torch.Tensor, k_bits: torch.Tensor,
                num_supernodes: torch.Tensor, omega_max: torch.Tensor) -> torch.Tensor:
    """ξ = ⌈(Size(Ḡ) − k) / (2log₂|S| + log₂ω_max)⌉: how many superedges must go.

    ``k_bits`` is a float32 tensor, as the reference's traced ``k_bits`` is.
    """
    s_count = torch.clamp(num_supernodes, min=2.0)
    w_max = torch.clamp(omega_max, min=2.0)
    unit = 2.0 * f32math.log2(s_count) + f32math.log2(w_max)
    over = torch.clamp(size_bits - k_bits, min=0.0)
    return torch.ceil(over / unit).to(torch.int64)


def drop_from_threshold(keep, delta, delta_xi, xi, p_count) -> torch.Tensor:
    """Drop kept superedges with ΔRE ≤ Δ_ξ; when even dropping all |P| cannot
    reach k, drop all."""
    drop = keep & (delta <= delta_xi) & (xi > 0)
    return torch.where(xi >= p_count, keep, drop)


def further_sparsify(pt: PairTable, state: SummaryState, num_nodes: int,
                     num_edges: int, k_bits: float, cbar_mode: str = "tight",
                     re_guard: int = 1, error_p: int = 1):
    """The drop mask that brings Size(Ḡ) within ``k_bits``.

    Returns ``(drop_mask bool[E], metrics_after dict)``.
    """
    metrics = costs.summary_metrics(pt, state, num_nodes, num_edges,
                                    cbar_mode=cbar_mode, re_guard=re_guard)
    keep = metrics["keep"]
    pi = costs.pair_pi(pt, state.size)
    delta = sparsify_deltas(pt.cnt, pi, error_p)
    k_f32 = costs.f32_scalar(k_bits, pt.cnt.device)
    xi = sparsify_xi(metrics["size_bits"], k_f32, metrics["num_supernodes"],
                     metrics["omega_max"])

    masked = torch.where(keep, delta, torch.full((), float("inf"), device=delta.device))
    order = torch.sort(masked).values
    p_count = metrics["num_superedges"].to(torch.int64)
    delta_xi = order[torch.clamp(xi - 1, 0, masked.shape[0] - 1)]
    drop = drop_from_threshold(keep, delta, delta_xi, xi, p_count)

    after = costs.summary_metrics(pt, state, num_nodes, num_edges,
                                  cbar_mode=cbar_mode, re_guard=re_guard,
                                  drop_mask=drop)
    return drop, after
