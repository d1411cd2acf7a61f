"""Further sparsification (Sect. 3.2.4): drop superedges until Size(Ḡ) ≤ k.

Port of ``repro/core/sparsify.py`` (``sparsify_deltas``, ``sparsify_xi``,
``drop_from_threshold``, ``ordered_key_from_f32``, ``f32_from_ordered_key``,
``radix_select_kth``, ``select_delta_xi``, ``further_sparsify``):

  1. the closed-form RE_p increase of dropping each kept superedge
     (footnote 4): ΔRE₁ = (2|E_AB|/|Π_AB| - 1)·|E_AB|, ΔRE₂² = |E_AB|²/|Π_AB|;
  2. Δ_ξ, the ξ-th smallest increase: by a sort on one device
     (``further_sparsify``), by a histogram selection over the
     order-preserving uint32 image of the float32 deltas across ranks
     (:func:`select_delta_xi`, whose 256-bin histograms are the only thing
     summed across ranks);
  3. drop every kept superedge with ΔRE ≤ Δ_ξ.

PyTorch has no general uint32 arithmetic, so the 32-bit keys are held as
int64 values in ``[0, 2³²)``.
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


# Radix passes over the 32-bit ordered key, most-significant first.
_RADIX_SHIFTS = (24, 16, 8, 0)
_RADIX_BINS = 256
_U32 = 0xFFFFFFFF
_SIGN = 0x80000000


def ordered_key_from_f32(x: torch.Tensor) -> torch.Tensor:
    """Monotone injection float32 → uint32 (held in int64): flip the sign
    bit of non-negatives, every bit of negatives."""
    u = x.to(F32).view(torch.int32).to(torch.int64) & _U32
    return torch.where(u >= _SIGN, (~u) & _U32, u | _SIGN)


def f32_from_ordered_key(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`ordered_key_from_f32`."""
    key = key.to(torch.int64) & _U32
    u = torch.where(key < _SIGN, (~key) & _U32, key ^ _SIGN)
    return torch.where(u >= _SIGN, u - (1 << 32), u).to(torch.int32).view(F32)


def radix_select_kth(keys: torch.Tensor, valid: torch.Tensor, k: torch.Tensor,
                     reduce_hist=None) -> torch.Tensor:
    """The ``k``-th smallest (0-based) valid key, by 4 radix passes of 8 bits.

    Each pass histograms the next 8 bits of the keys that match the prefix
    found so far and descends into the bucket holding rank ``k``.
    ``reduce_hist`` merges the int64[256] histogram across ranks (for
    example ``all_reduce(SUM)``); the identity when None. The caller
    guarantees ``0 ≤ k < #valid``; out-of-range ranks give an unspecified key.
    """
    if reduce_hist is None:
        reduce_hist = lambda h: h  # noqa: E731
    keys = keys.to(torch.int64)
    prefix = torch.zeros((), dtype=torch.int64, device=keys.device)
    rank = k.to(torch.int64)
    for shift in _RADIX_SHIFTS:
        high_mask = (_U32 << (shift + 8)) & _U32
        active = valid & ((keys & high_mask) == (prefix & high_mask))
        digit = (keys >> shift) & 0xFF
        hist = torch.zeros(_RADIX_BINS, dtype=torch.int64, device=keys.device)
        hist.index_add_(0, digit, active.to(torch.int64))
        cum = torch.cumsum(reduce_hist(hist), 0)
        d = torch.argmax((cum > rank).to(torch.uint8))  # the first such bucket
        below = torch.where(d > 0, cum[torch.clamp(d - 1, min=0)], 0)
        rank = rank - below
        prefix = prefix | (d << shift)
    return prefix


def select_delta_xi(delta: torch.Tensor, keep: torch.Tensor, xi: torch.Tensor,
                    reduce_hist=None) -> torch.Tensor:
    """Δ_ξ — the ξ-th smallest kept delta — by histogram selection, as
    float32, so ``delta ≤ Δ_ξ`` compares floats as the sort path does."""
    keys = ordered_key_from_f32(delta)
    key_xi = radix_select_kth(keys, keep, torch.clamp(xi - 1, min=0), reduce_hist)
    return f32_from_ordered_key(key_xi)


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
