"""Dense-reconstruction evaluation utilities (small graphs / tests only).

Own copy of ``repro/core/evaluate.py``, numpy only.

These build the |V|×|V| weighted adjacency Â of the reconstructed graph Ĝ
(Eq. 1) and evaluate RE_p by brute force (Eq. 2) — the ground truth against
which the closed-form pair-table evaluation in :mod:`repro.core.costs` is
verified. Never used at scale.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.types import SummaryResult


def reconstruct_dense(result: SummaryResult) -> np.ndarray:
    """Weighted adjacency Â of Ĝ from the summary graph (Eq. 1)."""
    n2s = result.node2super
    v = n2s.shape[0]
    size = result.super_size
    a_hat = np.zeros((v, v), dtype=np.float64)
    for lo, hi, w in zip(result.edge_lo, result.edge_hi, result.edge_w):
        mem_a = np.where(n2s == lo)[0]
        mem_b = np.where(n2s == hi)[0] if hi != lo else mem_a
        na, nb = size[lo], size[hi]
        pi = na * (na - 1) / 2 if lo == hi else na * nb
        if pi <= 0:
            continue
        weight = w / pi
        for i in mem_a:
            for j in mem_b:
                if i != j:
                    a_hat[i, j] = weight
                    a_hat[j, i] = weight
    return a_hat


def dense_adjacency(src, dst, num_nodes: int) -> np.ndarray:
    a = np.zeros((num_nodes, num_nodes), dtype=np.float64)
    a[src, dst] = 1.0
    a[dst, src] = 1.0
    return a


def re_p_dense(a: np.ndarray, a_hat: np.ndarray, p: int) -> float:
    """Eq. (2), normalized by |V|(|V|-1) (footnote 5)."""
    v = a.shape[0]
    diff = np.abs(a - a_hat)
    np.fill_diagonal(diff, 0.0)
    denom = v * (v - 1)
    if p == 1:
        return float(diff.sum() / denom)
    return float(np.sqrt((diff**2).sum()) / denom)


def summary_size_bits_dense(result: SummaryResult) -> float:
    """Eq. (4) recomputed from the realized summary graph arrays."""
    s = max(result.num_supernodes, 2)
    p = len(result.edge_w)
    if p == 0:
        return result.node2super.shape[0] * float(np.log2(s))
    w_max = max(int(result.edge_w.max()), 2)
    v = result.node2super.shape[0]
    return p * (2 * np.log2(s) + np.log2(w_max)) + v * np.log2(s)
