"""Shared evaluation for the paper's baselines (k-Gs, S2L, SAA-Gs).

Port of ``repro/baselines/common.py``. The competitors constrain the
*number of supernodes* and keep every nonzero superedge (no
sparsification), which is why Fig. 4 shows their size in bits often
exceeding the input's. :func:`evaluate_partition` computes Eq. (2)/(4) for
such a summary from any node→supernode assignment, on the caller's device:
one stable sort of the int64 pair key ``lo·(max+1)+hi``, run boundaries and
counts, then the closed forms in float64. It is the part of every baseline
that scales with |E|; the greedy loops themselves stay on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import resolve_device


@dataclasses.dataclass
class BaselineResult:
    name: str
    node2super: torch.Tensor  # int32[V], on the evaluation's device
    num_supernodes: int
    num_superedges: int
    size_bits: float
    input_size_bits: float
    re1: float
    re2: float
    wall_s: float = 0.0


def _ids(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=dev).long()


def pair_counts(src: torch.Tensor, dst: torch.Tensor, n2s: torch.Tensor):
    """Aggregate subedges into supernode-pair counts (lo ≤ hi).

    Int64 tensors on one device in; the pairs in key order out, as
    ``(lo, hi, cnt)`` with ``cnt`` float64."""
    su, sv = n2s[src], n2s[dst]
    base = int(n2s.max()) + 1
    key = torch.minimum(su, sv) * base + torch.maximum(su, sv)
    key_s = torch.sort(key, stable=True).values
    new = torch.ones_like(key_s, dtype=torch.bool)
    new[1:] = key_s[1:] != key_s[:-1]
    starts = torch.nonzero(new).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([key_s.shape[0]])])
    first = key_s[starts]
    return first // base, first % base, (ends - starts).double()


def evaluate_partition(src, dst, num_nodes: int, n2s, name: str = "",
                       device: str | torch.device = "cuda") -> BaselineResult:
    dev = resolve_device(device)
    src, dst, n2s = _ids(src, dev), _ids(dst, dev), _ids(n2s, dev)
    sizes = torch.bincount(n2s, minlength=int(n2s.max()) + 1).double()
    s_count = int((sizes > 0).sum())
    plo, phi, cnt = pair_counts(src, dst, n2s)
    na, nb = sizes[plo], sizes[phi]
    pi = torch.where(plo == phi, na * (na - 1) / 2.0, na * nb)
    sigma = cnt / torch.clamp_min(pi, 1.0)

    re1 = float((2.0 * cnt * (1.0 - sigma)).sum())
    re2sq = float((cnt * (1.0 - sigma)).sum())
    v = float(num_nodes)
    denom = v * (v - 1.0)
    p = int(cnt.shape[0])
    w_max = max(float(cnt.max()) if p else 2.0, 2.0)
    log2s = np.log2(max(s_count, 2))
    size_bits = p * (2 * log2s + np.log2(w_max)) + v * log2s
    input_bits = 2.0 * src.shape[0] * np.log2(max(num_nodes, 2))
    return BaselineResult(
        name=name,
        node2super=n2s.int(),
        num_supernodes=s_count,
        num_superedges=p,
        size_bits=float(size_bits),
        input_size_bits=float(input_bits),
        re1=2.0 * re1 / denom,
        re2=float(np.sqrt(2.0 * re2sq)) / denom,
    )


def adjacency_dicts(src, dst, num_nodes: int):
    """{a: {b: cnt}} supernode adjacency for the greedy baselines (host)."""
    adj: list[dict[int, float]] = [dict() for _ in range(num_nodes)]
    for a, b in zip(np.asarray(src), np.asarray(dst)):
        a, b = int(a), int(b)
        adj[a][b] = adj[a].get(b, 0) + 1
        adj[b][a] = adj[b].get(a, 0) + 1
    return adj
