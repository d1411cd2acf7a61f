"""k-Gs (GraSS, LeFevre & Terzi SDM'10) with the SamplePairs strategy.

Port of ``repro/baselines/kgs.py``: the same greedy loop on the host, the
same ``np.random.default_rng(seed)`` draws and the same ``dict``/``set``
containers (the float sums in :meth:`KGs.delta_re1` run in set iteration
order, which decides near-ties), so a partition equals the reference's.
Only the final :func:`~repro_torch.baselines.common.evaluate_partition`
runs on ``device``.

Greedy agglomeration toward a target supernode count: at every step sample
``c·|S|`` candidate pairs (c = 1.0, as the paper's suggested setting),
merge the pair with the largest ℓ1-error *reduction* (equivalently the
smallest increase). All nonzero superedges are kept — k-Gs never sparsifies,
which is exactly the behavior Fig. 4 contrasts SSumM against.

The ℓ1 closed form per supernode pair (cnt, Π): 2·cnt·(1−cnt/Π); a merge's
ΔRE₁ touches only pairs adjacent to A or B, evaluated exactly over the
union of their neighbor maps (numpy/dict machinery — the baseline is
sequential by construction; its O(T·|V|·deg) cost is the paper's point
about scalability, reproduced in benchmarks/fig5_speed.py).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.baselines.common import BaselineResult, adjacency_dicts, evaluate_partition
from repro_torch.core.types import resolve_device


def _pair_err(cnt: float, pi: float) -> float:
    if pi <= 0:
        return 0.0
    return 2.0 * cnt * (1.0 - cnt / pi)


class KGs:
    def __init__(self, src, dst, num_nodes: int, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.v = num_nodes
        self.src = np.asarray(src)
        self.dst = np.asarray(dst)
        self.adj = adjacency_dicts(src, dst, num_nodes)
        self.selfc = np.zeros(num_nodes, dtype=np.float64)
        self.size = np.ones(num_nodes, dtype=np.int64)
        self.n2s = np.arange(num_nodes, dtype=np.int64)
        self.members: list[list[int]] = [[i] for i in range(num_nodes)]
        self.rng = np.random.default_rng(seed)

    def _pi(self, a: int, b: int) -> float:
        if a == b:
            n = float(self.size[a])
            return n * (n - 1) / 2
        return float(self.size[a]) * float(self.size[b])

    def _err_of(self, a: int) -> float:
        tot = _pair_err(self.selfc[a], self._pi(a, a))
        for b, cnt in self.adj[a].items():
            tot += _pair_err(cnt, self._pi(a, b))
        return tot

    def delta_re1(self, a: int, b: int) -> float:
        """Exact ΔRE₁ of merging a,b (union over both neighbor maps)."""
        before = self._err_of(a) + self._err_of(b) - _pair_err(
            self.adj[a].get(b, 0.0), self._pi(a, b)
        )
        nn = float(self.size[a] + self.size[b])
        w_ab = self.adj[a].get(b, 0.0)
        after = _pair_err(self.selfc[a] + self.selfc[b] + w_ab,
                          nn * (nn - 1) / 2)
        nbrs = set(self.adj[a]) | set(self.adj[b])
        nbrs.discard(a); nbrs.discard(b)
        for c in nbrs:
            cnt = self.adj[a].get(c, 0.0) + self.adj[b].get(c, 0.0)
            after += _pair_err(cnt, nn * float(self.size[c]))
        return after - before

    def merge(self, a: int, b: int) -> None:
        if a > b:
            a, b = b, a
        w_ab = self.adj[a].pop(b, 0.0)
        self.adj[b].pop(a, None)
        self.selfc[a] += self.selfc[b] + w_ab
        for c, cnt in self.adj[b].items():
            self.adj[c].pop(b, None)
            self.adj[a][c] = self.adj[a].get(c, 0.0) + cnt
            self.adj[c][a] = self.adj[a][c]
        self.adj[b] = {}
        self.members[a].extend(self.members[b])
        for u in self.members[b]:
            self.n2s[u] = a
        self.members[b] = []
        self.size[a] += self.size[b]
        self.size[b] = 0

    def run(self, target_supernodes: int, c: float = 1.0) -> BaselineResult:
        t0 = time.perf_counter()
        alive = list(np.flatnonzero(self.size > 0))
        while len(alive) > max(target_supernodes, 2):
            n_samples = max(int(c * len(alive)), 1)
            best, best_pair = np.inf, None
            idx = self.rng.integers(0, len(alive), size=(n_samples, 2))
            for i, j in idx:
                if i == j:
                    continue
                a, b = int(alive[i]), int(alive[j])
                d = self.delta_re1(a, b)
                if d < best:
                    best, best_pair = d, (a, b)
            if best_pair is None:
                break
            self.merge(*best_pair)
            alive = list(np.flatnonzero(self.size > 0))
        # compact ids for evaluation
        res = evaluate_partition(self.src, self.dst, self.v, self.n2s, "kgs",
                                 device=self.device)
        res.wall_s = time.perf_counter() - t0
        return res


def summarize_kgs(src, dst, num_nodes: int, target_frac: float = 0.3,
                  c: float = 1.0, seed: int = 0,
                  device: str | torch.device = "cuda") -> BaselineResult:
    return KGs(src, dst, num_nodes, seed, device).run(
        max(int(target_frac * num_nodes), 2), c=c
    )
