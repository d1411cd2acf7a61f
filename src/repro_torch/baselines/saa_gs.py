"""SAA-Gs (Beg, Ahmad, Zaman & Khan, PAKDD'18): scalable approximation
algorithm for graph summarization.

Agglomeration toward a target supernode count with two accelerations from
the paper: (a) *weighted pair sampling* — candidate pairs are drawn with
probability proportional to supernode degree-weights kept in a sampling
tree (here: alias-free cumulative-weight binary search, re-built lazily);
(b) *count-min sketch* approximation of supernode adjacency — merge scores
use the sketch (w=50, d=2, the paper's setting) instead of exact neighbor
maps, trading accuracy for memory, which is exactly the quality gap Fig. 4/5
shows against SSumM. Two sampling budgets reproduce the paper's variants:
``log n`` (SAA-Gs) and ``n`` (linear-sample).

Port of ``repro/baselines/saa_gs.py``: the loop, the salts, the int64
hashing ``(key·salt + (salt>>3)) % w`` and every ``np.random`` draw are the
reference's, on the host, so a partition equals the reference's; only the
final evaluation runs on ``device``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.baselines.common import BaselineResult, evaluate_partition
from repro_torch.core.types import resolve_device


class CountMinSketch:
    """d independent rows of width w; conservative point updates."""

    def __init__(self, w: int = 50, d: int = 2, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.w, self.d = w, d
        self.salt = rng.integers(1, 2**31 - 1, size=d).astype(np.int64)
        self.table = np.zeros((d, w), dtype=np.float64)

    def _rows(self, key: int) -> np.ndarray:
        return (key * self.salt + (self.salt >> 3)) % self.w

    def add(self, key: int, val: float) -> None:
        self.table[np.arange(self.d), self._rows(key)] += val

    def query(self, key: int) -> float:
        return float(self.table[np.arange(self.d), self._rows(key)].min())


class SAAGs:
    def __init__(self, src, dst, num_nodes: int, *, w: int = 50, d: int = 2,
                 seed: int = 0, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.v = num_nodes
        self.src = np.asarray(src)
        self.dst = np.asarray(dst)
        self.rng = np.random.default_rng(seed)
        self.size = np.ones(num_nodes, dtype=np.int64)
        self.n2s = np.arange(num_nodes, dtype=np.int64)
        self.members: list[list[int]] = [[i] for i in range(num_nodes)]
        self.deg = np.zeros(num_nodes, dtype=np.float64)
        np.add.at(self.deg, self.src, 1.0)
        np.add.at(self.deg, self.dst, 1.0)
        # per-supernode count-min sketch of its adjacency counts
        self.sketch: list[CountMinSketch] = [
            CountMinSketch(w, d, seed + i) for i in range(num_nodes)
        ]
        for a, b in zip(self.src, self.dst):
            self.sketch[int(a)].add(int(b), 1.0)
            self.sketch[int(b)].add(int(a), 1.0)
        # exact neighbor id sets (ids only; counts live in the sketches)
        self.nbrs: list[set] = [set() for _ in range(num_nodes)]
        for a, b in zip(self.src, self.dst):
            self.nbrs[int(a)].add(int(b))
            self.nbrs[int(b)].add(int(a))

    # ---- weighted sampling over alive supernodes -------------------------
    def _sample_pairs(self, alive: np.ndarray, n: int) -> np.ndarray:
        w = self.deg[alive] + 1.0
        p = w / w.sum()
        i = self.rng.choice(alive.size, size=n, p=p)
        j = self.rng.choice(alive.size, size=n, p=p)
        return np.stack([alive[i], alive[j]], axis=1)

    # ---- sketch-approximate merge score -----------------------------------
    def _pi(self, a: int, b: int) -> float:
        if a == b:
            nn = float(self.size[a])
            return nn * (nn - 1) / 2
        return float(self.size[a]) * float(self.size[b])

    def _pair_err(self, cnt: float, pi: float) -> float:
        if pi <= 0:
            return 0.0
        cnt = min(cnt, pi)
        return 2.0 * cnt * (1.0 - cnt / pi)

    def score(self, a: int, b: int) -> float:
        """Approximate ΔRE₁ of merging (negative = improvement)."""
        nn = float(self.size[a] + self.size[b])
        w_ab = self.sketch[a].query(b) if b in self.nbrs[a] else 0.0
        before = after = 0.0
        before += self._pair_err(w_ab, self._pi(a, b))
        nbrs = (self.nbrs[a] | self.nbrs[b]) - {a, b}
        for c in nbrs:
            ca = self.sketch[a].query(c) if c in self.nbrs[a] else 0.0
            cb = self.sketch[b].query(c) if c in self.nbrs[b] else 0.0
            before += self._pair_err(ca, float(self.size[a]) * self.size[c])
            before += self._pair_err(cb, float(self.size[b]) * self.size[c])
            after += self._pair_err(ca + cb, nn * float(self.size[c]))
        return after - before

    def merge(self, a: int, b: int) -> None:
        if a > b:
            a, b = b, a
        self.sketch[a].table += self.sketch[b].table
        self.nbrs[a] |= self.nbrs[b]
        self.nbrs[a].discard(a)
        self.nbrs[a].discard(b)
        for c in self.nbrs[b]:
            if c != a:
                self.nbrs[c].discard(b)
                self.nbrs[c].add(a)
        self.nbrs[b] = set()
        self.members[a].extend(self.members[b])
        for u in self.members[b]:
            self.n2s[u] = a
        self.members[b] = []
        self.deg[a] += self.deg[b]
        self.deg[b] = 0.0
        self.size[a] += self.size[b]
        self.size[b] = 0

    def run(self, target_supernodes: int, linear_sample: bool = False
            ) -> BaselineResult:
        t0 = time.perf_counter()
        alive = np.flatnonzero(self.size > 0)
        while alive.size > max(target_supernodes, 2):
            n = alive.size if linear_sample else max(
                int(np.log2(max(alive.size, 2))), 1
            )
            pairs = self._sample_pairs(alive, n)
            best, best_pair = np.inf, None
            for a, b in pairs:
                a, b = int(a), int(b)
                if a == b:
                    continue
                s = self.score(a, b)
                if s < best:
                    best, best_pair = s, (a, b)
            if best_pair is None:
                continue
            self.merge(*best_pair)
            alive = np.flatnonzero(self.size > 0)
        name = "saa_gs_linear" if linear_sample else "saa_gs"
        res = evaluate_partition(self.src, self.dst, self.v, self.n2s, name,
                                 device=self.device)
        res.wall_s = time.perf_counter() - t0
        return res


def summarize_saa_gs(src, dst, num_nodes: int, target_frac: float = 0.3,
                     linear_sample: bool = False, seed: int = 0,
                     w: int = 50, d: int = 2,
                     device: str | torch.device = "cuda") -> BaselineResult:
    return SAAGs(src, dst, num_nodes, w=w, d=d, seed=seed, device=device).run(
        max(int(target_frac * num_nodes), 2), linear_sample=linear_sample
    )
