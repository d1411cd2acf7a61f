"""Synthetic graph generators + the Table-2 stand-in dataset registry.

Own copy of ``repro/graphs/synthetic.py`` (the port imports nothing of
``repro``): the same generators, the same ``DATASETS`` and the same edges
for the same seed and scale, so the tests can hand both packages one graph.
The SNAP datasets of Table 2 are replaced by synthetic graphs with matched
|V|, |E| and degree-heterogeneity family. Pure numpy, deterministic seeds,
canonical (src < dst) unique edge lists.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _canonical(src: np.ndarray, dst: np.ndarray, v: int):
    lo = np.minimum(src, dst).astype(np.int64)
    hi = np.maximum(src, dst).astype(np.int64)
    keep = lo != hi
    key = lo[keep] * v + hi[keep]
    key = np.unique(key)
    return (key // v).astype(np.int32), (key % v).astype(np.int32)


def erdos_renyi(v: int, e: int, seed: int = 0):
    """G(n, m)-style: sample ~e distinct pairs uniformly."""
    rng = np.random.default_rng(seed)
    m = int(e * 1.15) + 16
    src = rng.integers(0, v, m)
    dst = rng.integers(0, v, m)
    lo, hi = _canonical(src, dst, v)
    return lo[:e], hi[:e]


def barabasi_albert(v: int, m_per_node: int = 4, seed: int = 0):
    """Preferential attachment via the repeated-endpoints trick (O(E))."""
    rng = np.random.default_rng(seed)
    targets = list(range(m_per_node))
    repeated: list[int] = []
    src_l: list[int] = []
    dst_l: list[int] = []
    for u in range(m_per_node, v):
        for t in targets:
            src_l.append(u)
            dst_l.append(t)
        repeated.extend(targets)
        repeated.extend([u] * m_per_node)
        idx = rng.integers(0, len(repeated), m_per_node)
        targets = [repeated[i] for i in idx]
    return _canonical(np.asarray(src_l), np.asarray(dst_l), v)


def rmat(v_log2: int, e: int, seed: int = 0, a=0.57, b=0.19, c=0.19):
    """R-MAT / Graph500-style power-law generator (bit-recursive)."""
    rng = np.random.default_rng(seed)
    n_bits = v_log2
    m = int(e * 1.25) + 16
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for _ in range(n_bits):
        r = rng.random(m)
        src_bit = (r > a + b).astype(np.int64)
        r2 = rng.random(m)
        thr = np.where(src_bit == 0, b / (a + b), c / max(1.0 - a - b, 1e-9))
        dst_bit = (r2 < thr).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    lo, hi = _canonical(src, dst, 1 << n_bits)
    return lo[:e], hi[:e]


def caveman(v: int, clique: int = 16, rewire: float = 0.05, seed: int = 0):
    """Dense communities + random rewiring — the best case for summarization
    (mirrors the community structure of the social/co-purchase datasets)."""
    rng = np.random.default_rng(seed)
    n_cl = v // clique
    src_l, dst_l = [], []
    for g in range(n_cl):
        base = g * clique
        ids = np.arange(base, base + clique)
        iu, ju = np.triu_indices(clique, k=1)
        src_l.append(ids[iu])
        dst_l.append(ids[ju])
    src = np.concatenate(src_l)
    dst = np.concatenate(dst_l)
    flip = rng.random(src.shape[0]) < rewire
    dst = np.where(flip, rng.integers(0, v, src.shape[0]), dst)
    return _canonical(src, dst, v)


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    short: str
    v: int
    e_target: int
    kind: str  # generator family
    note: str


# Table 2 stand-ins (small/mid rows at full |V|; the web-scale rows are
# beyond one card's single-device path).
DATASETS: dict[str, DatasetSpec] = {
    "ego-facebook": DatasetSpec("ego-facebook", "EF", 4_039, 88_234, "caveman", "social"),
    "caida": DatasetSpec("caida", "CA", 26_475, 106_762, "rmat", "internet"),
    "email-enron": DatasetSpec("email-enron", "EE", 36_692, 183_831, "rmat", "email"),
    "amazon0302": DatasetSpec("amazon0302", "A3", 262_111, 899_792, "ba", "co-purchase"),
    "dblp": DatasetSpec("dblp", "DB", 317_080, 1_049_866, "caveman", "collaboration"),
    "amazon0601": DatasetSpec("amazon0601", "A6", 403_394, 2_443_408, "ba", "co-purchase"),
    "skitter": DatasetSpec("skitter", "SK", 1_696_415, 11_095_298, "rmat", "internet"),
    "livejournal": DatasetSpec("livejournal", "LJ", 3_997_962, 34_681_189, "rmat", "social"),
    "web-uk-02": DatasetSpec("web-uk-02", "W2", 18_483_186, 261_787_258, "rmat", "hyperlinks (dry-run only)"),
    "web-uk-05": DatasetSpec("web-uk-05", "W5", 39_454_463, 783_027_125, "rmat", "hyperlinks (dry-run only)"),
}


def generate(name: str, seed: int = 0, scale: float = 1.0):
    """Materialize a registry dataset (optionally scaled down by ``scale``).

    Returns ``(src, dst, num_nodes)``.
    """
    spec = DATASETS[name]
    v = max(int(spec.v * scale), 64)
    e = max(int(spec.e_target * scale), 128)
    if spec.kind == "caveman":
        src, dst = caveman(v, clique=max(int(2 * e / v), 3), seed=seed)
    elif spec.kind == "ba":
        src, dst = barabasi_albert(v, m_per_node=max(e // v, 1), seed=seed)
    else:
        bits = int(np.ceil(np.log2(v)))
        src, dst = rmat(bits, e, seed=seed)
        v = 1 << bits
    return src, dst, v
