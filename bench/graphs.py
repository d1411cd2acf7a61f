"""The cells' input graphs, generated on the device from a seed.

A PyTorch copy of the R-MAT generator and the canonicalisation of
``src/repro_torch/graphs/synthetic.py`` (``rmat``, ``_canonical``): the same
quadrant probabilities, the same oversampling (``int(e * oversample) +
extra`` draws), the same dedup of ``lo * V + hi`` keys in ascending order with
self-loops dropped, and the same cut to the ``e`` smallest keys. It draws
with a ``torch.Generator`` on the given device instead of numpy's, so one
seed gives other edges than the numpy copy, and the same edges on every run.
Unlike the numpy copy it raises when the draws hold fewer than ``e`` distinct
edges, so a cell never runs on a smaller graph than its configuration says.
"""

from __future__ import annotations

import math

import torch


def num_nodes(v_published: int) -> int:
    """The generator's vertex count: ``V`` rounded up to a power of two."""
    return 1 << math.ceil(math.log2(v_published))


def rmat(v_log2: int, e: int, seed: int, *, a: float, b: float, c: float,
         oversample: float, extra: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``e`` canonical edges (``lo < hi``, unique, ascending by ``(lo, hi)``)
    of an R-MAT graph on ``2**v_log2`` vertices, as int64 tensors on
    ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    m = int(e * oversample) + extra
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    dst_thr_low = b / (a + b)  # P(dst bit = 1 | src bit = 0)
    dst_thr_high = c / max(1.0 - a - b, 1e-9)  # P(dst bit = 1 | src bit = 1)
    for _ in range(v_log2):
        r = torch.rand(m, generator=gen, device=device)
        src_bit = r > a + b
        r2 = torch.rand(m, generator=gen, device=device)
        thr = torch.where(src_bit, dst_thr_high, dst_thr_low)
        dst_bit = r2 < thr
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    v = 1 << v_log2
    lo = torch.minimum(src, dst)
    hi = torch.maximum(src, dst)
    del src, dst
    keep = lo != hi
    key = torch.unique(lo[keep] * v + hi[keep])  # sorted ascending
    if key.numel() < e:
        raise ValueError(f"R-MAT on 2**{v_log2} vertices drew {key.numel()} distinct "
                         f"edges from {m} samples, fewer than the {e} asked for")
    key = key[:e]
    return key // v, key % v


def generate(config: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The edge list and vertex count of a configuration: ``num_nodes``,
    ``num_edges`` and the generator's ``graph`` group."""
    graph = config["graph"]
    if graph["kind"] != "rmat":
        raise ValueError(f"unknown graph kind {graph['kind']!r}")
    v = config["num_nodes"]
    v_log2 = int(math.log2(v))
    if 1 << v_log2 != v:
        raise ValueError(f"R-MAT needs a power-of-two vertex count, got {v}")
    lo, hi = rmat(v_log2, config["num_edges"], seed, a=graph["a"], b=graph["b"],
                  c=graph["c"], oversample=graph["oversample"], extra=graph["extra"],
                  device=device)
    return lo, hi, v


def degree_figures(lo: torch.Tensor, hi: torch.Tensor, num_nodes: int) -> dict:
    """How the edges spread over the vertices: the share of vertex ids with
    no edge, and the degree quantiles of the others (host numbers)."""
    deg = torch.bincount(lo, minlength=num_nodes) + torch.bincount(hi, minlength=num_nodes)
    touched = torch.sort(deg[deg > 0]).values
    n = touched.numel()
    q = {f"p{p}": int(touched[min(n - 1, (n * p) // 100)]) for p in (50, 90, 99)}
    return {"isolated_pct": 100.0 * (num_nodes - n) / num_nodes, **q,
            "max": int(touched[-1]), "mean": 2.0 * lo.numel() / n}
