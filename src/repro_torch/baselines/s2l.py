"""S2L (Riondato, García-Soriano & Bonchi, DMKD'17): summarization via
geometric clustering of adjacency rows.

Port of ``repro/baselines/s2l.py``. Each node is its adjacency row in
R^|V|; clustering rows with k-means gives supernodes with an ℓ_p
reconstruction guarantee. A random-projection sketch (d = O(log|V|) dims,
built from the edge list in O(|E|·d)) avoids the |V|-dimensional
distances, then k-means++ seeding and Lloyd iterations run on ``device``.

What follows the reference and what is the port's own:

* :func:`project_rows` draws and sums on the host with numpy, as the
  reference does, so its rows are the reference's bit for bit.
* The seeding makes the reference's ``np.random`` calls on the distances
  copied to float64; a squared distance adds its dims in XLA:CPU's order
  (:func:`~repro_torch.utils.f32math.sum_last`).
* The assignment is ``|x|² − 2x·cᵀ + |c|²`` with ``torch.matmul`` (the
  reference leaves this product to XLA's dot, outside any Pallas kernel),
  its argmin taken in row chunks so that one ``[rows, k]`` float32 block
  stays within ``chunk_bytes`` (:data:`ASSIGN_BYTES`). The two products
  round differently, so a distance near-tie can fall either way.
* The update sums each cluster's rows in row order: a stable sort by
  cluster, then ``torch.segment_reduce`` over the sorted rows, one
  sequential sum per output value and no atomics, so two card runs are
  equal bit for bit (float32 ``index_add_`` on the card adds in whatever
  order its atomics land).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.baselines.common import BaselineResult, evaluate_partition
from repro_torch.core.types import resolve_device
from repro_torch.utils.f32math import sum_last

# Byte budget of one [rows, k] float32 distance block in the assignment.
ASSIGN_BYTES = 256 << 20


def project_rows(src, dst, num_nodes: int, dims: int, seed: int = 0):
    """Random projection of adjacency rows: P[u] = Σ_{v∈N(u)} R[v] (numpy)."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((num_nodes, dims)).astype(np.float32)
    r /= np.sqrt(dims)
    p = np.zeros((num_nodes, dims), np.float32)
    np.add.at(p, np.asarray(src), r[np.asarray(dst)])
    np.add.at(p, np.asarray(dst), r[np.asarray(src)])
    return p


def _sq_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    diff = x - c
    return sum_last(diff * diff)


def _assign(x: torch.Tensor, centers: torch.Tensor,
            chunk_bytes: int = ASSIGN_BYTES) -> torch.Tensor:
    """Nearest center of every row (first index on ties), in row chunks."""
    n, k = x.shape[0], centers.shape[0]
    rows = max(1, chunk_bytes // (4 * k))
    cc = sum_last(centers * centers)
    ct = centers.t()
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    for s in range(0, n, rows):
        xs = x[s:s + rows]
        d = torch.matmul(2.0 * xs, ct)  # the reference's (2.0 * x) @ c.T
        d.neg_().add_(sum_last(xs * xs)[:, None]).add_(cc)  # (|x|² − 2x·c) + |c|²
        out[s:s + rows] = torch.argmin(d, dim=1).int()
    return out


def _update(x: torch.Tensor, assign: torch.Tensor, k: int):
    """Cluster means and sizes; each cluster's rows added in row order."""
    order = torch.sort(assign, stable=True).indices
    lengths = torch.bincount(assign, minlength=k)
    sums = torch.segment_reduce(x[order], "sum", lengths=lengths, axis=0, unsafe=True)
    cnts = lengths.to(x.dtype)
    return sums / torch.clamp_min(cnts, 1.0)[:, None], cnts


def kmeans(x: np.ndarray, k: int, iters: int = 25, seed: int = 0,
           device: str | torch.device = "cuda", stats: dict | None = None) -> torch.Tensor:
    """k-means++ seeding (sampled) + Lloyd iterations; int32 labels on ``device``.

    ``stats``, if given, receives ``seed_s`` (the seeding's wall) and
    ``lloyd_iters``/``lloyd_s`` (the iterations run and their wall)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    xd = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    # k-means++ on a subsample (adaptive sampling per the S2L paper)
    m = min(n, max(4 * k, 1024))
    sub = xd[torch.as_tensor(rng.choice(n, size=m, replace=False), device=dev)]
    picks = [int(rng.integers(0, m))]
    d2 = _sq_dist(sub, sub[picks[0]])
    for _ in range(1, k):
        probs = d2.cpu().numpy().astype(np.float64)
        tot = probs.sum()
        if tot <= 0:
            picks.append(int(rng.integers(0, m)))
            continue
        picks.append(int(rng.choice(m, p=probs / tot)))
        d2 = torch.minimum(d2, _sq_dist(sub, sub[picks[-1]]))
    c = sub[torch.as_tensor(picks, device=dev)]
    assign = _assign(xd, c)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    run = 0
    for _ in range(iters):
        run += 1
        c, cnts = _update(xd, assign, k)
        # re-seed empty clusters at random points
        empty = np.flatnonzero(cnts.cpu().numpy() == 0)
        if empty.size:
            c[torch.as_tensor(empty, device=dev)] = xd[
                torch.as_tensor(rng.integers(0, n, empty.size), device=dev)]
        new_assign = _assign(xd, c)
        if torch.equal(new_assign, assign):
            break
        assign = new_assign
    if stats is not None:
        stats.update(seed_s=t1 - t0, lloyd_iters=run, lloyd_s=time.perf_counter() - t1)
    return assign


def summarize_s2l(src, dst, num_nodes: int, target_frac: float = 0.3,
                  dims: int | None = None, iters: int = 25, seed: int = 0,
                  device: str | torch.device = "cuda",
                  stats: dict | None = None) -> BaselineResult:
    dev = resolve_device(device)
    t0 = time.perf_counter()
    k = max(int(target_frac * num_nodes), 2)
    dims = dims or max(int(np.ceil(np.log2(max(num_nodes, 2)))) * 2, 8)
    x = project_rows(src, dst, num_nodes, dims, seed)
    assign = kmeans(x, k, iters=iters, seed=seed, device=dev, stats=stats)
    res = evaluate_partition(src, dst, num_nodes, assign, "s2l", device=dev)
    res.wall_s = time.perf_counter() - t0
    return res
