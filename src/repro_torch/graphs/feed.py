"""Per-rank edge shards: the CSR cache's mmap'd columns → this rank's rows.

Port of ``repro/graphs/feed.py`` (``FeedStats``, ``shard_layout``,
``shard_edges``, ``shard_edges_from_cache``) for a ``torch.distributed``
group. The edge columns are split into P contiguous ``-1``-padded shards
exactly as the reference splits them over its mesh
(``padded = |E| + (−|E| mod P)``, shard ``r`` = rows ``[r·rows, (r+1)·rows)``),
and rank ``r`` stages and copies only shard ``r``: one shard-sized host
buffer a column, never a full-|E| array. The cache feed slices the cache's
``src.npy``/``dst.npy`` with ``mmap_mode="r"``, so only this rank's pages
are read.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.graphs import io as graph_io


@dataclasses.dataclass
class FeedStats:
    """Host-side accounting of one rank's feed, under the reference's names.

    ``peak_staging_bytes`` is the largest host buffer the feed allocated to
    stage a shard column (``shard_bytes``, never 4·|E|); ``bytes_copied``
    what moved to the device (both columns, padding included);
    ``local_shards`` the shards this process staged (1).
    """

    num_edges: int = 0
    padded_edges: int = 0
    n_devices: int = 0
    shard_rows: int = 0
    shard_bytes: int = 0
    peak_staging_bytes: int = 0
    bytes_copied: int = 0
    path: str = "memory"  # "memory" | "cache-mmap"
    process_count: int = 1
    local_shards: int = 0

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class EdgeShards:
    """This rank's padded edge columns (int64 ``[shard_rows]`` on the run's
    device, ``-1`` in padded rows) with provenance and accounting."""

    src: torch.Tensor
    dst: torch.Tensor
    num_edges: int  # unpadded global |E|
    num_nodes: int | None  # from the cache's meta; None on the in-memory path
    rank: int
    stats: FeedStats


def shard_layout(num_edges: int, n_dev: int) -> tuple[int, int]:
    """``(rows_per_shard, padded_total)`` for ``num_edges`` over ``n_dev`` ranks;
    trailing shards may be all padding when ``|E| < n_dev``."""
    if n_dev <= 0:
        raise ValueError(f"n_dev must be positive, got {n_dev}")
    padded = num_edges + (-num_edges) % n_dev
    return padded // n_dev, padded


def _madvise_dontneed(column) -> None:
    """Drop the resident pages of an mmap'd column (best-effort)."""
    try:
        import mmap as _mmap

        column._mmap.madvise(_mmap.MADV_DONTNEED)  # noqa: SLF001
    except (AttributeError, ValueError, OSError):
        pass


def _feed(src, dst, num_edges: int, rank: int, n_ranks: int, device,
          path: str, num_nodes: int | None) -> EdgeShards:
    if not 0 <= rank < n_ranks:
        raise ValueError(f"rank {rank} outside a group of {n_ranks}")
    rows, padded = shard_layout(num_edges, n_ranks)
    stats = FeedStats(num_edges=num_edges, padded_edges=padded, n_devices=n_ranks,
                      shard_rows=rows, shard_bytes=rows * 4, path=path,
                      local_shards=1)
    a = rank * rows
    n_valid = max(min(num_edges, a + rows) - a, 0)
    cols = []
    for column in (src, dst):
        buf = np.empty((rows,), np.int32)  # the staging shard
        stats.peak_staging_bytes = max(stats.peak_staging_bytes, buf.nbytes)
        if n_valid:
            np.copyto(buf[:n_valid], column[a:a + n_valid], casting="same_kind")
        buf[n_valid:] = -1
        cols.append(torch.from_numpy(buf).to(device=device, dtype=torch.int64))
        stats.bytes_copied += buf.nbytes
        del buf
    return EdgeShards(src=cols[0], dst=cols[1], num_edges=num_edges,
                      num_nodes=num_nodes, rank=rank, stats=stats)


def shard_edges(src, dst, rank: int, n_ranks: int,
                device: str | torch.device = "cuda") -> EdgeShards:
    """This rank's shard of a canonical edge list held in host memory
    (``src < dst``, unique: ``make_graph``'s output or a cache column)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"edge columns must be equal-length 1-D arrays; "
                         f"got {src.shape} vs {dst.shape}")
    return _feed(src, dst, int(src.shape[0]), rank, n_ranks, device, "memory", None)


def shard_edges_from_cache(cache_dir: str, rank: int, n_ranks: int,
                           device: str | torch.device = "cuda") -> EdgeShards:
    """This rank's shard, sliced straight out of the CSR cache's mmap'd
    ``src.npy``/``dst.npy``; |E| and |V| come from ``meta.json``. Raises
    ``FileNotFoundError`` for a missing or stale cache."""
    if not graph_io.cache_is_fresh(cache_dir):
        raise FileNotFoundError(
            f"{cache_dir!r}: not a complete ssumm cache (missing or corrupt members, "
            f"or a stale meta.json); re-ingest with repro_torch.graphs.load_graph")
    with open(os.path.join(cache_dir, "meta.json")) as f:
        meta = json.load(f)
    num_edges = int(meta["num_edges"])
    src_mm = np.load(os.path.join(cache_dir, "src.npy"), mmap_mode="r")
    dst_mm = np.load(os.path.join(cache_dir, "dst.npy"), mmap_mode="r")
    if src_mm.shape[0] != num_edges or dst_mm.shape[0] != num_edges:
        raise ValueError(f"{cache_dir!r}: meta.json says |E|={num_edges} but members "
                         f"have {src_mm.shape[0]}/{dst_mm.shape[0]} rows")
    out = _feed(src_mm, dst_mm, num_edges, rank, n_ranks, device, "cache-mmap",
                int(meta["num_nodes"]))
    _madvise_dontneed(src_mm)
    _madvise_dontneed(dst_mm)
    return out
