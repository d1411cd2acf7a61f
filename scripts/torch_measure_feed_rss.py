"""Measure the host-RSS cost of getting an edge list onto the ranks' devices:
the PyTorch port's copy of ``scripts/measure_feed_rss.py``.

Compares, in separate child processes (fresh runtimes, same fixture):

  * ``densify`` — the pre-feed data path: densify the mmap'd cache
    columns through ``make_graph`` (int64 canonicalization) on the host and
    build full-length padded int32 columns, moved to the device whole;
  * ``feed``    — the out-of-core path: ``shard_edges_from_cache`` slices
    the mmap straight into per-rank shards (host staging = one shard). The
    child holds every rank's shard, ``r`` in ``range(P)``, as the
    reference's one-process mesh holds all of its devices' shards.

Each child reports two deltas over the data path: **resident** growth
(current RSS after − before, the steady-state cost of what the path
leaves allocated) and **peak** growth (ru_maxrss after − before, the
transient sort/unique scratch — visible once it exceeds the runtime-init
high-water mark). The baseline is taken after the device is initialised.
On the card the columns live in device memory, so the host deltas are the
staging buffers and the densify temporaries; on the CPU they also hold the
columns, as the reference's host devices do. The parent writes
``artifacts/memory/feed_rss_torch.json`` and prints a table.

Run:  PYTHONPATH=src python scripts/torch_measure_feed_rss.py data/rmat_1m.txt.gz
      (``--ranks 4`` by default; ``--device cpu`` off the card)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _current_rss_mb() -> float:
    """RSS *right now* (not the lifetime peak): the baseline must not
    already contain the runtime-init high-water mark, or any data-path cost
    below that mark measures as zero. Linux-only (/proc); falls back to
    the peak elsewhere (deltas then read as lower bounds)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") \
                / (1 << 20)
    except (OSError, ValueError, IndexError):
        from repro_torch.launch.summarize import peak_rss_mb

        return peak_rss_mb() or 0.0


def child(mode: str, path: str, ranks: int, device_name: str) -> None:
    import numpy as np
    import torch

    from repro_torch.core import resolve_device
    from repro_torch.graphs import load_graph
    from repro_torch.launch.summarize import peak_rss_mb

    device = resolve_device(device_name)
    # the device's runtime and the copy and widening the paths run, before
    # the baseline: CUDA loads a kernel's code into host memory at its first
    # launch, which is not the data path's cost
    torch.zeros(2, dtype=torch.int32).to(device).to(torch.int64)
    g = load_graph(path)
    if g.cache_dir is None:
        raise SystemExit(f"{path}: no CSR cache")
    rec = {"mode": mode, "V": g.num_nodes, "E": g.num_edges,
           "ranks": ranks, "device": str(device),
           "baseline_mb": _current_rss_mb(),
           "baseline_peak_mb": peak_rss_mb()}

    if mode == "densify":
        # the historical path: canonicalize on host, build full padded
        # copies, move them to the device whole
        from repro_torch.core import make_graph

        graph, _ = make_graph(np.asarray(g.src), np.asarray(g.dst), g.num_nodes,
                              "cpu")
        e = graph.num_edges
        pad = (-e) % ranks
        src_p = np.concatenate([graph.src.numpy().astype(np.int32),
                                np.full(pad, -1, np.int32)])
        dst_p = np.concatenate([graph.dst.numpy().astype(np.int32),
                                np.full(pad, -1, np.int32)])
        cols = [torch.from_numpy(src_p).to(device), torch.from_numpy(dst_p).to(device)]
        del graph
    else:
        from repro_torch.graphs.feed import shard_edges_from_cache

        shards = [shard_edges_from_cache(g.cache_dir, r, ranks, device)
                  for r in range(ranks)]
        cols = [c for sh in shards for c in (sh.src, sh.dst)]
        feed = shards[0].stats.asdict()  # the layout is the same on every rank
        feed["peak_staging_bytes"] = max(sh.stats.peak_staging_bytes for sh in shards)
        feed["bytes_copied"] = sum(sh.stats.bytes_copied for sh in shards)
        feed["local_shards"] = ranks
        rec["feed"] = feed

    if device.type == "cuda":
        torch.cuda.synchronize()
    # two deltas, two regimes: resident growth (current − current) is the
    # steady-state cost of the columns the path leaves behind, and survives
    # even when everything stays below the init transient high-water mark;
    # peak growth (ru_maxrss − ru_maxrss) is the transient scratch
    # (sort/unique) and is only visible once it exceeds that mark
    rec["after_mb"] = _current_rss_mb()
    rec["peak_mb"] = peak_rss_mb()
    rec["delta_resident_mb"] = rec["after_mb"] - rec["baseline_mb"]
    rec["delta_peak_mb"] = max(
        (rec["peak_mb"] or 0.0) - (rec["baseline_peak_mb"] or 0.0), 0.0)
    del cols  # held to here: the columns are what the deltas measure
    print(json.dumps(rec))


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", help="SNAP edge-list file (cache built on "
                                 "first use)")
    ap.add_argument("--ranks", type=int, default=4,
                    help="shards, one a rank (the reference's --devices)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--child", choices=("densify", "feed"), default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", default="artifacts/memory/feed_rss_torch.json")
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args.path, args.ranks, args.device)
        return []

    from repro_torch.core import resolve_device
    from repro_torch.graphs import load_graph

    device = resolve_device(args.device)
    # warm the cache once so neither child pays for ingestion
    load_graph(args.path)

    rows = []
    for mode in ("densify", "feed"):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), args.path,
             "--ranks", str(args.ranks), "--device", args.device, "--child", mode],
            capture_output=True, text=True, check=True)
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    dens, feed = rows
    print(f"|E| = {dens['E']:,}  ranks = {dens['ranks']}  device = {device}"
          + ("  (columns on the card: host deltas are staging and densify "
             "temporaries)" if device.type == "cuda" else ""))
    for r in rows:
        print(f"  {r['mode']:8s} resident {r['baseline_mb']:7.1f} → "
              f"{r['after_mb']:7.1f} MB (Δ {r['delta_resident_mb']:+7.1f}), "
              f"peak Δ {r['delta_peak_mb']:+7.1f} MB")
    f = feed.get("feed", {})
    if f:
        print(f"  feed staging high-water: {f['peak_staging_bytes']:,} B "
              f"(= one shard of {f['shard_rows']:,} rows; "
              f"full |E| column would be {4 * dens['E']:,} B)")
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
