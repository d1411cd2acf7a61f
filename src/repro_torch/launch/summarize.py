"""Single-device graph-summarization driver of the port.

    PYTHONPATH=src python -m repro_torch.launch.summarize --dataset dblp \
        --scale 0.05 --k-frac 0.3 --T 20 [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.summarize --edge-list g.txt.gz \
        --checkpoint-dir ck/ [--resume]

Port of the local mode of ``repro/launch/summarize.py``: loads the graph
through :func:`repro_torch.graphs.load_graph` (real file, then its CSR
cache, then the registry's synthetic stand-in), runs SSumM and prints one
JSON object with the reference's keys that this port fills (Eq. 2/4
metrics, iterations, chunk times, the ingest and fault-tolerance
accounting), plus ``device`` and the hand kernels' launch counts. The line
before it gives SHA-256 digests of the summary's ``node2super``,
``super_size`` and ``edge_w`` arrays. It runs on the card unless
``--device cpu`` is given; without CUDA the default raises.

With ``--checkpoint-dir`` the run saves its state at chunk boundaries
(async, atomic, keep-N); SIGTERM or SIGINT then saves at the next boundary,
prints ``{"preempted": true, ...}`` and exits 75, and the same command with
``--resume`` finishes bit-identically to a run that never stopped. A
straggler monitor is always on and reports slow chunks on stderr. The
distributed mode is not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import resource
import sys
import time

import numpy as np

from repro_torch.core import SummaryConfig, summarize
from repro_torch.core.engine import EngineCheckpointer
from repro_torch.core.types import resolve_device
from repro_torch.graphs import DATASETS, load_graph
from repro_torch.kernels import ops
from repro_torch.runtime import (
    RESUMABLE_EXIT,
    CheckpointManager,
    Preempted,
    PreemptionGuard,
    StragglerMonitor,
)


def digest(a: np.ndarray) -> str:
    """SHA-256 of an array's bytes."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def peak_rss_mb() -> float:
    """Process high-water RSS in MB (``ru_maxrss`` is KB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", default="dblp", choices=sorted(DATASETS))
    ap.add_argument("--edge-list", default=None, metavar="PATH",
                    help="SNAP edge-list file (.txt/.csv, optional .gz); "
                         "overrides --dataset/--scale")
    ap.add_argument("--chunk-edges", type=int, default=None,
                    help="ingest chunk size (rows); bounds parser memory")
    ap.add_argument("--reingest", action="store_true",
                    help="force a re-parse even when the CSR cache is fresh")
    ap.add_argument("--scale", type=float, default=0.05,
                    help="subsample factor for the synthetic registry |V|,|E|")
    ap.add_argument("--k-frac", type=float, default=0.3)
    ap.add_argument("--T", type=int, default=20)
    ap.add_argument("--group-size", type=int, default=32)
    ap.add_argument("--driver-chunk", type=int, default=None,
                    help="rounds per engine chunk (default: SummaryConfig.driver_chunk)")
    ap.add_argument("--rss-budget-mb", type=float, default=None,
                    help="fail (exit 1) if the process peak RSS exceeds this many MB")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="save resumable Alg. 1 state here at chunk boundaries "
                         "(async, atomic, keep-N); SIGTERM/SIGINT then save and "
                         f"exit {RESUMABLE_EXIT}")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="save cadence in completed merge rounds, aligned up to "
                         "chunk boundaries (<=0: only the final and preemption saves)")
    ap.add_argument("--checkpoint-keep", type=int, default=3,
                    help="committed checkpoints retained (keep-N)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest committed checkpoint in "
                         "--checkpoint-dir (bit-identical to an uninterrupted run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the summary runs (default: the card)")
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")
    device = resolve_device(args.device)  # raises before any work without CUDA

    t_load = time.time()
    g = load_graph(args.edge_list or args.dataset, chunk_edges=args.chunk_edges,
                   refresh=args.reingest, scale=args.scale, seed=args.seed)
    load_wall_s = time.time() - t_load
    src, dst, v = np.asarray(g.src), np.asarray(g.dst), g.num_nodes
    cfg_kw = {} if args.driver_chunk is None else {"driver_chunk": args.driver_chunk}
    cfg = SummaryConfig(T=args.T, k_frac=args.k_frac, group_size=args.group_size,
                        seed=args.seed, **cfg_kw)

    # fault tolerance: cooperative preemption and chunk-boundary checkpoints;
    # the straggler monitor is always on (host-side, free)
    monitor = StragglerMonitor()
    monitor.on_straggler(lambda ev: print(
        f"[straggler] dispatch t0={ev.step}: {ev.step_time:.3f}s "
        f"({ev.ratio:.1f}x the {ev.mean:.3f}s EMA)", file=sys.stderr))
    ckp = None
    if args.checkpoint_dir:
        ckp = EngineCheckpointer(
            manager=CheckpointManager(args.checkpoint_dir, keep=args.checkpoint_keep),
            every=args.checkpoint_every, guard=PreemptionGuard(),
            graph_extra={"dataset": args.edge_list or args.dataset})
    ingest = {
        "source": g.source,
        "load_wall_s": load_wall_s,
        "ingest_bytes_parsed": g.stats.bytes_parsed,
        "ingest_chunks": g.stats.chunks,
        "ingest_duplicates_dropped": g.stats.duplicates_dropped,
        "ingest_self_loops_dropped": g.stats.self_loops_dropped,
    }

    before = ops.launch_counts()
    t0 = time.time()
    try:
        res = summarize(src, dst, v, cfg, device=device, checkpointer=ckp,
                        monitor=monitor, resume=args.resume)
    except Preempted as p:
        # save-and-exit: the committed checkpoint is the resume point;
        # RESUMABLE_EXIT tells the supervisor "rerun me with --resume"
        print(json.dumps(dict(ingest, preempted=True, checkpoint_step=p.step,
                              checkpoint_dir=args.checkpoint_dir,
                              wall_s=time.time() - t0), indent=1), flush=True)
        raise SystemExit(RESUMABLE_EXIT)
    after = ops.launch_counts()
    result = {
        "dataset": args.edge_list or args.dataset, "V": v, "E": len(src),
        "mode": "local",
        "device": str(device),
        "size_bits": res.size_bits,
        "relative_size": res.size_bits / res.input_size_bits,
        "re1": res.re1, "re2": res.re2,
        "num_supernodes": res.num_supernodes,
        "num_superedges": res.num_superedges,
        "iterations": res.iterations_run,
        "chunk_wall_s": res.chunk_wall_s,
        "straggler_events": [dataclasses.asdict(ev) for ev in res.straggler_events],
        "resumed_from": res.resumed_from,
        "checkpoint_saves": res.checkpoint_saves,
        "checkpoint_snapshot_wall_s": res.checkpoint_snapshot_wall_s,
        "wall_s": time.time() - t0,
        "kernel_launches": {k: after[k] - before[k] for k in after},
    }
    result.update(ingest)
    if ckp is not None:
        stats = ckp.manager.save_stats.values()
        result["checkpoint_dir"] = args.checkpoint_dir
        result["checkpoint_write_wall_s"] = sum(s["write_wall_s"] or 0.0 for s in stats)
        result["checkpoint_bytes"] = max((s["bytes"] or 0 for s in stats), default=0)
    result["peak_rss_mb"] = peak_rss_mb()
    print(f"digests node2super={digest(res.node2super)} "
          f"super_size={digest(res.super_size)} edge_w={digest(res.edge_w)}")
    print(json.dumps(result, indent=1), flush=True)
    if args.rss_budget_mb is not None and result["peak_rss_mb"] > args.rss_budget_mb:
        raise SystemExit(f"peak RSS {result['peak_rss_mb']:.1f} MB exceeds the "
                         f"--rss-budget-mb {args.rss_budget_mb:.1f} MB gate")
    return result


if __name__ == "__main__":
    main()
