"""Graph-summarization launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.summarize --dataset dblp \
        --scale 0.05 --k-frac 0.3 --T 20 [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.summarize --edge-list g.txt.gz \
        --checkpoint-dir ck/ [--resume]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.summarize \
        --distributed --device cpu --dataset ego-facebook --scale 0.05
    PYTHONPATH=src python -m repro_torch.launch.summarize --distributed \
        --device cpu --edge-list g.txt --coordinator HOST:PORT \
        --num-processes 2 --process-id 0        # and --process-id 1 elsewhere

Port of ``repro/launch/summarize.py``'s local and ``--distributed`` modes
and its multi-host bootstrap. The local mode loads the graph
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
straggler monitor is always on and reports slow chunks on stderr.

``--distributed`` runs the edge-sharded backend
(:mod:`repro_torch.core.distributed`, compact grouping, capacity factor 32,
lean sort) over ``torch.distributed``: NCCL with ``--device cuda`` (one card
a rank), gloo with ``--device cpu``. The group is, in this order: one the
caller already made; ``torchrun``'s, from its environment; the multi-host
bootstrap's (:func:`repro_torch.launch.mesh.bootstrap_distributed`), from
``--coordinator HOST:PORT --num-processes N --process-id i`` or the
``SSUMM_*`` environment, one process a rank on any number of hosts; else a
world of one. With more than one rank, each rank feeds only its own edge
shard from the CSR cache when the graph has one
(:mod:`repro_torch.graphs.feed`, ``feed_path`` ``cache-mmap-multihost``);
the bootstrap refuses a graph without one. Under ``torchrun`` or a world of
one, rank 0 prints the digests and the JSON; under the bootstrap every
process prints its own, as the reference's processes do, and peers give
the same summary bit for bit. The JSON has the reference's distributed keys
(``mode``, ``size_bits_before_sparsify``, ``superedges_dropped``,
``feed_*``, ``process_index``, ``process_count``, ``sparsify_wall_s``, ...)
and the port's (``history``, ``bucket_cap``, ``bucket_bytes``,
``kernel_launches``). ``sparsify_wall_s`` is the host wall of the final
sparsification and ends with no device sync of its own: on the card it
times the enqueue of that path, not its device work. Rank 0 ingests a new file and writes the
checkpoints, so every process must see the same file system for the cache
and the checkpoint directory. A resume may run on another number of ranks:
the state is loaded whole on every rank and the shards are fed again at
the new count.
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
import torch

from repro_torch.core import SummaryConfig, summarize
from repro_torch.core.distributed import bucket_bytes, make_distributed_backend
from repro_torch.core.engine import EngineCheckpointer, SummaryEngine
from repro_torch.core.types import make_graph, resolve_device
from repro_torch.graphs import DATASETS, load_graph
from repro_torch.graphs.feed import (
    EdgeShards,
    shard_edges,
    shard_edges_from_cache,
    shard_edges_from_cache_multihost,
)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import join_process_group, resolve_flags, under_torchrun
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


def init_distributed(device: torch.device, coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int, torch.device]:
    """Join (or make) the default process group; returns ``(rank, world,
    device)`` with the rank's card on CUDA.

    In this order: an already initialized group is used as it is; under
    ``torchrun`` (``RANK``/``WORLD_SIZE`` set) the group comes from the
    environment; with more than one process asked for by the flags or the
    ``SSUMM_*`` environment, :func:`~repro_torch.launch.mesh.bootstrap_distributed`
    joins it and picks the card; otherwise a world of one with an in-process
    store. NCCL on the card, gloo on the CPU; CUDA without NCCL raises.
    """
    dist = torch.distributed
    if device.type == "cuda" and not dist.is_nccl_available():
        raise RuntimeError("--distributed --device cuda needs NCCL, and this "
                           "PyTorch has no NCCL; use --device cpu (gloo)")
    _, device = join_process_group(device, coordinator, num_processes, process_id)
    if not dist.is_initialized():
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_rank(), dist.get_world_size(), device


def load_rank0_first(load):
    """``load()`` on rank 0, then on the other ranks: rank 0 ingests a new
    file into its cache, and the others then find it."""
    rank = torch.distributed.get_rank()
    if rank == 0:
        g = load()
    torch.distributed.barrier()
    if rank != 0:
        g = load()
    return g


def build_distributed_pipeline(cfg: SummaryConfig, num_nodes: int, num_edges: int,
                               device, perms=None):
    """The launcher's backend: compact grouping, capacity factor 32, lean sort."""
    return make_distributed_backend(cfg, num_nodes, num_edges, grouping="compact",
                                    capacity_factor=32.0, lean_sort=True, device=device,
                                    perms=perms)


def run_distributed(shards: EdgeShards, v: int, cfg: SummaryConfig, device,
                    pipeline=None, *, checkpointer=None, monitor=None,
                    resume: bool = False) -> tuple:
    """Merge rounds and the final sparsification over this rank's shard.

    Returns ``(state, stats, size_g, run)``: ``stats`` holds the last round's
    stats, the post-sparsification metrics and ``sparsify_wall_s``, the same
    on every rank.
    """
    if shards.num_nodes is not None and shards.num_nodes != v:
        raise ValueError(f"shards came from a cache with |V|={shards.num_nodes} but "
                         f"run_distributed was called with v={v}")
    if pipeline is None:
        pipeline = build_distributed_pipeline(cfg, v, shards.num_edges, device)
    backend = pipeline.bind(shards.src, shards.dst)
    run = SummaryEngine(backend).run(collect_history=True, checkpointer=checkpointer,
                                     monitor=monitor, resume=resume)
    out = {k: float(x) for k, x in (run.last_stats or {}).items()}
    fin = run.finalize["stats"]
    vals = torch.stack([fin[k].to(torch.float32) for k in fin]).cpu().numpy()
    out.update({k: float(x) for k, x in zip(fin, vals)})
    out["sparsify_wall_s"] = run.sparsify_wall_s
    return run.state, out, run.input_size_bits, run


def _run_local(args, g, cfg, device, ckp, monitor) -> tuple[dict, str]:
    """The local mode's result keys and digests line."""
    (src, dst), v = g.edges(), g.num_nodes
    before = ops.launch_counts()
    t0 = time.time()
    res = summarize(src, dst, v, cfg, device=device, checkpointer=ckp, monitor=monitor,
                    resume=args.resume)
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
    digests = (f"digests node2super={digest(res.node2super)} "
               f"super_size={digest(res.super_size)} edge_w={digest(res.edge_w)}")
    return result, digests


def _run_distributed(args, g, cfg, device, ckp, monitor, multihost: bool
                     ) -> tuple[dict, str]:
    """``--distributed`` on the group :func:`init_distributed` joined: the
    result keys and digests line (the same on every rank but for the
    ``process_index``). ``multihost``: the group came from the bootstrap."""
    dist = torch.distributed
    rank, world = dist.get_rank(), dist.get_world_size()
    src, dst, v = g.src, g.dst, g.num_nodes
    t_feed = time.time()
    if multihost and g.cache_dir is None:
        raise SystemExit("multi-process summarize needs a CSR-cached graph "
                         "(--edge-list or a cached registry dataset): the "
                         "synthetic in-memory path would materialize the "
                         "full edge list on every host")
    if g.cache_dir is not None and world > 1:
        shards = shard_edges_from_cache_multihost(g.cache_dir, rank, world, device)
    elif g.cache_dir is not None:
        shards = shard_edges_from_cache(g.cache_dir, rank, world, device)
    else:
        graph, _ = make_graph(src, dst, v, "cpu")
        shards = shard_edges(graph.src.numpy(), graph.dst.numpy(), rank, world, device)
    feed_wall_s = time.time() - t_feed
    pipeline = build_distributed_pipeline(cfg, v, shards.num_edges, device)
    before = ops.launch_counts()
    t0 = time.time()
    state, stats, size_g, run = run_distributed(
        shards, v, cfg, device, pipeline, checkpointer=ckp, monitor=monitor,
        resume=args.resume)
    after = ops.launch_counts()
    fs = shards.stats
    result = {
        "dataset": args.edge_list or args.dataset, "V": v, "E": len(src),
        "mode": f"distributed{{'ranks': {world}}}",
        "device": str(device),
        "backend": torch.distributed.get_backend(),
        "size_bits": stats["size_bits"],
        "size_bits_before_sparsify": stats["size_bits_before"],
        "relative_size": stats["size_bits"] / size_g,
        "re1": stats["re1"], "re2": stats["re2"],
        "num_supernodes": stats["num_supernodes"],
        "num_superedges": stats["num_superedges"],
        "superedges_dropped": stats["dropped"],
        "iterations": run.iterations_run,
        "sparsify_wall_s": stats["sparsify_wall_s"],
        "feed_wall_s": feed_wall_s,
        "feed_path": fs.path,
        "feed_shard_rows": fs.shard_rows,
        "feed_shard_bytes": fs.shard_bytes,
        "feed_peak_staging_bytes": fs.peak_staging_bytes,
        "feed_bytes_copied": fs.bytes_copied,
        "feed_local_shards": fs.local_shards,
        "process_count": world,
        "process_index": rank,
        "bucket_cap": pipeline.last_cap,
        "bucket_bytes": bucket_bytes(pipeline.last_cap, world),
        "history": run.history,
        "chunk_wall_s": run.chunk_wall_s,
        "straggler_events": [dataclasses.asdict(ev) for ev in run.straggler_events],
        "resumed_from": run.resumed_from,
        "checkpoint_saves": run.checkpoint_saves,
        "checkpoint_snapshot_wall_s": run.checkpoint_snapshot_wall_s,
        "wall_s": time.time() - t0,
        "kernel_launches": {k: after[k] - before[k] for k in after},
    }
    digests = (f"digests node2super={digest(state.node2super.to(torch.int32).cpu().numpy())} "
               f"super_size={digest(state.size.to(torch.int32).cpu().numpy())}")
    return result, digests


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
    ap.add_argument("--distributed", action="store_true",
                    help="edge-sharded over torch.distributed: the ranks of torchrun, "
                         "of the --coordinator bootstrap, or a world of one (NCCL on "
                         "cuda, gloo on cpu)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="torch.distributed rendezvous address for a process-"
                         "spanning run (process 0 listens there); every process "
                         "passes the same value")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="total processes in the run (default: "
                         "$SSUMM_NUM_PROCESSES, else single-process)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank in [0, --num-processes)")
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")
    # the bootstrap's flags resolve before anything else, as the reference's
    # (a ValueError for a missing coordinator or process id)
    n_proc = resolve_flags(args.coordinator, args.num_processes, args.process_id)[1]
    if n_proc > 1 and not args.distributed:
        ap.error("--coordinator/--num-processes only make sense with "
                 "--distributed")
    device = resolve_device(args.device)  # raises before any work without CUDA

    # a group this call makes, it also ends; one the caller made stays
    own_group = args.distributed and not torch.distributed.is_initialized()
    # under the bootstrap every process prints its own result, as the
    # reference's do; otherwise rank 0 prints for every rank
    multihost = own_group and n_proc > 1 and not under_torchrun()
    t_load = time.time()
    load = lambda: load_graph(args.edge_list or args.dataset,  # noqa: E731
                              chunk_edges=args.chunk_edges, refresh=args.reingest,
                              scale=args.scale, seed=args.seed)
    rank = 0
    if args.distributed:
        rank, _, device = init_distributed(device, args.coordinator, args.num_processes,
                                           args.process_id)
        g = load_rank0_first(load)
    else:
        g = load()
    load_wall_s = time.time() - t_load
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

    t0 = time.time()
    try:
        if args.distributed:
            result, digests = _run_distributed(args, g, cfg, device, ckp, monitor,
                                               multihost)
        else:
            result, digests = _run_local(args, g, cfg, device, ckp, monitor)
    except Preempted as p:
        # save-and-exit: the committed checkpoint is the resume point;
        # RESUMABLE_EXIT tells the supervisor "rerun me with --resume"
        if rank == 0 or multihost:
            print(json.dumps(dict(ingest, preempted=True, checkpoint_step=p.step,
                                  checkpoint_dir=args.checkpoint_dir,
                                  wall_s=time.time() - t0), indent=1), flush=True)
        raise SystemExit(RESUMABLE_EXIT)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()
    if rank != 0 and not multihost:  # rank 0 prints for every rank
        return {}
    result.update(ingest)
    if ckp is not None:
        stats = ckp.manager.save_stats.values()
        result["checkpoint_dir"] = args.checkpoint_dir
        result["checkpoint_write_wall_s"] = sum(s["write_wall_s"] or 0.0 for s in stats)
        result["checkpoint_bytes"] = max((s["bytes"] or 0 for s in stats), default=0)
    result["peak_rss_mb"] = peak_rss_mb()
    print(digests)
    print(json.dumps(result, indent=1), flush=True)
    if args.rss_budget_mb is not None and result["peak_rss_mb"] > args.rss_budget_mb:
        raise SystemExit(f"peak RSS {result['peak_rss_mb']:.1f} MB exceeds the "
                         f"--rss-budget-mb {args.rss_budget_mb:.1f} MB gate")
    return result


if __name__ == "__main__":
    main()
