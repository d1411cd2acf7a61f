"""Measure checkpoint/resume overhead on the PyTorch port: the port's copy
of ``scripts/measure_resume.py`` (EXPERIMENTS.md §Resume).

    PYTHONPATH=src python scripts/torch_measure_resume.py \
        --dataset dblp --scale 0.2 --T 12 --driver-chunk 1          # on the card
    PYTHONPATH=src python scripts/torch_measure_resume.py --device cpu ...
    PYTHONPATH=src torchrun --nproc-per-node 2 scripts/torch_measure_resume.py \
        --distributed --device cpu ...                              # any world

Times three things against one workload:

  1. a plain run (no checkpointing) — the baseline wall;
  2. the same run saving at every chunk boundary — the loop's stall a save
     (the synchronous device→host snapshot), background write wall and
     committed bytes from ``CheckpointManager.save_stats``, and the total
     wall delta;
  3. a restore + resume from the *first* committed step — restore latency
     (fingerprint check + leaf loads + the copy to the device) and the
     resumed wall.

Every wall ends with ``torch.cuda.synchronize()`` on the card. The first
run is a warm-up (kernels loaded from the build directory, cuBLAS and the
allocator initialised), not a compile. Every run starts from the same
permutation state, so the timed runs do the same rounds.

Prints one JSON record (the reference's keys and ``device``);
``--distributed`` measures the edge-sharded backend over the default
process group instead of the single-device path: under ``torchrun`` its
ranks, else a world of one (NCCL on the card, gloo on the CPU). Rank 0
writes the checkpoints and prints.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time

import numpy as np


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", default="dblp")
    ap.add_argument("--edge-list", default=None)
    ap.add_argument("--scale", type=float, default=0.2)
    ap.add_argument("--k-frac", type=float, default=0.3)
    ap.add_argument("--T", type=int, default=12)
    ap.add_argument("--driver-chunk", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core import SummaryConfig, resolve_device
    from repro_torch.core.engine import EngineCheckpointer, SummaryEngine
    from repro_torch.graphs import load_graph
    from repro_torch.runtime import CheckpointManager

    device = resolve_device(args.device)
    cfg = SummaryConfig(T=args.T, k_frac=args.k_frac, seed=args.seed,
                        driver_chunk=args.driver_chunk)

    def load():
        return load_graph(args.edge_list or args.dataset, scale=args.scale,
                          seed=args.seed)

    rank, world = 0, 1
    if args.distributed:
        import torch.distributed as dist

        from repro_torch.core import make_graph
        from repro_torch.core.distributed import make_distributed_backend
        from repro_torch.graphs.feed import shard_edges, shard_edges_from_cache
        from repro_torch.launch.summarize import init_distributed, load_rank0_first

        rank, world, device = init_distributed(device)
        g = load_rank0_first(load)
        v = g.num_nodes
        if g.cache_dir is not None:
            shards = shard_edges_from_cache(g.cache_dir, rank, world, device)
        else:
            graph, _ = make_graph(g.src, g.dst, v, "cpu")
            shards = shard_edges(graph.src.numpy(), graph.dst.numpy(), rank, world,
                                 device)
        backend = make_distributed_backend(
            cfg, v, shards.num_edges, grouping="compact", capacity_factor=32.0,
            lean_sort=True, device=device).bind(shards.src, shards.dst)
        mode = f"distributed(world={world})"
    else:
        from repro_torch.core.engine import LocalBackend

        g = load()
        v = g.num_nodes
        backend = LocalBackend(g.src, g.dst, v, cfg, device=device)
        mode = "local"
    fin_key = "stats" if args.distributed else "after"
    perms0 = backend.perms.state_dict()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def run(resume=False, **kw):
        if not resume:  # each run draws from the same start
            backend.perms.load_state_dict(perms0)
        t0 = time.perf_counter()
        out = SummaryEngine(backend).run(collect_history=False, resume=resume, **kw)
        sync()
        return out, time.perf_counter() - t0

    run()  # warm-up: kernels loaded, cuBLAS and the allocator set up
    _, wall_plain = run()

    d = tempfile.mkdtemp(prefix="measure_resume_") if rank == 0 else None
    if world > 1:  # every rank restores from rank 0's directory
        box = [d]
        torch.distributed.broadcast_object_list(box, src=0)
        d = box[0]
    try:
        ck = EngineCheckpointer(manager=CheckpointManager(d, keep=1000), every=1)
        full, wall_ckpt = run(checkpointer=ck)
        stats = sorted(ck.manager.save_stats.items())
        snaps = [s["snapshot_wall_s"] for _, s in stats
                 if s["snapshot_wall_s"] is not None]
        writes = [s["write_wall_s"] for _, s in stats
                  if s["write_wall_s"] is not None]
        byts = [s["bytes"] for _, s in stats if s["bytes"]]

        steps = ck.manager.all_steps()
        if rank == 0:
            for s in steps[1:]:
                shutil.rmtree(f"{d}/step_{s:010d}")
        if world > 1:
            torch.distributed.barrier()
        ck2 = EngineCheckpointer(manager=CheckpointManager(d, keep=1000), every=1)
        t0 = time.perf_counter()
        restored = ck2.restore(backend)
        sync()
        restore_wall = time.perf_counter() - t0
        res, wall_resumed = run(checkpointer=ck2, resume=True)
        assert restored is not None and res.resumed_from == steps[0]
        assert float(res.finalize[fin_key]["size_bits"]) == \
            float(full.finalize[fin_key]["size_bits"])
    finally:
        if world > 1:
            torch.distributed.barrier()
        if rank == 0:
            shutil.rmtree(d, ignore_errors=True)
    if rank != 0:
        return None

    rec = {
        "mode": mode, "V": v, "E": int(g.num_edges),
        "dataset": args.edge_list or args.dataset,
        "device": str(device),
        "rounds": full.iterations_run,
        "saves": full.checkpoint_saves,
        "wall_plain_s": wall_plain,
        "wall_checkpointed_s": wall_ckpt,
        "overhead_frac": wall_ckpt / wall_plain - 1.0,
        "snapshot_mean_ms": 1e3 * float(np.mean(snaps)),
        "snapshot_total_ms": 1e3 * float(np.sum(snaps)),
        "write_mean_ms": 1e3 * float(np.mean(writes)),
        "checkpoint_bytes": int(np.max(byts)) if byts else 0,
        "restore_wall_ms": 1e3 * restore_wall,
        "wall_resumed_s": wall_resumed,
        "resumed_from_step": steps[0],
    }
    print(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
