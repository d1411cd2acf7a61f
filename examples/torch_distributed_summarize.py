"""Distributed SSumM on the PyTorch port: edge-sharded summarization over
``torch.distributed``, the port's copy of ``examples/distributed_summarize.py``.

    PYTHONPATH=src python examples/torch_distributed_summarize.py --device cpu   # 8 gloo ranks
    PYTHONPATH=src python examples/torch_distributed_summarize.py                # the card(s)
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_distributed_summarize.py \
        --device cpu                                                             # any world

Shards the edge list over P ranks, one process a rank, and runs the paper's
iteration loop through the SummaryEngine over the edge-sharded
DistributedBackend (``repro_torch.core.distributed``): an all-to-all pair
exchange and owner-local merge rounds with the compact group-owner
grouping. The partition and the global metrics are the same on every rank;
rank 0 prints the reference's lines, then one JSON line.

Where the reference lays the edges over a (2, 4) mesh of 8 host devices,
the port starts ``--ranks`` processes itself when it is not run under
``torchrun``: 8 gloo ranks on the CPU by default, and on CUDA one NCCL rank
a visible card (one card holds one NCCL rank). Under ``torchrun`` it takes
the ranks it is given.
"""

import argparse
import json
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import SummaryConfig, make_graph, resolve_device
from repro_torch.core.distributed import make_distributed_backend
from repro_torch.core.engine import SummaryEngine
from repro_torch.graphs import generate
from repro_torch.graphs.feed import shard_edges
from repro_torch.kernels import ops
from repro_torch.launch.mesh import under_torchrun
from repro_torch.launch.summarize import init_distributed


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes to start outside torchrun (default: 8 on the "
                         "CPU, the visible cards on CUDA)")
    return ap.parse_args(argv)


def summarize_rank(device: torch.device, perms=None) -> dict:
    """This rank's part of the run, in the default process group; rank 0
    prints. Returns the result record (the same on every rank)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    say = print if rank == 0 else (lambda *a, **k: None)
    src, dst, v = generate("dblp", seed=0, scale=0.02)
    graph, _ = make_graph(src, dst, v, "cpu")
    e = graph.num_edges
    size_g = 2.0 * e * np.log2(max(v, 2))
    say(f"graph: |V|={v} |E|={e}  Size(G)={size_g:,.0f} bits")
    say(f"ranks: {world} ({dist.get_backend()}, {device.type}), one edge shard a rank")

    cfg = SummaryConfig(T=10, k_frac=0.3)
    # compact group-owner sharding (the web-scale path); small graphs need
    # a generous routing capacity (few groups → skew)
    backend = make_distributed_backend(cfg, v, e, grouping="compact",
                                       capacity_factor=32.0, lean_sort=True,
                                       device=device, perms=perms)
    # per-rank feed: each rank stages and copies only its own shard
    shards = shard_edges(graph.src.numpy(), graph.dst.numpy(), rank, world, device)
    say(f"edge shard per rank: {shards.stats.shard_rows} edges "
        f"(host staging {shards.stats.peak_staging_bytes} B — one shard)")

    before = ops.launch_counts()
    run = SummaryEngine(backend.bind(shards.src, shards.dst)).run()
    after = ops.launch_counts()
    k_bits = run.k_bits
    for row in run.history:
        say(f"  t={int(row['t']):2d} θ={row['theta']:.2f} "
            f"|S|={int(row['num_supernodes']):5d} "
            f"size={row['size_bits']:12,.0f} bits "
            f"({100 * row['size_bits'] / size_g:5.1f}%) "
            f"merges={int(row['nmerges']):4d} "
            f"overflow={int(row['overflow'])}")
    reached = bool(run.last_stats and run.last_stats["size_bits"] <= k_bits)
    if reached:
        say("  budget reached")

    fin = run.finalize["stats"]
    sp = {k: float(x) for k, x in zip(fin, torch.stack(
        [fin[k].to(torch.float64) for k in fin]).cpu().numpy())}
    say(f"sparsify: ξ={int(sp['xi'])} "
        f"dropped={int(sp['dropped'])} superedges → "
        f"size={sp['size_bits']:12,.0f} bits "
        f"({100 * sp['size_bits'] / size_g:5.1f}%) "
        f"RE₁={sp['re1']:.4f}")
    out = {"device": str(device), "backend": dist.get_backend(), "world": world,
           "V": v, "E": e, "size_g": size_g, "k_bits": k_bits,
           "rounds": [{k: row[k] for k in ("t", "theta", "num_supernodes", "size_bits",
                                           "nmerges", "overflow", "re1")}
                      for row in run.history],
           "budget_reached": reached, "iterations": run.iterations_run,
           "xi": sp["xi"], "dropped": sp["dropped"], "size_bits": sp["size_bits"],
           "re1": sp["re1"], "relative_size": sp["size_bits"] / size_g,
           "shard_rows": shards.stats.shard_rows,
           "peak_staging_bytes": shards.stats.peak_staging_bytes,
           "bucket_cap": backend.last_cap,
           "kernel_launches": {k: after[k] - before[k] for k in after}}
    say(json.dumps(out))
    return out


def _child(rank: int, world: int, device_type: str, perms, tmp: str) -> None:
    """One spawned rank: join the group through a file store, run, and leave
    rank 0's record in ``tmp``."""
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)  # P ranks share the host's cores
        device = torch.device("cpu")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        out = summarize_rank(device, perms)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "rank0.pkl"), "wb") as f:
            pickle.dump(out, f)


def main(argv=None, perms=None) -> dict:
    """Run the example; ``perms`` is the backend's permutation source
    (default: ``SeededPermutations`` of the config's seed). Returns rank 0's
    record."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    joined = under_torchrun() or dist.is_initialized()
    if joined and args.ranks is not None:
        raise SystemExit("--ranks is for runs outside torchrun")
    ranks = 1 if joined else args.ranks or (
        torch.cuda.device_count() if device.type == "cuda" else 8)
    if device.type == "cuda" and ranks > torch.cuda.device_count():
        raise SystemExit(f"--ranks {ranks}: one NCCL rank a card, and "
                         f"{torch.cuda.device_count()} card(s) are visible")
    if ranks == 1:  # in this process: torchrun's or the caller's group, or a world of one
        made = not dist.is_initialized()
        _, _, device = init_distributed(device)
        try:
            return summarize_rank(device, perms)
        finally:
            if made:
                dist.destroy_process_group()
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="torch-dist-example-") as tmp:
        mp.spawn(_child, args=(ranks, device.type, perms, tmp), nprocs=ranks, join=True)
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            return pickle.load(f)


if __name__ == "__main__":
    main()
