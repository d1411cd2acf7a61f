"""Subprocess side of tests/test_torch_query_tiers*.py.

Two roles:

  * ``python tests/torch_query_tiers_check.py reference OUT.npz IN.npz`` — the
    JAX reference's ``QueryEngine``, ``RoutedQueryEngine`` and
    ``PartitionedQueryEngine`` on a 4-device host mesh (jax locks its device
    count at first use, hence a process of its own with
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4``), on the summary
    and the mixed batch that ``IN.npz`` holds. Its ``queries_jax`` imports
    ``jax.experimental.enable_x64``, which this JAX lacks; ``jax.enable_x64``
    is the same context manager, so this process (and no other) puts it
    there before the import. Writes each engine's answers, PageRank blocks
    and triangle total, and the tiers' routing tables, to ``OUT.npz``, with
    the local and partitioned PageRank blocks of the reference's own
    summary of the same graph.
  * the port's side runs in the test process's children: :func:`spawn`
    starts ``P`` processes joined in one gloo group through a ``file://``
    store (no ports) and calls a case function of this module in each.

The summary is the port's own of ego-facebook at scale 0.05 with
``SummaryConfig(T=5, k_frac=0.3)`` (:func:`summary_arrays`).
"""

from __future__ import annotations

import os
import sys

N_DEV = 4
SUMMARY_KEYS = ("node2super", "super_size", "edge_lo", "edge_hi", "edge_w")
KIND_CYCLE = (0, 1, 2, 3, 4, 5, 6)  # degree .. conductance


def summary_arrays() -> dict:
    """The fixture summary, as numpy arrays (the port's summarizer on the CPU)."""
    from repro_torch.core import SummaryConfig, summarize
    from repro_torch.graphs import generate

    src, dst, v = generate("ego-facebook", seed=0, scale=0.05)
    res = summarize(src, dst, v, SummaryConfig(T=5, k_frac=0.3), device="cpu",
                    collect_history=False)
    return {k: getattr(res, k) for k in SUMMARY_KEYS}


def port_result(arrays: dict):
    """A port ``SummaryResult`` carrying the summary graph of ``arrays``."""
    from repro_torch.core.types import SummaryResult

    return SummaryResult(**{k: arrays[k] for k in SUMMARY_KEYS},
                         num_supernodes=int(len(set(arrays["node2super"].tolist()))),
                         num_superedges=int(len(arrays["edge_w"])), size_bits=0.0,
                         input_size_bits=1.0, re1=0.0, re2=0.0, mdl_cost=0.0, iterations_run=0)


def mixed_batch(v: int, b: int = 63, seed: int = 42):
    """One batch cycling through every kind, k-hop up to 5 hops, node sets of
    up to v/3 nodes: ``(kinds, u, w, sets_a, sets_b)`` (the reference's
    ``tests/query_serve_check.py`` batch)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    kinds = np.array([KIND_CYCLE[i % len(KIND_CYCLE)] for i in range(b)], np.int32)
    u = rng.integers(0, v, b)
    w = rng.integers(0, v, b)
    w[kinds == 4] = rng.integers(0, 6, int((kinds == 4).sum()))
    sets_a, sets_b = [None] * b, [None] * b
    for s in range(b):
        if kinds[s] in (5, 6):
            sets_a[s] = rng.choice(v, size=int(rng.integers(1, max(2, v // 3))), replace=False)
        if kinds[s] == 5:
            sets_b[s] = rng.choice(v, size=int(rng.integers(1, max(2, v // 3))), replace=False)
    return kinds, u, w, sets_a, sets_b


def _reference(out_path: str, in_path: str) -> None:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N_DEV}"
    import jax
    import jax.experimental

    jax.experimental.enable_x64 = jax.enable_x64  # before queries_jax is imported
    import numpy as np

    from repro.core.queries_jax import PartitionedQueryEngine, QueryEngine, RoutedQueryEngine
    from repro.core.types import SummaryResult
    from repro.launch.mesh import make_host_mesh

    assert jax.device_count() == N_DEV
    inp = dict(np.load(in_path))
    res = SummaryResult(**{k: inp[k] for k in SUMMARY_KEYS},
                        num_supernodes=int(np.unique(inp["node2super"]).size),
                        num_superedges=int(inp["edge_w"].size), size_bits=0.0,
                        input_size_bits=1.0, re1=0.0, re2=0.0, mdl_cost=0.0, iterations_run=0)
    mesh = make_host_mesh((2, 2), ("data", "model"))
    engines = {"local": QueryEngine(res), "routed": RoutedQueryEngine(res, mesh),
               "partitioned": PartitionedQueryEngine(res, mesh),
               "partitioned-dense": PartitionedQueryEngine(res, mesh, dense_row_nnz=2)}
    rec = {}
    batch = [inp[k] for k in ("kinds", "u", "w", "ca", "cb", "ov")]
    for name, eng in engines.items():
        rec[f"{name}_answers"] = eng.answer_batch(*batch)
        rec[f"{name}_pagerank"] = np.asarray(eng.pagerank_blocks())
        rec[f"{name}_triangle"] = np.float64(eng.triangle_density())
        if name != "local":
            rec[f"{name}_owner_counts"] = eng.owner_counts()
    # the reference's own summary of the same graph: the input on which its
    # partitioned tier misses its local engine's PageRank bits
    from repro.core import SummaryConfig, summarize
    from repro.graphs import generate

    src, dst, v = generate("ego-facebook", seed=0, scale=0.05)
    own = summarize(src, dst, v, SummaryConfig(T=5, k_frac=0.3))
    rec["own_local_pagerank"] = np.asarray(QueryEngine(own).pagerank_blocks())
    for dn in (None, 2):
        rec[f"own_partitioned_{dn}_pagerank"] = np.asarray(
            PartitionedQueryEngine(own, mesh, dense_row_nnz=dn).pagerank_blocks())
    np.savez(out_path, **rec)
    print("ok")


# ---------------------------------------------------------------------------
# The port's side: P gloo ranks in child processes
# ---------------------------------------------------------------------------


def spawn(world: int, case: str, **kw) -> list:
    """Run ``case`` (a function of this module) on ``world`` gloo ranks in
    child processes; returns each rank's result, in rank order."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="torch-tiers-") as tmp:
        mp.spawn(_child, args=(world, case, kw, tmp), nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def _child(rank: int, world: int, case: str, kw: dict, tmp: str) -> None:
    import pickle

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        res = globals()[case](rank, world, **kw)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def engine_record(eng, batch) -> dict:
    """What the tests compare of an engine: a mixed batch's answers, the
    PageRank blocks and steps, the triangle total and wedges, and the digest
    of a served stream (set kinds packed by the server)."""
    import numpy as np

    from repro_torch.core.query_engine import pack_set_counts
    from repro_torch.launch.query_serve import QueryServer, answers_digest, random_workload, serve

    kinds, u, w, sets_a, sets_b = batch
    ca, cb, ov = pack_set_counts(eng.bs, kinds, sets_a, sets_b)
    rec = {"answers": eng.answer_batch(kinds, u, w, ca, cb, ov),
           "pagerank": eng.pagerank_blocks().numpy(), "steps": eng.pagerank_iterations,
           "triangle": eng.triangle_density(), "wedges": eng.triangle_wedges}
    server = QueryServer(eng, slots=16)
    serve(server, random_workload(np.random.default_rng(3), eng.bs.num_nodes, 50,
                                  list(KIND_CYCLE)))
    rec["digest"] = answers_digest(server.done)
    if hasattr(eng, "owner_counts"):
        rec["owner_counts"] = eng.owner_counts()
    if hasattr(eng, "partition_stats"):
        rec["stats"] = eng.partition_stats()
    return rec


def case_tiers(rank: int, world: int, arrays: dict, shrink: bool = False) -> dict:
    """Both tiers (and the partitioned one with a forced second hop) on this
    group; with ``shrink``, ranks 0 and 1 then build them again on a group of
    the two (the others only join the group's creation)."""
    import torch.distributed as dist

    from repro_torch.core.query_engine import PartitionedQueryEngine, RoutedQueryEngine

    res = port_result(arrays)
    batch = mixed_batch(len(arrays["node2super"]))
    tiers = {"routed": lambda **kw: RoutedQueryEngine(res, device="cpu", **kw),
             "partitioned": lambda **kw: PartitionedQueryEngine(res, device="cpu", **kw),
             "partitioned-dense": lambda **kw: PartitionedQueryEngine(
                 res, device="cpu", dense_row_nnz=2, **kw)}
    out = {name: engine_record(make(), batch) for name, make in tiers.items()}
    if shrink:
        survivors = dist.new_group([0, 1])
        if rank < 2:
            for name, make in tiers.items():
                out[f"{name}-shrunk"] = engine_record(make(group=survivors), batch)
    return out


def case_launch(rank: int, world: int, argv: list) -> dict:
    """The query server's ``main`` on this group (rank 0 returns its JSON)."""
    from repro_torch.launch import query_serve

    return query_serve.main(argv)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "reference":
        _reference(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(__doc__)
