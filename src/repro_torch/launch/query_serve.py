"""Batched summary-query serving driver of the port.

    PYTHONPATH=src python -m repro_torch.launch.query_serve --dataset dblp \\
        --scale 0.05 --k-frac 0.3 --T 10 --requests 512 --batch 64
    PYTHONPATH=src python -m repro_torch.launch.query_serve --edge-list g.txt.gz \\
        --queries degree,adjacency,pagerank,triangle,khop,cut,conductance

Port of the local mode of ``repro/launch/query_serve.py``. Loads the graph
through :func:`repro_torch.graphs.load_graph` (real file, then its CSR
cache, then the registry's synthetic stand-in), summarizes it, builds the
:class:`repro_torch.core.query_engine.QueryEngine`, and serves a mixed
analytics workload — expected degree, adjacency weight, PageRank, triangle
density, k-hop neighborhood size, cut weight, conductance — through the
static-slot scheduler: requests pack into a fixed ``--batch``-wide slot
vector, mixed kinds route per slot through one batched dispatch, and slots
refill from the queue each step. The JSON has the reference's keys for its
local mode (p50/p99 per-request latency, QPS, an order-independent sha256
digest of the answers), plus the device, the hand kernels' launch counts
and the engine's sizes. It runs on the card unless ``--device cpu`` is
given; without CUDA the default raises.

``--distributed`` serves from one of the multi-rank tiers over
``torch.distributed`` (NCCL with ``--device cuda``, one card a rank; gloo
with ``--device cpu``): ``--tier replicated``
(:class:`~repro_torch.core.query_engine.RoutedQueryEngine`) or ``--tier
partitioned`` (:class:`~repro_torch.core.query_engine.PartitionedQueryEngine`,
``--dense-row-nnz`` its second-hop threshold). Under ``torchrun`` the ranks
come from the environment; without it the launcher makes a world of one.
Every rank summarizes the graph (the same seed, the same summary), draws
the same stream and serves it in lockstep, since the engine's collectives
sit inside each batch; rank 0 prints the JSON, with the reference's
``mode``, ``owner_counts`` and ``partition_stats``.

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.query_serve \\
        --distributed --tier partitioned --device cpu --dataset ego-facebook
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import time

import numpy as np
import torch

from repro_torch.core import SummaryConfig, summarize
from repro_torch.core.query_engine import (
    KIND_CUT,
    KIND_KHOP,
    KIND_NAMES,
    SET_KINDS,
    PartitionedQueryEngine,
    QueryEngine,
    RoutedQueryEngine,
    pack_set_counts,
)
from repro_torch.core.types import resolve_device
from repro_torch.graphs import DATASETS, load_graph
from repro_torch.kernels import ops
from repro_torch.launch.summarize import init_distributed, load_rank0_first


@dataclasses.dataclass
class QueryRequest:
    rid: int
    kind: int  # KIND_* (repro_torch.core.query_engine)
    u: int = 0  # target node (degree/pagerank; row side of adjacency)
    v: int = 0  # second node (adjacency); hop count k (khop)
    a: np.ndarray | None = None  # node set A (cut/conductance)
    b: np.ndarray | None = None  # node set B (cut)
    answer: float | None = None
    t_submit: float = 0.0
    t_done: float = 0.0


class QueryServer:
    """Fixed-slot batch scheduler over a query engine.

    Every step admits up to ``slots`` requests from the queue into the
    fixed-width slot vectors, answers them in one batched dispatch, and
    frees every slot for the next step. Idle slots are padded with a degree
    probe of node 0 and their answers dropped. Slots are independent lanes,
    so an answer does not depend on how requests pack into batches.
    """

    def __init__(self, engine, *, slots: int):
        self.engine = engine
        self.slots = slots
        self.queue: list[QueryRequest] = []
        self.done: list[QueryRequest] = []

    def submit(self, req: QueryRequest) -> None:
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def step(self) -> bool:
        """Serve one batch. Returns False when the queue is drained."""
        if not self.queue:
            return False
        batch = [self.queue.pop(0) for _ in range(min(self.slots, len(self.queue)))]
        kinds = np.zeros(self.slots, np.int32)
        u = np.zeros(self.slots, np.int64)
        v = np.zeros(self.slots, np.int64)
        for s, req in enumerate(batch):
            kinds[s], u[s], v[s] = req.kind, req.u, req.v
        if np.isin(kinds, SET_KINDS).any():
            sets_a = [None] * self.slots
            sets_b = [None] * self.slots
            for s, req in enumerate(batch):
                sets_a[s], sets_b[s] = req.a, req.b
            ca, cb, ov = pack_set_counts(self.engine.bs, kinds, sets_a, sets_b)
            answers = self.engine.answer_batch(kinds, u, v, ca, cb, ov)
        else:
            answers = self.engine.answer_batch(kinds, u, v)
        t = time.perf_counter()
        for s, req in enumerate(batch):
            req.answer = float(answers[s])
            req.t_done = t
            self.done.append(req)
        return True


def random_workload(rng, v: int, n: int, kinds: list[int],
                    max_set: int | None = None,
                    k_max: int = 4) -> list[QueryRequest]:
    """A uniform mixed-kind request stream over random target nodes.

    Set kinds (cut/conductance) draw random node sets of up to
    ``max_set`` nodes (default v//4, at least 1); khop draws k in
    [0, ``k_max``] carried in the v lane."""
    max_set = max(1, v // 4) if max_set is None else max_set
    out = []
    for rid in range(n):
        kind = kinds[rid % len(kinds)]
        req = QueryRequest(rid=rid, kind=kind,
                           u=int(rng.integers(0, v)),
                           v=int(rng.integers(0, v)))
        if kind == KIND_KHOP:
            req.v = int(rng.integers(0, k_max + 1))
        elif kind in SET_KINDS:
            req.a = rng.choice(v, size=int(rng.integers(1, max_set + 1)),
                               replace=False)
            if kind == KIND_CUT:
                req.b = rng.choice(
                    v, size=int(rng.integers(1, max_set + 1)),
                    replace=False)
        out.append(req)
    return out


def answers_digest(done: list[QueryRequest]) -> str:
    """Order-independent sha256 over (rid, float64 answer) pairs — equal
    digests ⇒ bit-identical answers for the same workload."""
    by_rid = sorted((r.rid, r.answer) for r in done)
    buf = np.array([[float(rid), float(ans)] for rid, ans in by_rid],
                   np.float64)
    return hashlib.sha256(buf.tobytes()).hexdigest()


def serve(server: QueryServer, reqs: list[QueryRequest]) -> float:
    """Submit every request, step until the queue drains; the wall seconds."""
    t0 = time.perf_counter()
    for req in reqs:
        server.submit(req)
    while server.step():
        pass
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", default="dblp", choices=sorted(DATASETS))
    ap.add_argument("--edge-list", default=None, metavar="PATH",
                    help="SNAP edge-list file; overrides --dataset/--scale")
    ap.add_argument("--chunk-edges", type=int, default=None)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--k-frac", type=float, default=0.3)
    ap.add_argument("--T", type=int, default=10)
    ap.add_argument("--group-size", type=int, default=32)
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64,
                    help="slot count of the static-batch scheduler")
    ap.add_argument("--queries", default="degree,adjacency,pagerank",
                    help="comma-separated kinds to mix "
                         f"(of {sorted(KIND_NAMES)}); triangle is opt-in — "
                         "it is the one summary-space query that is not "
                         "O(1) per probe on large summaries")
    ap.add_argument("--distributed", action="store_true",
                    help="a multi-rank tier over torch.distributed: the ranks of "
                         "torchrun, or a world of one (NCCL on cuda, gloo on cpu)")
    ap.add_argument("--tier", default="replicated", choices=("replicated", "partitioned"),
                    help="--distributed storage tier: the whole summary on every rank "
                         "(RoutedQueryEngine) or each rank's rows and halo "
                         "(PartitionedQueryEngine)")
    ap.add_argument("--dense-row-nnz", type=int, default=None,
                    help="partitioned tier: rows denser than this leave the resident "
                         "halo and take the second-hop route")
    ap.add_argument("--pagerank-iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the summary and the engine run (default: the card)")
    args = ap.parse_args(argv)

    kind_names = [k.strip() for k in args.queries.split(",") if k.strip()]
    unknown = [k for k in kind_names if k not in KIND_NAMES]
    if unknown:
        ap.error(f"unknown query kind(s) {unknown}; "
                 f"expected from {sorted(KIND_NAMES)}")
    kinds = [KIND_NAMES[k] for k in kind_names]
    device = resolve_device(args.device)  # raises before any work without CUDA
    # a group this call makes, it also ends; one the caller made stays
    own_group = args.distributed and not torch.distributed.is_initialized()
    try:
        return _serve(args, kinds, device)
    finally:
        if own_group and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _serve(args, kinds: list[int], device: torch.device) -> dict:
    t0 = time.time()
    load = lambda: load_graph(args.edge_list or args.dataset,  # noqa: E731
                              chunk_edges=args.chunk_edges, scale=args.scale, seed=args.seed)
    rank, world = 0, 1
    if args.distributed:
        rank, world, device = init_distributed(device)
        g = load_rank0_first(load)
    else:
        g = load()
    load_wall_s = time.time() - t0
    (src, dst), v = g.edges(), g.num_nodes
    cfg = SummaryConfig(T=args.T, k_frac=args.k_frac,
                        group_size=args.group_size, seed=args.seed)
    before = ops.launch_counts()
    t0 = time.time()
    res = summarize(src, dst, v, cfg, device=device, collect_history=False)
    summarize_wall_s = time.time() - t0

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    partition_stats = owner_counts = None
    if not args.distributed:
        engine = QueryEngine(res, device=device, pagerank_iters=args.pagerank_iters)
        mode = "local"
    elif args.tier == "partitioned":
        engine = PartitionedQueryEngine(res, device=device, pagerank_iters=args.pagerank_iters,
                                        dense_row_nnz=args.dense_row_nnz)
        mode = f"partitioned{{'ranks': {world}}}"
    else:
        engine = RoutedQueryEngine(res, device=device, pagerank_iters=args.pagerank_iters)
        mode = f"routed{{'ranks': {world}}}"
    build_peak = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        build_peak = torch.cuda.max_memory_allocated(device) - held
    build_wall_s = time.time() - t0
    if args.distributed:
        owner_counts = engine.owner_counts().tolist()
        if args.tier == "partitioned":
            partition_stats = engine.partition_stats()  # a collective: every rank

    rng = np.random.default_rng(args.seed)
    server = QueryServer(engine, slots=args.batch)
    # warmup: the lazy global queries the workload needs run outside the
    # timed window, as the reference's compile does
    serve(server, random_workload(rng, v, args.batch, kinds))
    server.done.clear()

    reqs = random_workload(rng, v, args.requests, kinds)
    wall = serve(server, reqs)
    after = ops.launch_counts()

    if rank != 0:  # rank 0 prints for every rank
        return {}
    lat = np.array([r.t_done - r.t_submit for r in server.done])
    per_kind = {name: int(sum(r.kind == k for r in server.done))
                for name, k in KIND_NAMES.items() if k in kinds}
    bs = engine.bs
    result = {
        "dataset": args.edge_list or args.dataset,
        "V": v, "E": len(src),
        "num_supernodes": res.num_supernodes,
        "num_superedges": res.num_superedges,
        "mode": mode,
        "device": str(device),
        "batch": args.batch,
        "requests": len(server.done),
        "queries": per_kind,
        "p50_latency_s": float(np.percentile(lat, 50)),
        "p99_latency_s": float(np.percentile(lat, 99)),
        "qps": len(server.done) / max(wall, 1e-9),
        "wall_s": wall,
        "summarize_wall_s": summarize_wall_s,
        "engine_build_wall_s": build_wall_s,
        # device bytes the engine's build took at its peak above what was held
        # before it (None on the CPU)
        "engine_build_peak_bytes": build_peak,
        "answers_digest": answers_digest(server.done),
        "source": g.source,
        "load_wall_s": load_wall_s,
        "blocks": {"S": bs.num_blocks, "nnz": bs.nnz, "D": bs.max_row_nnz()},
        "pagerank_iterations": engine.pagerank_iterations,
        "triangle_wedges": engine.triangle_wedges,
        "iterations": res.iterations_run,
        "kernel_launches": {k: after[k] - before[k] for k in after},
    }
    if args.distributed:
        result.update(backend=torch.distributed.get_backend(), owner_counts=owner_counts)
    if partition_stats is not None:
        result["partition_stats"] = partition_stats
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
