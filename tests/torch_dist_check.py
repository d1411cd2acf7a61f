"""Subprocess side of tests/test_torch_distributed*.py.

Two roles, one per command:

  * ``python tests/torch_dist_check.py reference OUT.npz EDGE_LIST`` — the
    JAX reference's edge-sharded backend on a 4-device host mesh (jax locks
    its device count at first use, hence a process of its own with
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4``). It records, for
    both groupings (the compact one also without the lean sort), the θ = ∞
    round's stats and five rounds of ``step`` from the initial state
    (per-round stats, ``node2super`` and ``size``), the
    permutations each round drew (the compact path's ``(h, tie)`` a round,
    the hash path's per round and device), and the edge shards of
    the in-memory and CSR-cache feeds of ``EDGE_LIST`` (ingested by the
    reference into its cache), each checked to sit on the device whose
    ``axis_index`` is its rank.
  * the port's side runs in the test process's children: :func:`spawn`
    starts ``P`` processes joined in one gloo group and calls a case function
    of this module in each; each rank returns a picklable result, collected
    per rank.

The graph is ego-facebook at scale 0.05 with ``SummaryConfig(T=5,
k_frac=0.3)``, as ``tests/dist_check.py`` uses.
"""

from __future__ import annotations

import os
import sys

DATASET = ("ego-facebook", 0, 0.05)  # name, generator seed, scale
ROUNDS = 5
N_DEV = 4
CAP_COMPACT = 64.0  # the reference's dist_check.py factors
CAP_HASH = 4.0
# the runs both packages record: grouping (with "-tie": the compact grouping
# without the lean sort) → capacity factor
GROUPINGS = {"compact": CAP_COMPACT, "compact-tie": CAP_COMPACT, "hash": CAP_HASH}


def _reference(out_path: str, edge_list: str) -> None:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N_DEV}"
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.core.distributed import make_distributed_backend
    from repro.core.types import SummaryConfig, init_state, make_graph
    from repro.dist import make_rules, shard_map
    from repro.graphs import generate
    from repro.graphs import io as rio
    from repro.graphs.feed import shard_edges, shard_edges_from_cache
    from repro.launch.mesh import make_host_mesh

    assert jax.device_count() == N_DEV
    name, gen_seed, scale = DATASET
    src, dst, v = generate(name, seed=gen_seed, scale=scale)
    graph, _ = make_graph(src, dst, v)
    e = graph.num_edges
    mesh = make_host_mesh((2, 2), ("data", "model"))
    rules = make_rules(mesh, "summarize")
    cfg = SummaryConfig(T=ROUNDS, k_frac=0.3)
    rec: dict = {"v": v, "e": e}

    # ---- shards: the device whose axis_index is r holds rows of shard r ----
    def rank_of_rows(s):
        return s, jnp.full(s.shape, jax.lax.axis_index(rules.axis_names), jnp.int32)

    where = jax.jit(shard_map(rank_of_rows, mesh=mesh, in_specs=(rules.edge_spec,),
                              out_specs=(rules.edge_spec, rules.edge_spec),
                              check_vma=False))
    rio.write_edge_list(edge_list, np.asarray(graph.src), np.asarray(graph.dst), v)
    cached = rio.load_graph(edge_list)
    feeds = {"memory": shard_edges(np.asarray(graph.src), np.asarray(graph.dst), mesh),
             "cache": shard_edges_from_cache(cached.cache_dir, mesh)}
    for tag, sh in feeds.items():
        with mesh:
            rows, rank = where(sh.src)
        rows, rank = np.asarray(rows), np.asarray(rank)
        per = rows.shape[0] // N_DEV
        assert (rank == np.repeat(np.arange(N_DEV), per)).all(), tag
        rec[f"{tag}_src"] = np.asarray(sh.src).reshape(N_DEV, per)
        rec[f"{tag}_dst"] = np.asarray(sh.dst).reshape(N_DEV, per)
        assert (rec[f"{tag}_src"] == rows.reshape(N_DEV, per)).all(), tag
        for k, x in sh.stats.asdict().items():
            if isinstance(x, int):
                rec[f"{tag}_stat_{k}"] = x
    rec["cache_dir"] = np.asarray(cached.cache_dir)
    src_p, dst_p = feeds["memory"].src, feeds["memory"].dst

    # ---- the permutations each round draws ----------------------------------
    compact_h, compact_tie = [], []
    rng = jax.random.PRNGKey(cfg.seed)
    for _ in range(ROUNDS):
        k_h, k_tie, rng = jax.random.split(rng, 3)
        compact_h.append(np.asarray(jax.random.permutation(k_h, v)))
        compact_tie.append(np.asarray(jax.random.permutation(k_tie, v)))
    rec["compact_h"], rec["compact_tie"] = np.stack(compact_h), np.stack(compact_tie)
    hash_h, hash_tie = [], []
    rng = jax.random.PRNGKey(cfg.seed)
    for _ in range(ROUNDS):
        hs, ts = [], []
        for d in range(N_DEV):
            k_s, k_t = jax.random.split(jax.random.fold_in(rng, d))
            hs.append(np.asarray(jax.random.permutation(k_s, v)))
            ts.append(np.asarray(jax.random.permutation(k_t, v)))
        hash_h.append(hs)
        hash_tie.append(ts)
        rng = jax.random.fold_in(rng, 1729)
    rec["hash_h"], rec["hash_tie"] = np.asarray(hash_h), np.asarray(hash_tie)

    # ---- θ = ∞ and five rounds of step: both groupings, and the compact one
    # with the 3-key (dead, shingle, tie) grouping sort ------------------------
    for grouping, cap in GROUPINGS.items():
        be = make_distributed_backend(mesh, cfg, v, e, grouping=grouping.split("-")[0],
                                      capacity_factor=cap, lean_sort=grouping != "compact-tie")
        state = init_state(v, cfg.seed)
        with mesh:
            _, st = be.step(src_p, dst_p, state, jnp.float32(1e9), jnp.uint32(1))
        for k, x in st.items():
            rec[f"{grouping}_inf_{k}"] = float(x)
        stats, n2s, sizes = [], [], []
        with mesh:
            for t in range(1, ROUNDS + 1):
                theta = 1.0 / (1.0 + t) if t < cfg.T else 0.0
                state, st = be.step(src_p, dst_p, state, jnp.float32(theta),
                                    jnp.uint32(t))
                stats.append({k: float(x) for k, x in st.items()})
                n2s.append(np.asarray(state.node2super))
                sizes.append(np.asarray(state.size))
        rec[f"{grouping}_keys"] = np.asarray(sorted(stats[0]))
        rec[f"{grouping}_stats"] = np.asarray(
            [[s[k] for k in sorted(s)] for s in stats], np.float64)
        rec[f"{grouping}_node2super"] = np.stack(n2s)
        rec[f"{grouping}_size"] = np.stack(sizes)
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

    with tempfile.TemporaryDirectory(prefix="torch-dist-") as tmp:
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


def graph():
    """The fixture graph, canonical, as numpy (the port's generator)."""
    from repro_torch.core.types import make_graph
    from repro_torch.graphs import generate

    name, gen_seed, scale = DATASET
    src, dst, v = generate(name, seed=gen_seed, scale=scale)
    g, _ = make_graph(src, dst, v, "cpu")
    return g.src.numpy(), g.dst.numpy(), v


def _backend(world, rank, grouping, perms=None, cfg=None, **kw):
    """A backend on this rank's shard of the fixture graph; ``grouping`` is a
    key of GROUPINGS."""
    from repro_torch.core.distributed import make_distributed_backend
    from repro_torch.core.types import SummaryConfig
    from repro_torch.graphs.feed import shard_edges

    src, dst, v = graph()
    cfg = cfg or SummaryConfig(T=ROUNDS, k_frac=0.3)
    be = make_distributed_backend(cfg, v, len(src), grouping=grouping.split("-")[0],
                                  capacity_factor=GROUPINGS[grouping],
                                  lean_sort=grouping != "compact-tie", device="cpu",
                                  perms=perms, **kw)
    sh = shard_edges(src, dst, rank, world, device="cpu")
    return be.bind(sh.src, sh.dst)


def _rounds(be, rounds=ROUNDS):
    """θ = ∞ from the initial state, then ``rounds`` rounds of ``step``."""
    import numpy as np

    src_l, dst_l = be._shards()
    state = be.init()
    _, st = be.step(src_l, dst_l, state, 1e9, 1)
    out = {"inf": {k: float(x) for k, x in st.items()}, "stats": [], "node2super": [],
           "size": []}
    for t in range(1, rounds + 1):
        theta = 1.0 / (1.0 + t) if t < be.cfg.T else 0.0
        state, st = be.step(src_l, dst_l, state, theta, t)
        out["stats"].append({k: float(x) for k, x in st.items()})
        out["node2super"].append(state.node2super.numpy().copy())
        out["size"].append(state.size.numpy().copy())
    out["state"] = (np.asarray(out["node2super"][-1]), np.asarray(out["size"][-1]))
    return out


def case_parity(rank, world, ref_npz, cache_dir):
    """Both groupings with the reference's draws, sparsification at four
    budgets on the hash run's partition, and this rank's shards."""
    import numpy as np

    from repro_torch.core.convert import ReplayRoundPermutations, state_from_numpy
    from repro_torch.core.types import SummaryConfig
    from repro_torch.graphs.feed import shard_edges, shard_edges_from_cache

    ref = np.load(ref_npz)
    res = {}
    res["compact"] = _rounds(_backend(world, rank, "compact",
                                      ReplayRoundPermutations(ref["compact_h"])))
    res["compact-tie"] = _rounds(_backend(
        world, rank, "compact-tie",
        ReplayRoundPermutations(ref["compact_h"], ref["compact_tie"])))
    be = _backend(world, rank, "hash",
                  ReplayRoundPermutations(ref["hash_h"], ref["hash_tie"]))
    res["hash"] = _rounds(be)
    state = state_from_numpy(*res["hash"]["state"], ROUNDS + 1, "cpu")
    src_l, dst_l = be._shards()
    probe, _ = be.sparsify(src_l, dst_l, state, 1e12, 7)
    size_now = float(probe["size_bits_before"])
    res["size_now"] = size_now
    res["sparsify"] = {}
    for tag, k_bits, error_p in (("k=0.9 size", 0.9 * size_now, 1),
                                 ("xi=0", 2.0 * size_now, 1),
                                 ("drop-all", 1.0, 1),
                                 ("error_p=2", 0.9 * size_now, 2)):
        be_p = be if error_p == 1 else _backend(
            world, rank, "hash", cfg=SummaryConfig(T=ROUNDS, k_frac=0.3, error_p=2))
        stats, pairs = be_p.sparsify(src_l, dst_l, state, k_bits, 7)
        res["sparsify"][tag] = (k_bits, {k: float(x) for k, x in stats.items()},
                                {k: x.numpy().copy() for k, x in pairs.items()})
    src, dst, v = graph()
    for tag, sh in (("memory", shard_edges(src, dst, rank, world, device="cpu")),
                    ("cache", shard_edges_from_cache(cache_dir, rank, world, device="cpu"))):
        res[f"{tag}_shard"] = (sh.src.numpy().copy(), sh.dst.numpy().copy(),
                               sh.stats.asdict())
    return res


def case_invariance(rank, world):
    """The compact grouping with the port's own seeded draws: five rounds."""
    res = _rounds(_backend(world, rank, "compact"))
    res.pop("state")
    return res


def _engine_values(run) -> dict:
    """What two runs of the engine are compared on."""
    fin = run.finalize["stats"]
    return {"iterations": run.iterations_run,
            "last": {k: x for k, x in run.last_stats.items() if k != "round_s"},
            "final": {k: float(x) for k, x in fin.items()},
            "history": [{k: h[k] for k in h if k not in ("round_s", "wall_s")}
                        for h in run.history],
            "node2super": run.state.node2super.numpy().copy(),
            "size": run.state.size.numpy().copy(), "resumed_from": run.resumed_from}


ENGINE_CASES = {
    "chunk8": {},
    "chunk1": {"driver_chunk": 1},
    "xi0": {"k_frac": None, "k_bits": 1e12},
    "drop-all": {"k_frac": None, "k_bits": 1.0, "ensure_budget": False},
}


def _cfg(**over):
    import dataclasses

    from repro_torch.core.types import SummaryConfig

    return dataclasses.replace(SummaryConfig(T=ROUNDS, k_frac=0.3), **over)


def case_engine(rank, world, ckdir):
    """The engine against the per-round host loop over ``step`` (and the
    sparsification at salt t + 1), for each of ENGINE_CASES; then a run
    checkpointed at every chunk boundary (driver_chunk 2), cut back to its
    first committed step (a copy of that is left in ``ckdir + "-p2"``) and
    resumed on this group."""
    import shutil

    import torch.distributed as dist

    from repro_torch.core.engine import EngineCheckpointer, SummaryEngine
    from repro_torch.runtime import CheckpointManager

    out = {}
    for tag, over in ENGINE_CASES.items():
        cfg = _cfg(**over)
        be = _backend(world, rank, "compact", cfg=cfg)
        src_l, dst_l = be._shards()
        k_bits = cfg.target_bits(be.input_size_bits())
        state, stats, t = be.init(), {}, 0
        for t in range(1, cfg.T + 1):
            theta = 1.0 / (1.0 + t) if t < cfg.T else 0.0
            state, st = be.step(src_l, dst_l, state, theta, t)
            stats = {k: float(x) for k, x in st.items()}
            if stats["size_bits"] <= k_bits:
                break
        sp, _ = be.sparsify(src_l, dst_l, state, k_bits, t + 1)
        loop = {"iterations": t, "last": stats,
                "final": {k: float(x) for k, x in sp.items()},
                "node2super": state.node2super.numpy().copy(),
                "size": state.size.numpy().copy()}
        out[tag] = {"loop": loop, "engine": _engine_values(SummaryEngine(be).run())}

    be = _backend(world, rank, "compact", cfg=_cfg(driver_chunk=2))
    full = SummaryEngine(be).run(checkpointer=EngineCheckpointer(
        CheckpointManager(ckdir, keep=50), every=1))
    mgr = CheckpointManager(ckdir, keep=50)
    steps = mgr.all_steps()
    dist.barrier()  # every rank has listed the steps before any goes
    if rank == 0:
        for st in steps[1:]:
            shutil.rmtree(os.path.join(ckdir, f"step_{st:010d}"))
        shutil.copytree(ckdir, ckdir + "-p2")
    dist.barrier()
    resumed = SummaryEngine(be).run(
        checkpointer=EngineCheckpointer(CheckpointManager(ckdir, keep=50), every=1),
        resume=True)
    out["resume"] = {"golden": _engine_values(full), "resumed": _engine_values(resumed),
                     "steps": steps, "saves": full.checkpoint_saves}
    return out


def case_resume(rank, world, ckdir, **over):
    """An uninterrupted run on this group, and a resume from ``ckdir``."""
    from repro_torch.core.engine import EngineCheckpointer, SummaryEngine
    from repro_torch.runtime import CheckpointManager

    be = _backend(world, rank, "compact", cfg=_cfg(**over))
    golden = SummaryEngine(be).run()
    resumed = SummaryEngine(be).run(
        checkpointer=EngineCheckpointer(CheckpointManager(ckdir, keep=50), every=1),
        resume=True)
    return {"golden": _engine_values(golden), "resumed": _engine_values(resumed)}


def case_preempt(rank, world, ckdir, signal_rank, signal_round):
    """A run in which rank ``signal_rank`` alone sends itself SIGTERM during
    round ``signal_round`` (driver_chunk 1): every rank must stop with
    ``Preempted`` at the same step, with that step committed."""
    import signal

    from repro_torch.core.engine import EngineCheckpointer, SummaryEngine
    from repro_torch.runtime import CheckpointManager, Preempted, PreemptionGuard

    be = _backend(world, rank, "compact", cfg=_cfg(driver_chunk=1))
    golden = SummaryEngine(be).run()
    guard = PreemptionGuard()
    step_of = be.step

    def step(src_l, dst_l, state, theta, salt, groups_all=None):
        out = step_of(src_l, dst_l, state, theta, salt, groups_all)
        if rank == signal_rank and state.t == signal_round:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    be.step = step
    ck = EngineCheckpointer(CheckpointManager(ckdir, keep=50), every=0, guard=guard)
    try:
        SummaryEngine(be).run(checkpointer=ck)
        stopped = None
    except Preempted as p:
        stopped = p.step
    finally:
        guard.restore()
    return {"golden": _engine_values(golden), "stopped": stopped,
            "signals": guard.signal_count, "committed": ck.manager.all_steps()}


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "reference":
        _reference(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(__doc__)
