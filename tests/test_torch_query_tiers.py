"""The port's multi-rank query tiers against its single-device engine, and
its partition tables against the reference's.

Summaries: the port's own of ego-facebook at scale 0.05 (``T=5``, ``k_frac
0.3``; ``tests/torch_query_tiers_check.py``), and random summaries.

  * ``RoutedQueryEngine`` and ``PartitionedQueryEngine`` (also with a forced
    second hop, ``dense_row_nnz=2``) at 1, 2 and 4 gloo ranks, and again on a
    group of 2 after 4 (a rebuild on the survivors), equal the single-device
    CPU ``QueryEngine`` bit for bit: a mixed batch of every kind, the
    PageRank blocks and steps, the triangle total and wedges, a served
    stream's digest. The partition has more than one owner and a halo, and
    at 4 ranks each rank's resident row bytes are below the single-device
    CSR's.
  * The same in one process (``ranks=P``) on random summaries.
  * ``build_partition_tables`` equals the reference's field by field on
    P ∈ {1, 3, 8} × ``dense_row_nnz`` ∈ {None, 0, 2} (the reference's is taken
    from its source: the module imports a JAX API this JAX lacks, and the
    function is numpy only); its per-entry ``loc_share``/``loc_row`` equal the
    reference's padded rows at the real entries, whose padding holds the
    sentinels.
  * A ``segment_sum`` over some rows gives those rows of a launch over all:
    a row's sum depends on that row alone, which the owned-row launches of
    the tiers rely on.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import torch_query_tiers_check as tqc
from test_torch_queries import random_summary

from repro.core import queries as Q
from repro.dist import owner_hash_np

from repro_torch.core import queries as PQ
from repro_torch.core.query_engine import (
    PartitionedQueryEngine,
    QueryEngine,
    RoutedQueryEngine,
    build_partition_tables,
)
from repro_torch.dist import owner_hash
from repro_torch.kernels import ops

CPU = torch.device("cpu")
TIERS = ("routed", "partitioned", "partitioned-dense")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def arrays():
    return tqc.summary_arrays()


@pytest.fixture(scope="module")
def local(arrays):
    """The single-device CPU engine's record."""
    eng = QueryEngine(tqc.port_result(arrays), device=CPU)
    return tqc.engine_record(eng, tqc.mixed_batch(len(arrays["node2super"])))


@pytest.fixture(scope="module")
def four(arrays):
    """Both tiers on 4 gloo ranks, then on the group of ranks 0 and 1."""
    return tqc.spawn(4, "case_tiers", arrays=arrays, shrink=True)


def _same(got: dict, want: dict, label: str) -> None:
    assert np.array_equal(got["answers"], want["answers"]), label
    assert np.array_equal(got["pagerank"], want["pagerank"]), label
    assert got["steps"] == want["steps"], label
    assert got["triangle"] == want["triangle"], label
    assert got["wedges"] == want["wedges"], label
    assert got["digest"] == want["digest"], label


def _check_ranks(per_rank: list, local: dict, tiers, world: int, n_blocks: int) -> None:
    for tier in tiers:
        for r, rec in enumerate(per_rank):
            _same(rec[tier], local, f"{tier}, rank {r} of {world}")
        counts = per_rank[0][tier]["owner_counts"]
        assert counts.sum() == n_blocks and counts.shape == (world,)
        if world > 1:
            assert (counts > 0).sum() > 1, f"{tier}: one owner {counts}"
        if "stats" in per_rank[0][tier]:
            stats = per_rank[0][tier]["stats"]
            assert stats["owner_counts"] == counts.tolist()
            assert len(stats["resident_bytes_per_device"]) == world
            if world > 1:
                assert max(stats["halo_counts"]) > 0, f"{tier}: no halo"
            if tier == "partitioned-dense":
                assert stats["dense_rows"] > 0


@pytest.mark.parametrize("world", [1, 2])
def test_tiers_equal_the_local_engine(arrays, local, world):
    per_rank = tqc.spawn(world, "case_tiers", arrays=arrays)
    _check_ranks(per_rank, local, TIERS, world, len(set(arrays["node2super"].tolist())))


def test_tiers_at_four_ranks_and_after_a_shrink_to_two(arrays, local, four):
    n_blocks = len(set(arrays["node2super"].tolist()))
    _check_ranks(four, local, TIERS, 4, n_blocks)
    _check_ranks(four[:2], local, [t + "-shrunk" for t in TIERS], 2, n_blocks)
    before = four[0]["routed"]["owner_counts"]
    after = four[0]["routed-shrunk"]["owner_counts"]
    assert not np.array_equal(before[:2], after), "the shrink did not re-route"
    stats = four[0]["partitioned"]["stats"]
    resident, replicated = stats["resident_bytes_per_device"], stats["replicated_row_bytes"]
    assert max(resident) < replicated, (resident, replicated)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 13])
@pytest.mark.parametrize("ranks", [1, 3, 8])
def test_tiers_in_one_process_equal_the_local_engine(seed, ranks):
    """``ranks=P``: one process runs every rank's rows and merges them."""
    res = random_summary(seed, v_max=90 if seed == 13 else 28, edge_frac=0.3 if seed == 13
                         else 0.5)
    v = res.node2super.shape[0]
    batch = tqc.mixed_batch(v, b=21, seed=seed)
    want = tqc.engine_record(QueryEngine(dataclasses.replace(res), device=CPU), batch)
    for tier, make in (("routed", RoutedQueryEngine), ("partitioned", PartitionedQueryEngine)):
        for kw in ({}, {"dense_row_nnz": 0}) if tier == "partitioned" else ({},):
            eng = make(dataclasses.replace(res), device=CPU, ranks=ranks, **kw)
            _same(tqc.engine_record(eng, batch), want, f"{tier} {kw} ranks={ranks}")


def test_ranks_and_a_group_of_several_do_not_mix():
    res = random_summary(0)
    with pytest.raises(ValueError, match="no process group"):
        RoutedQueryEngine(res, device=CPU, ranks=2, group=object())


# ------------------------------------------------------ partition tables

def reference_tables():
    """The reference's ``build_partition_tables`` (with ``host_padded_rows``
    and ``PartitionTables``), taken from its source and run as it is."""
    path = pathlib.Path(Q.__file__).resolve().parent / "queries_jax.py"
    tree = ast.parse(path.read_text())
    keep = [n for n in tree.body if getattr(n, "name", None) in (
        "host_padded_rows", "PartitionTables", "build_partition_tables")]
    ns = {"np": np, "dataclasses": dataclasses, "BlockSummary": Q.BlockSummary}
    exec(compile(ast.Module(keep, []), str(path), "exec"), ns)
    return ns["build_partition_tables"]


FIELDS = ("n_devices", "s", "d", "dense_row_nnz", "owner", "block_pos", "own_gids",
          "halo_gids", "halo_src_dev", "halo_src_pos", "row_halo_gids", "dense_gids",
          "dense_slots")


@pytest.fixture(scope="module")
def table_cases(arrays):
    cases = {"ego-facebook": tqc.port_result(arrays)}
    cases.update({f"random-{k}": random_summary(k) for k in (0, 1, 2, 3, 4)})
    cases["random-wide"] = random_summary(13, v_max=90, edge_frac=0.3)
    return cases


@pytest.mark.parametrize("dense_row_nnz", [None, 0, 2])
@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_partition_tables_equal_the_reference(table_cases, n_dev, dense_row_nnz):
    ref_build = reference_tables()
    for name, res in table_cases.items():
        bs_ref = Q.build_block_summary(dataclasses.replace(res))
        bs = PQ.build_block_summary(dataclasses.replace(res), CPU)
        owner = owner_hash(bs.ids, 17, n_dev)
        assert np.array_equal(owner.numpy(), owner_hash_np(bs_ref.ids, 17, n_dev)), name
        got = build_partition_tables(bs, owner, n_dev, dense_row_nnz)
        want = ref_build(bs_ref, owner.numpy(), n_dev, dense_row_nnz)
        for f in FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            assert np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype, (name, f)
        s_own, h = want.own_gids.shape[1], want.halo_gids.shape[1]
        row_sent = s_own + want.row_halo_gids.shape[1] + n_dev * want.dense_slots.shape[1]
        lens = np.diff(bs_ref.indptr)
        for q in range(n_dev):
            own = want.own_gids[q][want.own_gids[q] >= 0]
            real = np.arange(want.d)[None, :] < lens[own][:, None]
            for mine, theirs, sent in ((got.loc_share[q], want.loc_share[q], s_own + h),
                                       (got.loc_row[q], want.loc_row[q], row_sent)):
                assert mine.dtype == np.int32, name
                assert np.array_equal(mine, theirs[:own.size][real]), (name, q)
                assert (theirs[:own.size][~real] == sent).all(), (name, q)
                assert (theirs[own.size:] == sent).all(), (name, q)


# ------------------------------------------------------ owned-row sums

@pytest.mark.parametrize("lengths", [
    [0, 3, 0, 0, 5, 1], [1] * 50, [40, 0, 2, 33, 32, 31, 7], [4000, 0, 2, 3000]])
def test_segment_sum_over_some_rows_equals_those_rows_of_all(lengths):
    rng = np.random.default_rng(len(lengths))
    indptr = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64))
    vals = torch.as_tensor(rng.standard_normal(int(indptr[-1]))
                           * np.exp(rng.standard_normal(int(indptr[-1])) * 8))
    full = ops.segment_sum(indptr, vals)
    for rows in (np.arange(len(lengths))[::2], np.arange(len(lengths))[1::3],
                 rng.permutation(len(lengths))[:3]):
        rows = torch.as_tensor(np.sort(rows))
        sub, ent, _ = PQ.row_entries(indptr, rows)
        got = ops.segment_sum(sub, vals[ent])
        assert torch.equal(got, full[rows])
