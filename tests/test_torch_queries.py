"""The port's block summary and query engine against the numpy reference.

``repro.core.queries`` is the oracle (the reference's batched JAX engine
does not import on this JAX). Both get the same summaries: the port's own
``summarize`` results on two registry stand-ins, random summaries, and the
reference's edge cases (empty superedge set, self-loop-only blocks,
dangling and singleton blocks). Tolerances are those the reference held its
JAX engine to against numpy (``tests/test_queries_jax.py``): degree and
adjacency rtol 1e-12 / atol 1e-15, PageRank rtol 1e-9 / atol 1e-12 with an
equal number of power steps, triangles rtol 1e-9, cut, conductance and
k-hop atol 1e-9. The expected degree is held to the last bit: its row sums
add in numpy's order.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import queries as Q

from repro_torch.core import SummaryConfig, summarize
from repro_torch.core import queries as PQ
from repro_torch.core.query_engine import (
    KIND_ADJACENCY,
    KIND_CONDUCTANCE,
    KIND_CUT,
    KIND_DEGREE,
    KIND_KHOP,
    KIND_PAGERANK,
    KIND_TRIANGLE,
    QueryEngine,
    pack_set_counts,
)
from repro_torch.core.types import SummaryResult
from repro_torch.graphs import generate
from repro_torch.kernels import ops, ref
from repro_torch.kernels.segment_sum import LONG_ROW, long_rows, ordered_sum_cuda, segment_sum_cuda

torch.set_num_threads(1)

CPU = torch.device("cpu")


def make_result(node2super, pairs) -> SummaryResult:
    """A SummaryResult carrying just the summary graph (metrics zeroed)."""
    node2super = np.asarray(node2super, np.int32)
    v = node2super.shape[0]
    return SummaryResult(
        node2super=node2super,
        super_size=np.bincount(node2super, minlength=v).astype(np.int32),
        edge_lo=np.array([p[0] for p in pairs], np.int32),
        edge_hi=np.array([p[1] for p in pairs], np.int32),
        edge_w=np.array([p[2] for p in pairs], np.int64),
        num_supernodes=int(np.unique(node2super).shape[0]), num_superedges=len(pairs),
        size_bits=0.0, input_size_bits=1.0, re1=0.0, re2=0.0, mdl_cost=0.0,
        iterations_run=0)


def random_summary(seed: int, v_max: int = 28, edge_frac: float = 0.5) -> SummaryResult:
    """The reference tests' random partition and superedge set (weights
    within each pair's capacity, no zero-capacity self pairs)."""
    rng = np.random.default_rng(seed)
    v = int(rng.integers(4, v_max))
    s = int(rng.integers(1, v + 1))
    ids = np.sort(rng.choice(v, size=s, replace=False)).astype(np.int32)
    node2super = rng.choice(ids, size=v).astype(np.int32)
    node2super[rng.permutation(v)[:s]] = ids
    live = np.unique(node2super)
    n = np.bincount(node2super, minlength=v)[live].astype(np.int64)
    pairs = []
    for i, a in enumerate(live):
        for j in range(i, len(live)):
            cap = n[i] * (n[i] - 1) // 2 if i == j else n[i] * n[j]
            if cap > 0 and rng.random() < edge_frac:
                pairs.append((int(a), int(live[j]), int(rng.integers(1, cap + 1))))
    return make_result(node2super, pairs)


@functools.lru_cache(maxsize=None)
def real_summary(dataset: str, scale: float) -> SummaryResult:
    src, dst, v = generate(dataset, seed=2, scale=scale)
    return summarize(src, dst, v, SummaryConfig(T=6, k_frac=0.4, seed=2), device=CPU,
                     collect_history=False)


CASES = {
    "ego-facebook@0.05": lambda: real_summary("ego-facebook", 0.05),
    "caida@0.02": lambda: real_summary("caida", 0.02),
    "empty-superedge-set": lambda: random_summary(7, edge_frac=0.0),
    "self-loop-only": lambda: make_result([0, 0, 0, 3, 3, 5], [(0, 0, 3), (3, 3, 1)]),
    "dangling-singleton": lambda: make_result([0, 0, 2, 3, 3, 3, 6], [(0, 2, 1), (2, 3, 2)]),
    **{f"random-{seed}": functools.partial(random_summary, seed) for seed in (0, 1, 2, 3, 4)},
    "random-wide": lambda: random_summary(13, v_max=90, edge_frac=0.3),
}


def fresh(name: str) -> SummaryResult:
    """A copy of the case without either package's memoized block summary."""
    return dataclasses.replace(CASES[name]())


def port_engine(res, **kw) -> QueryEngine:
    return QueryEngine(res, device=CPU, **kw)


def numpy_pagerank_steps(bs, iters: int = 50) -> int:
    """The power steps the reference's loop takes: the first n whose result
    a budget of n steps already gives (its break is the only way to stop
    before ``iters``)."""
    full = Q.pagerank_blocks(bs, iters=iters)
    for n in range(1, iters + 1):
        if np.array_equal(Q.pagerank_blocks(bs, iters=n), full):
            return n
    return iters


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_summary_arrays_equal_the_reference(name):
    res = fresh(name)
    want = Q.build_block_summary(res)
    got = PQ.build_block_summary(res, CPU)
    for field in ("ids", "node2block", "sizes", "indptr", "cols", "sigma", "deg_w", "deg"):
        a, b = getattr(got, field).numpy(), getattr(want, field)
        assert a.dtype == b.dtype, field
        assert np.array_equal(a, b), field
    assert got.num_nodes == want.num_nodes
    assert np.array_equal(got.rows.numpy(), want.rows)
    assert np.array_equal(got.key.numpy(), want.rows.astype(np.int64) * want.num_blocks
                          + want.cols)
    assert got.max_row_nnz() == want.max_row_nnz()


@pytest.mark.parametrize("name", sorted(CASES))
def test_point_queries_match_the_reference(name):
    res = fresh(name)
    v = res.node2super.shape[0]
    eng = port_engine(res)
    deg = eng.expected_degree(np.arange(v))
    deg_np = np.array([Q.expected_degree(res, u) for u in range(v)])
    assert np.array_equal(deg, deg_np)  # row sums in numpy's order
    assert [PQ.expected_degree(res, u, device=CPU) for u in range(v)] == deg_np.tolist()
    rng = np.random.default_rng(0)
    u = np.concatenate([rng.integers(0, v, 40), np.arange(v)[:8]])
    w = np.concatenate([rng.integers(0, v, 40), np.arange(v)[:8]])
    adj_np = np.array([Q.adjacency_weight(res, a, b) for a, b in zip(u, w)])
    np.testing.assert_allclose(eng.adjacency_weight(u, w), adj_np, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose([PQ.adjacency_weight(res, a, b, device=CPU)
                                for a, b in zip(u, w)], adj_np, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("name", sorted(CASES))
def test_pagerank_matches_the_reference_step_for_step(name):
    res = fresh(name)
    v = res.node2super.shape[0]
    eng = port_engine(res)
    pr_np = Q.pagerank_summary(res)
    np.testing.assert_allclose(eng.pagerank_nodes(np.arange(v)), pr_np, rtol=1e-9, atol=1e-12)
    assert eng.pagerank_iterations == numpy_pagerank_steps(Q.build_block_summary(res))
    np.testing.assert_allclose(PQ.pagerank_summary(res, device=CPU).numpy(), pr_np,
                               rtol=1e-9, atol=1e-12)
    p7, steps = PQ.pagerank_power(PQ.build_block_summary(res, CPU), iters=7)
    np.testing.assert_allclose(p7.numpy(), Q.pagerank_blocks(Q.build_block_summary(res), iters=7),
                               rtol=1e-9, atol=1e-12)
    assert steps == min(7, eng.pagerank_iterations)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("wedge_chunk", [PQ.WEDGE_CHUNK, 5, 1])
def test_triangles_match_the_reference(name, wedge_chunk):
    res = fresh(name)
    want = Q.triangle_density(res)
    eng = port_engine(res, triangle_wedge_chunk=wedge_chunk)
    np.testing.assert_allclose(eng.triangle_density(), want, rtol=1e-9, atol=1e-12)
    bs = Q.build_block_summary(res)
    rows = bs.rows
    wedges = sum(int(np.sum(bs.cols[bs.indptr[b]:bs.indptr[b + 1]] > b))
                 for a, b in zip(rows, bs.cols) if b > a)
    assert eng.triangle_wedges == wedges
    np.testing.assert_allclose(PQ.triangle_density(res, device=CPU), want, rtol=1e-9, atol=1e-12)


def _sets(rng, v, n):
    """Random node sets with repeats, plus the empty set and all nodes."""
    out = [rng.integers(0, v, int(rng.integers(0, v + 1))) for _ in range(n)]
    return out + [np.array([], np.int64), np.arange(v)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_cut_and_conductance_match_the_reference(name):
    res = fresh(name)
    v = res.node2super.shape[0]
    eng = port_engine(res)
    rng = np.random.default_rng(1)
    sets_a, sets_b = _sets(rng, v, 6), _sets(rng, v, 6)[::-1]
    cut_np = np.array([Q.cut_weight(res, a, b) for a, b in zip(sets_a, sets_b)])
    np.testing.assert_allclose(eng.cut_weight(sets_a, sets_b), cut_np, rtol=0, atol=1e-9)
    np.testing.assert_allclose([PQ.cut_weight(res, a, b, device=CPU)
                                for a, b in zip(sets_a, sets_b)], cut_np, rtol=0, atol=1e-9)
    cond_np = np.array([Q.conductance(res, a) for a in sets_a])
    np.testing.assert_allclose(eng.conductance(sets_a), cond_np, rtol=0, atol=1e-9)
    np.testing.assert_allclose([PQ.conductance(res, a, device=CPU) for a in sets_a], cond_np,
                               rtol=0, atol=1e-9)
    bs_np = Q.build_block_summary(res)
    for a in sets_a:
        assert np.array_equal(PQ.block_counts(eng.bs, a).numpy(), Q.block_counts(bs_np, a))


@pytest.mark.parametrize("name", sorted(CASES))
def test_k_hop_matches_the_reference(name):
    res = fresh(name)
    v = res.node2super.shape[0]
    eng = port_engine(res)
    rng = np.random.default_rng(2)
    u = rng.integers(0, v, 12)
    k = np.concatenate([[0, 0], rng.integers(1, 5, 8), [eng.khop_max, eng.khop_max]])
    want = np.array([Q.k_hop_size(res, int(a), int(b)) for a, b in zip(u, k)])
    np.testing.assert_allclose(eng.k_hop_size(u, k), want, rtol=0, atol=1e-9)
    np.testing.assert_allclose([PQ.k_hop_size(res, int(a), int(b), device=CPU)
                                for a, b in zip(u, k)], want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mixed_batch_matches_the_single_queries(name):
    """One batch of every kind (twice over) against the single-query
    reference, and each slot's answer the same as in a batch of its own."""
    res = fresh(name)
    v = res.node2super.shape[0]
    eng = port_engine(res)
    rng = np.random.default_rng(3)
    kinds = np.array([KIND_DEGREE, KIND_ADJACENCY, KIND_PAGERANK, KIND_TRIANGLE,
                      KIND_KHOP, KIND_CUT, KIND_CONDUCTANCE] * 2, np.int32)
    b = kinds.size
    u = rng.integers(0, v, b)
    w = rng.integers(0, v, b)
    w[kinds == KIND_KHOP] = rng.integers(0, 4, int((kinds == KIND_KHOP).sum()))
    sets_a, sets_b = _sets(rng, v, b - 2), _sets(rng, v, b - 2)
    ans = eng.answer_batch(kinds, u, w, *pack_set_counts(eng.bs, kinds, sets_a, sets_b))
    pr = Q.pagerank_summary(res)
    for s in range(b):
        want = {KIND_DEGREE: lambda: Q.expected_degree(res, u[s]),
                KIND_ADJACENCY: lambda: Q.adjacency_weight(res, u[s], w[s]),
                KIND_PAGERANK: lambda: pr[u[s]],
                KIND_TRIANGLE: lambda: Q.triangle_density(res),
                KIND_KHOP: lambda: Q.k_hop_size(res, int(u[s]), int(w[s])),
                KIND_CUT: lambda: Q.cut_weight(res, sets_a[s], sets_b[s]),
                KIND_CONDUCTANCE: lambda: Q.conductance(res, sets_a[s])}[kinds[s]]()
        np.testing.assert_allclose(ans[s], want, rtol=1e-9, atol=1e-9)
        one = eng.answer_batch(kinds[s:s + 1], u[s:s + 1], w[s:s + 1],
                               *pack_set_counts(eng.bs, kinds[s:s + 1], sets_a[s:s + 1],
                                                sets_b[s:s + 1]))
        assert one[0] == ans[s]


def test_block_build_memoized_per_device():
    res = fresh("random-0")
    before = PQ.BLOCK_BUILDS
    PQ.expected_degree(res, 0, device=CPU)
    PQ.pagerank_summary(res, device=CPU)
    PQ.triangle_density(res, device=CPU)
    port_engine(res)
    assert PQ.BLOCK_BUILDS == before + 1
    port_engine(dataclasses.replace(res))  # another result object builds its own
    assert PQ.BLOCK_BUILDS == before + 2


def test_entry_points_refuse_the_default_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device runs")
    res = fresh("random-1")
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryEngine(res)
    with pytest.raises(RuntimeError, match="CUDA"):
        PQ.expected_degree(res, 0)


@pytest.mark.parametrize("lengths", [
    [0, 3, 0, 0, 5, 1], [1] * 50, [0] * 7, [4000, 0, 2, 3000]])
def test_segment_sum_plain_version_is_numpy_order(lengths):
    """The plain segment sum adds each segment left to right from zero,
    as ``np.add.at`` does: bit for bit, on values of mixed sign and scale."""
    rng = np.random.default_rng(len(lengths))
    rows = np.repeat(np.arange(len(lengths)), lengths)
    vals = rng.standard_normal(rows.size) * np.exp(rng.standard_normal(rows.size) * 8)
    want = np.zeros(len(lengths))
    np.add.at(want, rows, vals)
    indptr = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64))
    got = ops.segment_sum(indptr, torch.as_tensor(vals))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, ref.segment_sum_ref(indptr, torch.as_tensor(vals)))


def test_ordered_sum_rows_do_not_depend_on_the_batch():
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((5, 3 * PQ.SUM_SEGMENT + 17)) * 1e3)
    whole = PQ.ordered_sum(x)
    for i in range(5):
        assert PQ.ordered_sum(x[i:i + 1])[0] == whole[i]
    seq = 0.0
    for lo in range(0, x.shape[1], PQ.SUM_SEGMENT):  # the documented order
        part = 0.0
        for val in x[0, lo:lo + PQ.SUM_SEGMENT].tolist():
            part += val
        seq += part
    assert whole[0].item() == seq
    assert PQ.ordered_sum(torch.zeros(3, 0, dtype=torch.float64)).tolist() == [0.0] * 3


def test_segment_sum_kernel_refuses_cpu_tensors():
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        segment_sum_cuda(torch.zeros(2, dtype=torch.int64), torch.zeros(1, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        ops.segment_sum(torch.zeros(2, dtype=torch.int64), torch.zeros(1, dtype=torch.float64),
                        backend="kernel")
    assert ops.launch_counts() == before


def _spread(rng, shape):
    """Values of mixed sign whose exponents spread over about ±8 decades."""
    return rng.standard_normal(shape) * np.exp(rng.standard_normal(shape) * 8)


def _two_pass(x: torch.Tensor) -> torch.Tensor:
    """The two ``segment_sum_ref`` passes that ``ordered_sum`` made before it
    had a kernel of its own, as they were written."""
    k, n = x.shape
    if n == 0 or k == 0:
        return torch.zeros(k, dtype=torch.float64)
    m = -(-n // PQ.SUM_SEGMENT)
    starts = (torch.arange(k)[:, None] * n
              + torch.arange(m)[None, :] * PQ.SUM_SEGMENT).reshape(-1)
    indptr = torch.cat([starts, torch.tensor([k * n])])
    part = ref.segment_sum_ref(indptr, x.reshape(-1).to(torch.float64).contiguous())
    return ref.segment_sum_ref(torch.arange(0, k * m + 1, m), part)


@pytest.mark.parametrize("k", [0, 1, 9, 64])
@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 5000])
def test_ordered_sum_plain_version_is_the_two_pass_order(k, n):
    """Bit for bit the old two-pass composition, and numpy's ``np.add.at`` of
    each 1024-value segment, then of the segments' sums."""
    x = torch.as_tensor(_spread(np.random.default_rng(k * 7919 + n), (k, n)))
    got = ref.ordered_sum_ref(x, PQ.SUM_SEGMENT)
    assert got.dtype == torch.float64 and got.shape == (k,)
    assert torch.equal(got, _two_pass(x))
    m = max(-(-n // PQ.SUM_SEGMENT), 1)
    part = np.zeros(k * m)
    np.add.at(part, (np.arange(k)[:, None] * m + np.arange(n)[None, :] // PQ.SUM_SEGMENT
                     ).reshape(-1), x.numpy().reshape(-1))
    want = np.zeros(k)
    np.add.at(want, np.repeat(np.arange(k), m), part)
    assert np.array_equal(got.numpy(), want)


def test_ordered_sum_dispatch_on_the_cpu():
    """``ops.ordered_sum`` takes the plain version for a CPU tensor, launches
    nothing, and refuses ``backend="kernel"``; ``queries.ordered_sum`` is it."""
    x = torch.as_tensor(_spread(np.random.default_rng(5), (3, 2100)))
    before = ops.launch_counts()
    want = ref.ordered_sum_ref(x, PQ.SUM_SEGMENT)
    for backend in (None, "ref"):
        assert torch.equal(ops.ordered_sum(x, PQ.SUM_SEGMENT, backend=backend), want)
    assert torch.equal(PQ.ordered_sum(x), want)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ordered_sum(x, PQ.SUM_SEGMENT, backend="kernel")
    assert ops.launch_counts() == before
    assert ops.launch_counts()["ordered_sum"] == ordered_sum_cuda.launches


@pytest.mark.parametrize("x, match", [
    (torch.zeros(2, 8, dtype=torch.float64), "CUDA"),
    (torch.zeros(8, 2, dtype=torch.float64).t(), "contiguous"),
    (torch.zeros(2, 8, dtype=torch.float32), "float64"),
    (torch.zeros(16, dtype=torch.float64), "2-D"),
], ids=["cpu", "non-contiguous", "float32", "1-d"])
def test_ordered_sum_kernel_refuses_what_it_does_not_take(x, match):
    before = ordered_sum_cuda.launches
    with pytest.raises(ValueError, match=match):
        ordered_sum_cuda(x, PQ.SUM_SEGMENT)
    assert ordered_sum_cuda.launches == before


@pytest.mark.parametrize("length", [0, 1, 31, 32, 33, 4000])
def test_segment_sum_plain_version_is_numpy_order_around_the_warp(length):
    """Rows on both sides of the kernel's long-row threshold (``LONG_ROW``),
    between empty and one-value rows: bit for bit ``np.add.at``."""
    lengths = [length, 0, 1, length, length]
    rng = np.random.default_rng(length)
    vals = _spread(rng, sum(lengths))
    want = np.zeros(len(lengths))
    np.add.at(want, np.repeat(np.arange(len(lengths)), lengths), vals)
    indptr = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64))
    got = ops.segment_sum(indptr, torch.as_tensor(vals), long_rows(indptr))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("lengths", [[], [0], [31, 32, 33, 0, 1024], [33] * 5,
                                     [0, 4000, 2, 2500]])
def test_long_rows_lists_the_rows_longer_than_a_warp(lengths):
    indptr = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64))
    got = long_rows(indptr)
    assert got.dtype == torch.int64
    assert got.tolist() == np.nonzero(np.asarray(lengths) > LONG_ROW)[0].tolist()


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_summary_keeps_its_long_rows(name):
    bs = port_engine(fresh(name)).bs
    assert torch.equal(bs.long_rows, long_rows(bs.indptr))


def test_node_ids_out_of_range_raise():
    res = fresh("random-2")
    eng = port_engine(res)
    v = res.node2super.shape[0]
    for bad in (-1, v):
        with pytest.raises(IndexError, match="node ids"):
            eng.expected_degree([0, bad])
        with pytest.raises(IndexError, match="node ids"):
            eng.cut_weight([np.array([0, bad])], [np.array([1])])
    with pytest.raises(ValueError, match="hop counts"):
        eng.k_hop_size([0], -1)
