"""The port's baselines (``repro_torch.baselines``) against the reference's
(``repro.baselines``) on the CPU, on the same numpy inputs: the partition
evaluation (integers exact, floats to rtol 1e-12, and the dense brute force
of ``repro.core.evaluate``), k-Gs partitions equal at two seeds, S2L's
projection, seeding, assignment, update and whole run, and the reference's
own target and trend checks run on the port. SAA-Gs is held in
``test_torch_baselines_saa.py``."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro.baselines import common as rcommon
from repro.baselines import kgs as rkgs
from repro.baselines import s2l as rs2l
from repro.core import evaluate as ev
from repro.core.types import SummaryResult
from repro.graphs import generate as rgenerate

from repro_torch.baselines import (
    evaluate_partition,
    summarize_kgs,
    summarize_s2l,
    summarize_saa_gs,
)
from repro_torch.baselines import common as pcommon
from repro_torch.baselines import s2l as ps2l
from repro_torch.core import SummaryConfig, summarize
from repro_torch.graphs import generate

torch.set_num_threads(1)

RTOL = 1e-12  # float64 closed forms summed in another order
METRICS = ("num_supernodes", "num_superedges", "size_bits", "input_size_bits", "re1", "re2")


@functools.lru_cache(maxsize=None)
def graph(name="ego-facebook", seed=0, scale=0.05):
    src, dst, v = generate(name, seed=seed, scale=scale)
    rsrc, rdst, rv = rgenerate(name, seed=seed, scale=scale)
    assert rv == v and np.array_equal(rsrc, src) and np.array_equal(rdst, dst)
    return src, dst, v


def assert_same_result(got, want):
    assert got.name == want.name
    assert np.array_equal(got.node2super.cpu().numpy(), want.node2super)
    assert got.node2super.dtype == torch.int32
    for k in METRICS:
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=RTOL, err_msg=k)


def random_partition(v, groups, seed):
    raw = np.random.default_rng(seed).integers(0, groups, v)
    reps = {}
    return np.array([reps.setdefault(g, u) for u, g in enumerate(raw)])


@pytest.mark.parametrize("groups,seed", [(1, 0), (20, 4), (150, 5), (10_000, 6)])
def test_pair_counts_and_evaluation_equal_the_reference(groups, seed):
    src, dst, v = graph()
    n2s = random_partition(v, groups, seed)
    lo, hi, cnt = rcommon.pair_counts(src, dst, n2s)
    t = [torch.as_tensor(x).long() for x in (src, dst, n2s)]
    plo, phi, pcnt = pcommon.pair_counts(*t)
    assert np.array_equal(plo.numpy(), lo) and np.array_equal(phi.numpy(), hi)
    assert pcnt.dtype == torch.float64 and np.array_equal(pcnt.numpy(), cnt)
    assert_same_result(evaluate_partition(src, dst, v, n2s, "x", device="cpu"),
                       rcommon.evaluate_partition(src, dst, v, n2s, "x"))


def test_evaluate_partition_matches_dense():
    """The reference's dense brute force (``repro.core.evaluate``)."""
    src, dst, v = graph(seed=4)
    n2s = random_partition(v, 20, 4)
    res = evaluate_partition(src, dst, v, n2s, device="cpu")
    size = np.bincount(n2s, minlength=v)
    lo, hi, cnt = (x.numpy() for x in pcommon.pair_counts(
        *(torch.as_tensor(x).long() for x in (src, dst, n2s))))
    sr = SummaryResult(
        node2super=n2s.astype(np.int32), super_size=size.astype(np.int32),
        edge_lo=lo, edge_hi=hi, edge_w=cnt.astype(np.int64),
        num_supernodes=res.num_supernodes, num_superedges=res.num_superedges,
        size_bits=0, input_size_bits=0, re1=0, re2=0, mdl_cost=0, iterations_run=0)
    a = ev.dense_adjacency(src, dst, v)
    a_hat = ev.reconstruct_dense(sr)
    np.testing.assert_allclose(res.re1, ev.re_p_dense(a, a_hat, 1), rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(res.re2, ev.re_p_dense(a, a_hat, 2), rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(res.size_bits, ev.summary_size_bits_dense(sr), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_kgs_partition_equals_the_reference(seed):
    src, dst, v = graph()
    assert_same_result(summarize_kgs(src, dst, v, 0.3, seed=seed, device="cpu"),
                       rkgs.summarize_kgs(src, dst, v, 0.3, seed=seed))


# ---- S2L ---------------------------------------------------------------------

S2L_GRAPH = dict(name="email-enron", seed=0, scale=0.05)  # V = 1,834


def _record(module, monkeypatch):
    """Wrap ``module._assign`` to record every call's centers and labels."""
    calls, inner = [], module._assign

    def spy(x, c, *rest):
        out = inner(x, c, *rest)
        calls.append((np.asarray(c), np.asarray(out)))
        return out

    monkeypatch.setattr(module, "_assign", spy)
    return calls


def test_project_rows_bit_equal():
    src, dst, v = graph(**S2L_GRAPH)
    for dims, seed in ((22, 0), (8, 5)):
        assert np.array_equal(ps2l.project_rows(src, dst, v, dims, seed),
                              rs2l.project_rows(src, dst, v, dims, seed))


@pytest.mark.parametrize("seed", [0, 2])
def test_kmeans_seeding_and_every_lloyd_step_equal_the_reference(seed, monkeypatch):
    """The seeded centers are the reference's bit for bit; so is every Lloyd
    step's update (a sequential sum a cluster) and its assignment, except at
    distance near-ties, which the test lists and bounds."""
    src, dst, v = graph(**S2L_GRAPH)
    x = rs2l.project_rows(src, dst, v, 22, seed)
    k = int(0.3 * v)
    ref_calls = _record(rs2l, monkeypatch)
    port_calls = _record(ps2l, monkeypatch)
    want = rs2l.kmeans(x, k, seed=seed)
    got = ps2l.kmeans(x, k, seed=seed, device="cpu").numpy()
    assert np.array_equal(port_calls[0][0], ref_calls[0][0])  # seeded centers
    ties = []
    for i, ((c_ref, a_ref), (c_port, a_port)) in enumerate(zip(ref_calls, port_calls)):
        assert np.array_equal(c_port, c_ref), f"Lloyd step {i}: centers differ"
        for r in np.flatnonzero(a_port != a_ref):  # near-ties of the two products
            d = ((x[r].astype(np.float64) - c_ref[[a_ref[r], a_port[r]]]) ** 2).sum(1)
            ties.append((i, int(r), float(abs(d[0] - d[1]) / d.max())))
    assert all(gap < 1e-5 for *_, gap in ties), ties
    assert len(ref_calls) == len(port_calls)
    assert np.array_equal(got, want), ties


def test_assign_within_a_small_byte_budget_is_the_same():
    """Row chunks of any size give the labels of one whole [n, k] block."""
    src, dst, v = graph(**S2L_GRAPH)
    x = torch.as_tensor(rs2l.project_rows(src, dst, v, 22, 0))
    c = x[torch.as_tensor(np.random.default_rng(0).choice(v, 300, replace=False))]
    whole = ps2l._assign(x, c, chunk_bytes=1 << 40)
    for budget in (4 * 300, 4 * 300 * 7, 1 << 16):
        assert torch.equal(ps2l._assign(x, c, chunk_bytes=budget), whole)


def test_update_equals_the_reference_segment_sum():
    src, dst, v = graph(**S2L_GRAPH)
    x = rs2l.project_rows(src, dst, v, 22, 0)
    assign = np.random.default_rng(1).integers(0, 400, v).astype(np.int32)
    assign[assign == 7] = 8  # an empty cluster
    want_c, want_n = rs2l._update(x, assign, 400)
    got_c, got_n = ps2l._update(torch.as_tensor(x), torch.as_tensor(assign), 400)
    assert np.array_equal(got_n.numpy(), np.asarray(want_n))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("graph_kw", [dict(), S2L_GRAPH])
def test_summarize_s2l_equals_the_reference(graph_kw):
    src, dst, v = graph(**graph_kw)
    stats = {}
    got = summarize_s2l(src, dst, v, seed=0, device="cpu", stats=stats)
    want = rs2l.summarize_s2l(src, dst, v, seed=0)
    assert_same_result(got, want)
    assert 1 <= stats["lloyd_iters"] <= 25 and stats["seed_s"] > 0


# ---- the reference's own checks (tests/test_baselines.py), on the port -------

@pytest.mark.parametrize("method,fn", [
    ("kgs", summarize_kgs),
    ("s2l", summarize_s2l),
    ("saa_gs", summarize_saa_gs),
])
def test_baseline_reaches_target(method, fn):
    src, dst, v = graph()
    frac = 0.3
    res = fn(src, dst, v, target_frac=frac, seed=0, device="cpu")
    target = max(int(frac * v), 2)
    # s2l's k-means may leave some clusters empty; greedy methods hit exactly
    assert res.num_supernodes <= max(target, 2) * (1.15 if method == "s2l" else 1.0)
    assert res.num_supernodes >= 2
    assert np.isfinite(res.re1) and res.re1 >= 0
    assert res.size_bits > 0
    assert res.node2super.shape[0] == v


def test_kgs_error_monotone_in_target():
    src, dst, v = graph(seed=2)
    coarse = summarize_kgs(src, dst, v, target_frac=0.1, seed=2, device="cpu")
    fine = summarize_kgs(src, dst, v, target_frac=0.5, seed=2, device="cpu")
    assert fine.re1 <= coarse.re1 * 1.05


def test_ssumm_beats_baselines_at_equal_size():
    """The paper's headline (Fig. 4), trend-level, with the port's SSumM: at
    comparable output size, its RE₁ is never materially worse."""
    src, dst, v = graph(seed=1, scale=0.1)
    ss = summarize(src, dst, v, SummaryConfig(T=10, k_frac=0.3, seed=1), device="cpu")
    kg = summarize_kgs(src, dst, v, target_frac=0.3, seed=1, device="cpu")
    sa = summarize_saa_gs(src, dst, v, target_frac=0.3, seed=1, device="cpu")
    assert ss.size_bits <= max(kg.size_bits, sa.size_bits)
    assert ss.re1 <= sa.re1 * 1.1
