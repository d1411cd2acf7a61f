"""Checkpoint and resume of the port's engine on the CPU: the cases of
tests/test_engine.py (resume at the first committed step under any
``driver_chunk``, resume from the final phase, the fingerprint gate, a cold
start from an empty directory, preemption), a resumed run held against the
live reference, and the exact total costs the card takes."""

import dataclasses
import functools
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from test_torch_reference import RTOL, configs, graph, perm_chain, reference_result

from repro_torch.core import SummaryConfig, costs, summarize
from repro_torch.core.convert import ReplayPermutations
from repro_torch.core.engine import (
    EngineCheckpointer,
    FingerprintMismatch,
    LocalBackend,
    SummaryEngine,
)
from repro_torch.core.types import init_state, make_graph
from repro_torch.runtime import CheckpointManager, Preempted, PreemptionGuard, StragglerMonitor

CPU = torch.device("cpu")
HISTORY_WALL = ("wall_s", "round_s")
INT_HISTORY = ("nmerges", "num_supernodes", "num_superedges", "t", "theta")
FLOAT_HISTORY = ("size_bits", "mdl_cost", "re1", "re2", "total_reduction")
EXACT = ("size_bits", "input_size_bits", "re1", "re2", "mdl_cost", "num_supernodes",
         "num_superedges", "iterations_run")
ARRAYS = ("node2super", "super_size", "edge_lo", "edge_hi", "edge_w")
RESUME_CFG = SummaryConfig(T=10, k_frac=0.2, seed=0, driver_chunk=3)


def _ckp(path, **kw):
    return EngineCheckpointer(manager=CheckpointManager(str(path), keep=kw.pop("keep", 50)),
                              **kw)


def _history(res):
    return [{k: x for k, x in h.items() if k not in HISTORY_WALL} for h in res.history]


def _assert_same_result(got, want):
    for k in EXACT:
        assert getattr(got, k) == getattr(want, k), k
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert _history(got) == _history(want)


def _keep_only(src_dir, step, dst_dir):
    """A copy of ``src_dir`` holding only the committed ``step``."""
    shutil.copytree(src_dir, dst_dir)
    for p in pathlib.Path(dst_dir).glob("step_*"):
        if int(p.name[len("step_"):]) != step:
            shutil.rmtree(p)


@functools.lru_cache(maxsize=None)
def _golden(cfg=RESUME_CFG):
    src, dst, v = graph("ego-facebook")
    return summarize(src, dst, v, cfg, device=CPU)


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """A checkpointed run of RESUME_CFG (every chunk) and its directory."""
    src, dst, v = graph("ego-facebook")
    d = tmp_path_factory.mktemp("full") / "ck"
    ck = _ckp(d, every=1)
    res = summarize(src, dst, v, RESUME_CFG, device=CPU, checkpointer=ck)
    return res, d, ck.manager.all_steps()


def test_checkpointed_run_equals_the_plain_run(full_run):
    res, _, steps = full_run
    _assert_same_result(res, _golden())
    assert res.checkpoint_saves >= 2 and steps
    assert res.checkpoint_snapshot_wall_s > 0.0


@pytest.mark.parametrize("resume_chunk", [3, 1, 8])
def test_local_resume_bit_identical(full_run, tmp_path, resume_chunk):
    """Killed right after the first committed step, resumed under another
    ``driver_chunk``: the uninterrupted run's result, bit for bit."""
    _, d, steps = full_run
    _keep_only(d, steps[0], tmp_path / "ck")
    cfg = dataclasses.replace(RESUME_CFG, driver_chunk=resume_chunk)
    src, dst, v = graph("ego-facebook")
    res = summarize(src, dst, v, cfg, device=CPU, checkpointer=_ckp(tmp_path / "ck", every=1),
                    resume=True)
    assert res.resumed_from == steps[0]
    golden = _golden()
    _assert_same_result(res, golden)
    assert [h["t"] for h in res.history] == list(range(1, golden.iterations_run + 1))


def test_resume_from_final_phase_skips_merging(tmp_path):
    """A crash in the sparsification resumes straight to finalize."""
    src, dst, v = graph("ego-facebook")
    cfg = SummaryConfig(T=4, k_frac=0.3, seed=0)
    golden = summarize(src, dst, v, cfg, device=CPU)
    full = summarize(src, dst, v, cfg, device=CPU, checkpointer=_ckp(tmp_path, every=0))
    assert full.checkpoint_saves == 1  # only the merge-done (phase "final") save
    res = summarize(src, dst, v, cfg, device=CPU, checkpointer=_ckp(tmp_path, every=0),
                    resume=True)
    assert res.resumed_from == golden.iterations_run
    assert res.chunk_wall_s == []  # no merge round ran again
    _assert_same_result(res, golden)


@pytest.fixture(scope="module")
def gate_dir(tmp_path_factory):
    src, dst, v = graph("ego-facebook")
    d = tmp_path_factory.mktemp("gate") / "ck"
    summarize(src, dst, v, SummaryConfig(T=4, k_frac=0.3, seed=0), device=CPU,
              checkpointer=_ckp(d, every=1))
    return d


@pytest.mark.parametrize("change,kind", [
    ("T", "config"), ("k_frac", "config"), ("group_size", "config"),
    ("graph", "graph"), ("dataset", "graph"), ("driver_chunk", None)])
def test_resume_fingerprint_gate(gate_dir, tmp_path, change, kind):
    """A checkpoint resumes only under the same config and graph; a change
    of ``driver_chunk`` alone is allowed."""
    src, dst, v = graph("ego-facebook")
    cfg = SummaryConfig(T=4, k_frac=0.3, seed=0)
    extra = None
    if change == "T":
        cfg = dataclasses.replace(cfg, T=5)
    elif change == "k_frac":
        cfg = dataclasses.replace(cfg, k_frac=0.25)
    elif change == "group_size":
        cfg = dataclasses.replace(cfg, group_size=16)
    elif change == "graph":
        src, dst = src[:-10], dst[:-10]
    elif change == "dataset":
        extra = {"dataset": "other"}
    elif change == "driver_chunk":
        cfg = dataclasses.replace(cfg, driver_chunk=1)
    d = tmp_path / "ck"
    shutil.copytree(gate_dir, d)
    ck = _ckp(d, every=1, graph_extra=extra)
    if kind is None:
        res = summarize(src, dst, v, cfg, device=CPU, checkpointer=ck, resume=True)
        assert res.resumed_from is not None
    else:
        with pytest.raises(FingerprintMismatch, match=kind):
            summarize(src, dst, v, cfg, device=CPU, checkpointer=ck, resume=True)


def test_resume_refuses_another_devices_generator_state(gate_dir, tmp_path):
    """A CUDA generator's position cannot continue a CPU run: the resume
    raises instead of drawing from a reseeded generator."""
    d = tmp_path / "ck"
    shutil.copytree(gate_dir, d)
    for manifest in d.glob("step_*/manifest.json"):
        m = json.loads(manifest.read_text())
        m["extra"]["perms"] = {"kind": "torch", "device_type": "cuda", "state": [0] * 16}
        manifest.write_text(json.dumps(m))
    src, dst, v = graph("ego-facebook")
    with pytest.raises(ValueError, match="cuda"):
        summarize(src, dst, v, SummaryConfig(T=4, k_frac=0.3, seed=0), device=CPU,
                  checkpointer=_ckp(d, every=1), resume=True)


def test_resume_with_empty_dir_starts_fresh(tmp_path):
    """``--resume`` against a directory with nothing committed is a cold
    start, not an error (a supervisor's retry loop depends on it)."""
    src, dst, v = graph("ego-facebook")
    cfg = SummaryConfig(T=3, k_frac=0.3, seed=0)
    golden = summarize(src, dst, v, cfg, device=CPU)
    res = summarize(src, dst, v, cfg, device=CPU, checkpointer=_ckp(tmp_path, every=1),
                    resume=True)
    assert res.resumed_from is None
    _assert_same_result(res, golden)


def test_resume_requires_checkpointer():
    src, dst, v = graph("ego-facebook")
    backend = LocalBackend(src, dst, v, SummaryConfig(T=2), device=CPU)
    with pytest.raises(ValueError, match="checkpointer"):
        SummaryEngine(backend).run(resume=True)


def test_preemption_saves_and_raises(tmp_path):
    """A pending signal is honored at the next host-sync point: the state is
    saved synchronously and ``Preempted`` carries the committed step."""
    src, dst, v = graph("ego-facebook")
    cfg = SummaryConfig(T=10, k_frac=0.2, seed=0, driver_chunk=2)
    guard = PreemptionGuard(signals=())
    guard._requested = True  # a signal already pending before the run
    ck = _ckp(tmp_path, every=1, guard=guard)
    with pytest.raises(Preempted) as ei:
        summarize(src, dst, v, cfg, device=CPU, checkpointer=ck)
    assert ei.value.step == 2  # the first chunk boundary
    assert ck.manager.latest_step() == 2
    res = summarize(src, dst, v, cfg, device=CPU, checkpointer=_ckp(tmp_path, every=1),
                    resume=True)
    assert res.resumed_from == 2
    _assert_same_result(res, _golden(cfg))


def test_engine_run_payload_consistent():
    """EngineRun's bookkeeping: k_bits, last_stats and history agree."""
    src, dst, v = graph("ego-facebook")
    cfg = SummaryConfig(T=4, k_frac=0.3, seed=1)
    backend = LocalBackend(src, dst, v, cfg, device=CPU)
    run = SummaryEngine(backend).run()
    assert run.k_bits == cfg.target_bits(run.input_size_bits)
    assert run.iterations_run == len(run.history)
    for k in backend.stat_keys:
        assert run.last_stats[k] == run.history[-1][k]
    assert run.sparsify_wall_s >= 0.0 and "after" in run.finalize
    assert len(run.chunk_wall_s) == 1 and run.chunk_wall_s[0] > 0.0
    assert run.straggler_events == []
    assert run.resumed_from is None and run.checkpoint_saves == 0


def test_straggler_monitor_brackets_chunks():
    src, dst, v = graph("ego-facebook")
    cfg = SummaryConfig(T=6, k_frac=0.2, seed=0, driver_chunk=2)
    mon = StragglerMonitor(warmup_steps=1000)  # never flags
    res = summarize(src, dst, v, cfg, device=CPU, monitor=mon)
    assert mon.count == len(res.chunk_wall_s) > 0
    assert res.straggler_events == []


def test_resumed_run_matches_live_reference(tmp_path):
    """With the reference's permutations replayed, a run cut after its first
    committed step and resumed gives the live reference's uninterrupted
    result: integer history, merge sets and summary arrays exact, float
    metrics within the reference's tolerance (the port adds its float32
    metrics in another order; tests/test_torch_summarize.py)."""
    src, dst, v = graph("ego-facebook")
    rcfg, pcfg = configs("ego-facebook", driver_chunk=3)
    chain = perm_chain(rcfg.seed, v, rcfg.T + rcfg.max_extra_iters)
    plain = summarize(src, dst, v, pcfg, device=CPU, perms=ReplayPermutations(chain))
    ck = _ckp(tmp_path / "full", every=1)
    summarize(src, dst, v, pcfg, device=CPU, perms=ReplayPermutations(chain),
              checkpointer=ck)
    first = ck.manager.all_steps()[0]
    _keep_only(tmp_path / "full", first, tmp_path / "cut")
    got = summarize(src, dst, v, dataclasses.replace(pcfg, driver_chunk=1), device=CPU,
                    perms=ReplayPermutations(chain), checkpointer=_ckp(tmp_path / "cut"),
                    resume=True)
    assert got.resumed_from == first
    _assert_same_result(got, plain)

    want = reference_result("ego-facebook")
    assert len(got.history) == len(want.history)
    for hg, hw in zip(got.history, want.history):
        for k in INT_HISTORY:
            assert hg[k] == hw[k], (hw["t"], k)
        for k in FLOAT_HISTORY:
            np.testing.assert_allclose(hg[k], hw[k], rtol=RTOL, err_msg=str((hw["t"], k)))
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    for k in ("num_supernodes", "num_superedges", "iterations_run"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("size_bits", "input_size_bits", "re1", "re2", "mdl_cost"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=RTOL, err_msg=k)


def _terms(which):
    """(num, ids, values) of a sum into per-id totals."""
    if which == "random":
        rng = np.random.default_rng(0)
        v, e = 50, 4000
        lo = torch.as_tensor(rng.integers(0, v, e))
        hi = torch.as_tensor(rng.integers(0, v, e))
        lo[:600] = 7  # a hub listed hundreds of times
        cost = torch.as_tensor(2.0 + rng.standard_normal(e) ** 2 * np.exp(
            rng.standard_normal(e) * 2), dtype=torch.float32)
        return v, (lo, hi), (cost, torch.where(lo != hi, cost, 0.0))
    src, dst, v = graph("ego-facebook")
    g, _ = make_graph(src, dst, v, CPU)
    state = init_state(v, CPU)
    pt = costs.build_pair_table(g.src, g.dst, state)
    met = costs.summary_metrics(pt, state, v, g.num_edges)
    pi = costs.pair_pi(pt, state.size)
    cost = torch.where(pt.valid, costs.pair_cost_star(pt.cnt, pi, met["cbar"],
                                                      costs.log2_f32(v, CPU)), 0.0)
    return v, (pt.lo, pt.hi), (cost, torch.where(pt.lo != pt.hi, cost, 0.0))


@pytest.mark.parametrize("which", ["random", "fixture pair table"])
def test_exact_index_sum_is_the_rounded_exact_sum_in_any_order(which):
    """The card's total costs: each total is the exact sum of its float32
    terms rounded once, whatever the order of the terms."""
    v, idx, vals = _terms(which)
    bound = float(sum(x.double().sum() for x in vals))
    got = costs.exact_index_sum(v, idx, vals, bound)
    # float64 adds of these terms are exact: each is at least 2, a float32,
    # and every total stays far below 2^30
    want = torch.zeros(v, dtype=torch.float64)
    for ids, x in zip(idx, vals):
        want.index_add_(0, ids, x.double())
    assert want.max() < 2.0 ** 30
    assert torch.equal(got, want.float())
    ids, x = torch.cat(idx), torch.cat(vals)
    perm = torch.randperm(ids.numel(), generator=torch.Generator().manual_seed(1))
    assert torch.equal(costs.exact_index_sum(v, (ids[perm],), (x[perm],), bound), got)
    chain = torch.zeros(v)
    for ids_k, x_k in zip(idx, vals):
        chain.index_add_(0, ids_k, x_k)
    np.testing.assert_allclose(got.numpy(), chain.numpy(), rtol=1e-5)


def test_total_costs_keep_the_reference_order_on_the_cpu():
    """On CPU tensors supernode_total_costs is the reference's float32 chain
    (all lo adds, then all hi adds), not the exact sum."""
    v, (lo, hi), (cost, hi_cost) = _terms("fixture pair table")
    src, dst, _ = graph("ego-facebook")
    g, _ = make_graph(src, dst, v, CPU)
    state = init_state(v, CPU)
    pt = costs.build_pair_table(g.src, g.dst, state)
    met = costs.summary_metrics(pt, state, v, g.num_edges)
    scal = torch.stack([met["cbar"], costs.log2_f32(v, CPU)])
    got = costs.supernode_total_costs(pt, costs.pair_pi(pt, state.size), scal, v)
    assert torch.equal(got, torch.zeros(v).index_add_(0, lo, cost).index_add_(0, hi, hi_cost))
