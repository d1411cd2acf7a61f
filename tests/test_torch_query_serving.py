"""The port's static-slot query server and its launcher.

The scheduler is a pure transport: answers depend only on each request,
never on how requests pack into batches (slot width 1, full width, a
ragged last batch, submissions between steps), and every answer equals the
reference's single-query numpy function (``repro.core.queries``) at the
tolerances of ``tests/test_torch_queries.py``. Two runs of one workload give
one digest.
"""

import ast
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import queries as Q

from repro_torch.core import SummaryConfig, summarize
from repro_torch.core.query_engine import (
    KIND_ADJACENCY,
    KIND_CONDUCTANCE,
    KIND_CUT,
    KIND_DEGREE,
    KIND_KHOP,
    KIND_NAMES,
    KIND_PAGERANK,
    KIND_TRIANGLE,
    SET_KINDS,
    QueryEngine,
)
from repro_torch.graphs import generate
from repro_torch.launch import query_serve
from repro_torch.launch.query_serve import (
    QueryRequest,
    QueryServer,
    answers_digest,
    random_workload,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
ALL_KINDS = sorted(KIND_NAMES.values())


@pytest.fixture(scope="module")
def served():
    src, dst, v = generate("ego-facebook", seed=2, scale=0.05)
    res = summarize(src, dst, v, SummaryConfig(T=6, k_frac=0.4, seed=2), device=CPU,
                    collect_history=False)
    return res, QueryEngine(res, device=CPU), v


def _drain(server, reqs):
    for r in reqs:
        server.submit(dataclasses.replace(r))
    steps = 0
    while server.step():
        steps += 1
    return {r.rid: r.answer for r in server.done}, steps


def _reference_answer(res, r, pr, tri):
    if r.kind == KIND_DEGREE:
        return Q.expected_degree(res, r.u)
    if r.kind == KIND_ADJACENCY:
        return Q.adjacency_weight(res, r.u, r.v)
    if r.kind == KIND_PAGERANK:
        return pr[r.u]
    if r.kind == KIND_TRIANGLE:
        return tri
    if r.kind == KIND_KHOP:
        return Q.k_hop_size(res, r.u, r.v)
    if r.kind == KIND_CUT:
        return Q.cut_weight(res, r.a, r.b)
    assert r.kind == KIND_CONDUCTANCE
    return Q.conductance(res, r.a)


@pytest.mark.parametrize("slots", [1, 8, 16, 40])
def test_batching_invariance(served, slots):
    """The same 37 requests of all seven kinds through slot widths 1, 8, 16
    (ragged last batches of 5 and 5) and 40 (one batch, three idle slots):
    every answer is bit-identical to the one-slot run and matches the
    numpy single-query reference."""
    res, engine, v = served
    reqs = random_workload(np.random.default_rng(0), v, 37, ALL_KINDS)
    one, _ = _drain(QueryServer(engine, slots=1), reqs)
    got, steps = _drain(QueryServer(engine, slots=slots), reqs)
    assert steps == -(-37 // slots)
    assert got == one
    pr = Q.pagerank_summary(res)
    tri = Q.triangle_density(res)
    for r in reqs:
        np.testing.assert_allclose(got[r.rid], _reference_answer(res, r, pr, tri),
                                   rtol=1e-9, atol=1e-9)


def test_slot_refill_and_step_count(served):
    """11 requests through 4 slots: exactly ceil(11/4) = 3 steps, every
    request answered once, the queue drained."""
    _, engine, v = served
    reqs = random_workload(np.random.default_rng(1), v, 11, [KIND_DEGREE, KIND_CUT])
    server = QueryServer(engine, slots=4)
    answers, steps = _drain(server, reqs)
    assert steps == 3
    assert sorted(answers) == list(range(11))
    assert not server.queue
    assert all(r.t_done >= r.t_submit > 0 for r in server.done)


def test_submit_between_steps(served):
    """Requests arriving while earlier batches are served are picked up by
    later steps, with unchanged answers."""
    _, engine, v = served
    reqs = random_workload(np.random.default_rng(2), v, 12, [KIND_DEGREE, KIND_PAGERANK,
                                                             KIND_CONDUCTANCE])
    base, _ = _drain(QueryServer(engine, slots=4), reqs)
    server = QueryServer(engine, slots=4)
    for r in reqs[:4]:
        server.submit(dataclasses.replace(r))
    assert server.step()
    for r in reqs[4:]:
        server.submit(dataclasses.replace(r))
    while server.step():
        pass
    assert {r.rid: r.answer for r in server.done} == base


def test_two_runs_give_one_digest(served):
    """A fresh engine on the same summary, the same workload: equal digests
    (bit-identical answers); another workload: another digest."""
    res, engine, v = served
    reqs = random_workload(np.random.default_rng(3), v, 50, ALL_KINDS)
    digests = []
    for eng in (engine, QueryEngine(dataclasses.replace(res), device=CPU)):
        server = QueryServer(eng, slots=16)
        _drain(server, reqs)
        digests.append(answers_digest(server.done))
    assert digests[0] == digests[1]
    server = QueryServer(engine, slots=16)
    _drain(server, random_workload(np.random.default_rng(4), v, 50, ALL_KINDS))
    assert answers_digest(server.done) != digests[0]


def reference_random_workload():
    """The reference's ``random_workload``, taken from its source (its module
    imports a JAX API this JAX lacks) and bound to the port's request type
    and kind constants."""
    path = pathlib.Path(Q.__file__).resolve().parents[1] / "launch" / "query_serve.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "random_workload")
    ns = dict(QueryRequest=QueryRequest, KIND_KHOP=KIND_KHOP, KIND_CUT=KIND_CUT,
              _SET_KINDS=SET_KINDS)
    exec(compile(ast.Module([fn], []), str(path), "exec"), ns)
    return ns["random_workload"]


@pytest.mark.parametrize("seed,kinds", [(5, ALL_KINDS), (6, [KIND_CUT, KIND_KHOP])])
def test_workload_is_the_reference_stream(seed, kinds):
    """One numpy seed draws the reference's request stream."""
    got = random_workload(np.random.default_rng(seed), 300, 40, kinds)
    want = reference_random_workload()(np.random.default_rng(seed), 300, 40, kinds)
    assert len(got) == len(want) == 40
    for a, b in zip(got, want):
        assert (a.rid, a.kind, a.u, a.v) == (b.rid, b.kind, b.u, b.v)
        for x, y in ((a.a, b.a), (a.b, b.b)):
            assert (x is None and y is None) or np.array_equal(x, y)


def test_driver_smoke(capsys):
    """main() with --device cpu serves all seven kinds and prints the
    reference's local-mode keys."""
    args = ["--dataset", "ego-facebook", "--scale", "0.05", "--T", "4", "--k-frac", "0.4",
            "--requests", "40", "--batch", "16", "--seed", "2", "--device", "cpu",
            "--queries", "degree,adjacency,pagerank,triangle,khop,cut,conductance"]
    rec = query_serve.main(args)
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(rec))
    for k in ("dataset", "V", "E", "num_supernodes", "num_superedges", "mode", "batch",
              "requests", "queries", "p50_latency_s", "p99_latency_s", "qps", "wall_s",
              "summarize_wall_s", "engine_build_wall_s", "answers_digest", "source"):
        assert k in rec, k
    assert rec["mode"] == "local" and rec["device"] == "cpu" and rec["source"] == "synthetic"
    assert rec["requests"] == 40 and sum(rec["queries"].values()) == 40
    assert set(rec["queries"]) == set(KIND_NAMES)
    assert rec["qps"] > 0 and 0 < rec["p50_latency_s"] <= rec["p99_latency_s"]
    assert rec["kernel_launches"] == {"merge_gain": 0, "pair_cost": 0, "group_tables": 0,
                                     "segment_sum": 0, "ordered_sum": 0}
    assert 1 <= rec["pagerank_iterations"] <= 50 and rec["triangle_wedges"] >= 0
    capsys.readouterr()
    again = query_serve.main(args)  # a second run: the same requests, the same bits
    assert again["answers_digest"] == rec["answers_digest"]


def test_driver_rejects_unknown_kind():
    with pytest.raises(SystemExit):
        query_serve.main(["--dataset", "ego-facebook", "--scale", "0.05", "--device", "cpu",
                          "--queries", "degree,bogus"])


def test_request_defaults():
    r = QueryRequest(rid=0, kind=KIND_DEGREE)
    assert r.u == 0 and r.v == 0 and r.answer is None and r.a is None
