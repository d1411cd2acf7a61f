"""The port's profiler spans (``repro_torch.utils.spans``) on the CPU.

With no profiler a run enters no ``record_function`` at all; under
``torch.profiler`` every span opens as often as its stage runs, nested
run → round → stage; and the summary is the same bits either way.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import summarize
from repro_torch.core.engine import EngineCheckpointer
from repro_torch.core.types import SummaryConfig
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.utils import spans

V, E = 512, 3000
CFG = SummaryConfig(T=4, k_frac=0.3, seed=3)
ROUND_STAGES = ("ssumm.pair_table", "ssumm.metrics", "ssumm.groups",
                "ssumm.neighbor_tables", "ssumm.total_costs", "ssumm.assemble_tables",
                "ssumm.gain_and_merge", "ssumm.readback")
# span → the span it must lie in
PARENT = {"ssumm.make_graph": "ssumm.run", "ssumm.canonical_check": "ssumm.make_graph",
          "ssumm.to_device": "ssumm.make_graph", "ssumm.round": "ssumm.run",
          "ssumm.finalize": "ssumm.run", "ssumm.to_host": "ssumm.run",
          "ssumm.checkpoint": "ssumm.run", **{s: "ssumm.round" for s in ROUND_STAGES}}


def edges(seed: int = 0):
    """A random multigraph edge list, not canonical: both directions, loops
    and repeats, so ``make_graph`` canonicalises it."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, V, E), rng.integers(0, V, E)


def run(**kw):
    src, dst = edges()
    return summarize(src, dst, V, CFG, device="cpu", **kw)


def profiled(**kw):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = run(**kw)
    return res, [e for e in prof.events() if e.name.startswith("ssumm.")]


def ancestors(e) -> list[str]:
    out = []
    while e.cpu_parent is not None:
        e = e.cpu_parent
        out.append(e.name)
    return out


def test_span_is_the_shared_null_context_without_a_profiler():
    assert spans.span("ssumm.a") is spans.span("ssumm.b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(spans.span("ssumm.a"), torch.profiler.record_function)


def test_no_profiler_enters_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    res = run()
    assert res.iterations_run >= 1


def test_spans_open_once_a_stage_nested_run_round_stage():
    res, events = profiled()
    rounds = len(res.history)
    assert rounds >= 2
    counts = {}
    for e in events:
        counts[e.name] = counts.get(e.name, 0) + 1
    want = {"ssumm.run": 1, "ssumm.make_graph": 1, "ssumm.canonical_check": 1,
            "ssumm.to_device": 1, "ssumm.finalize": 1, "ssumm.to_host": 1,
            "ssumm.round": rounds, **{s: rounds for s in ROUND_STAGES}}
    assert counts == want
    for e in events:
        up = ancestors(e)
        if e.name == "ssumm.run":
            assert not [a for a in up if a.startswith("ssumm.")]
        else:
            assert PARENT[e.name] in up, (e.name, up)
            assert "ssumm.run" in up


def test_checkpoint_span_opens_once_a_save(tmp_path):
    ck = EngineCheckpointer(CheckpointManager(str(tmp_path), keep=2), every=1)
    res, events = profiled(checkpointer=ck)
    saves = [e for e in events if e.name == "ssumm.checkpoint"]
    assert res.checkpoint_saves >= 2 and len(saves) == res.checkpoint_saves
    assert all(PARENT["ssumm.checkpoint"] in ancestors(e) for e in saves)


@pytest.fixture(scope="module")
def off_and_on():
    return run(), profiled()[0]


@pytest.mark.parametrize("field", ["node2super", "super_size", "edge_lo", "edge_hi",
                                   "edge_w", "size_bits", "re1", "re2", "mdl_cost",
                                   "iterations_run"])
def test_summary_is_the_same_with_spans_on_and_off(off_and_on, field):
    off, on = off_and_on
    np.testing.assert_array_equal(getattr(on, field), getattr(off, field))
