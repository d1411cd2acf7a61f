"""The roofline's counts and rates on hand-counted operands, and the
benchmark's lookup of configurations, traffic mixes, limits and metric
readers by name."""

import json
import types

import pytest
import torch
from conftest import TINY_CELL

from bench import harness, roofline


def test_rates_are_the_data_sheets():
    r = roofline.H100_SXM
    assert r.hbm_bytes_per_s == 3.35e12 and r.fp32_flops == 67e12
    assert r.sfu_per_s == 132 * 16 * 1.98e9


def test_merge_gain_bytes_by_hand():
    # m 2·3·4, n s t cidx 2·3 each, n_u 2·4, w rel red 2·3·3 each: 24+24+8+54
    assert roofline.merge_gain_bytes(2, 3, 4) == (24 + 24 + 8 + 54) * 4


def test_merge_gain_work_by_hand():
    # one group, C = 3 members (the third a padding member), U = 4 columns
    m = torch.tensor([[[1., 0., 2., 0.], [0., 0., 3., 1.], [5., 5., 5., 5.]]])
    n = torch.tensor([[1., 2., 0.]])
    s = torch.tensor([[0., 1., 0.]])
    w = torch.tensor([[[0., 2., 0.], [2., 0., 0.], [0., 0., 0.]]])
    terms, pairs = roofline.merge_gain_work(torch, m, n, s, w)
    # cross: union of rows 0 and 1 has 3 nonzero columns; rows: 2 + 2 nonzeros
    # and one self count; the live pair's merged self count 0+1+2 and its w
    assert float(terms) == 3 + (4 + 1) + (1 + 1)
    assert float(pairs) == 2


def test_pair_cost_bytes_and_work():
    cnt = torch.tensor([0., 1., 3., 0., 2.])
    pi = torch.tensor([0., 4., 9., 1., 2.])
    assert roofline.pair_cost_bytes(cnt, pi, torch.zeros(5)) == 12 * 5
    assert float(roofline.pair_cost_work(cnt)) == 3


def test_bound_is_the_longest_term():
    r = roofline.H100_SXM
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    terms = r.sfu_per_s / roofline.SFU_PER_TERM
    assert roofline.bound_s(0, terms) == pytest.approx(1.0)


def test_share_needs_every_launch_in_the_trace():
    trace = types.SimpleNamespace(device_s={"merge_gain_kernel(float*)": 4e-3},
                                  launches={"merge_gain_kernel(float*)": 2})
    r = types.SimpleNamespace(trace=trace, bounds={"merge_gain": [5e-4, 5e-4]})
    assert roofline.share(r, "merge_gain", "merge_gain_kernel") == pytest.approx(25.0)
    r.bounds["merge_gain"].append(5e-4)
    assert roofline.share(r, "merge_gain", "merge_gain_kernel") is None
    assert roofline.share(r, "pair_cost", "_pair_cost_kernel") is None


def test_new_files_are_found_by_name(tiny_root):
    """A configuration, a traffic mix, limits and a metric reader dropped
    into their folders are found by the names BENCHMARK.json gives."""
    bench = tiny_root / "bench"
    conf = json.loads((bench / "configs" / "tiny.json").read_text())
    (bench / "configs" / "other.json").write_text(json.dumps(dict(conf, num_edges=4000)))
    mix = json.loads((bench / "traffic" / "tiny.json").read_text())
    mix["summary"]["k_frac"] = 0.1
    (bench / "traffic" / "k10.json").write_text(json.dumps(mix))
    (bench / "limits" / "other.k10.json").write_text(
        (bench / "limits" / f"{TINY_CELL}.json").read_text())
    (bench / "metrics" / "runs_done.py").write_text(
        "def read(r):\n    return float(len(r.runs))\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "other.k10", "config": "other", "traffic": "k10",
                              "chips": 1, "why": "a cell added as files"})
    spec["per_layer"].append({"name": "runs_done", "unit": "runs", "better": "higher",
                              "source": "program_counter", "layer": "Engine",
                              "moves": "summarize_s", "workloads": ["other.k10"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell(tiny_root, "other.k10")
    assert cell.config["num_edges"] == 4000
    assert cell.traffic["summary"]["k_frac"] == 0.1
    assert [m["name"] for m in cell.per_layer] == ["runs_done"]
    readings = harness.Readings(runs=[{}, {}], window_s=1.0, trace=None, bounds={})
    assert harness.reader(tiny_root, "runs_done")(readings) == 2.0
    assert "runs_done" not in [m["name"] for m in harness.load_cell(tiny_root, TINY_CELL).per_layer]


def test_trace_leaves_out_the_harness_device_work():
    """Device activities launched under a ``bench.capture`` span are not the
    program's: they leave the busy time and the device times."""
    from types import SimpleNamespace as NS

    from bench import trace

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def host(name, id_, a, b, children=()):
        e = NS(name=name, id=id_, device_type=cpu, time_range=NS(start=a, end=b),
               cpu_children=list(children), cpu_parent=None)
        for c in children:
            c.cpu_parent = e
        return e

    def dev(name, id_, a, b, **linked):
        return NS(name=name, id=id_, device_type=cuda, time_range=NS(start=a, end=b),
                  is_user_annotation=False, **linked)

    # the harness's copy links to its operation (id 7) or to its runtime
    # call (correlation id 101), as the profiler's version gives
    launch = host("cudaMemcpyAsync", 101, 52, 55)
    copy = host("aten::copy_", 7, 50, 60, [launch])
    for id_, linked in ((999, {"linked_correlation_id": 7}), (101, {})):
        events = [host("aten::mm", 3, 0, 10), host("bench.capture", 6, 45, 70, [copy]),
                  copy, launch, dev("gemm", 100, 10, 30),
                  dev("Memcpy DtoH", id_, 60, 80, **linked), dev("gemm", 102, 90, 100)]
        s = trace.summarize_events(events)
        assert s.busy_s == pytest.approx(30e-6)
        assert s.harness_s == pytest.approx(20e-6)
        assert s.device_s == {"gemm": pytest.approx(30e-6)} and s.launches == {"gemm": 2}


def test_counted_warm_up_stands_for_the_window(tiny_root):
    """A run that counts each launch's work launches what an uncounted run of
    the same seed does, and gets one bound a launch."""
    cell = harness.load_cell(tiny_root, TINY_CELL)
    job = harness.Job.make(cell, 11, "cpu")
    from repro_torch.core.summarize import summarize

    seams = job.seams()
    with seams.installed():
        seams.begin_run(count_work=True)
        summarize(job.src, job.dst, job.num_nodes, job.cfg, device="cpu")
        counted = dict(seams.launches)
        bounds = seams.work_bounds()
        seams.begin_run()
        summarize(job.src, job.dst, job.num_nodes, job.cfg, device="cpu")
    assert seams.launches == counted and counted["merge_gain"] == 5
    assert {k: len(b) for k, b in bounds.items()} == counted
    assert all(b > 0.0 for bs in bounds.values() for b in bs) and not seams.work
