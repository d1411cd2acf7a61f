"""The program spans' totals (``bench/spans.py``) on hand-made profiler
events: device time, syncs and idle gaps reach the spans that were open,
the harness's copies and the spans' device-side images count for none, and
a trace with no ``ssumm.*`` span gives no totals."""

from types import SimpleNamespace as NS

import pytest
import torch

from bench import spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def host(name, id_, a, b, children=()):
    e = NS(name=name, id=id_, device_type=CPU, time_range=NS(start=a, end=b),
           cpu_children=list(children), cpu_parent=None)
    for c in children:
        c.cpu_parent = e
    return e


def dev(name, id_, a, b, linked=0, annotation=False):
    return NS(name=name, id=id_, device_type=CUDA, time_range=NS(start=a, end=b),
              is_user_annotation=annotation, linked_correlation_id=linked)


def flatten(roots):
    out, stack = [], list(roots)
    while stack:
        e = stack.pop()
        out.append(e)
        stack.extend(e.cpu_children)
    return out


def run_events(harness=False):
    """One run: a round (pair table, read-back) and the finalize, µs.

    Device: the sort's kernel [20, 40] by its runtime call (id 101), a second
    kernel [40, 45] linked to the sort (op id 7), the read-back's copy
    [70, 72], the finalize's kernel [120, 140]; with ``harness`` a copy
    [80, 95] launched inside ``bench.capture``."""
    sort = host("aten::sort", 7, 12, 30, [host("cudaLaunchKernel", 101, 14, 16)])
    copy = host("aten::copy_", 8, 62, 88, [host("cudaMemcpyAsync", 102, 63, 65),
                                          host("cudaStreamSynchronize", 103, 65, 87)])
    rnd = [host("ssumm.pair_table", 11, 10, 50, [sort]),
           host("ssumm.readback", 12, 60, 90, [copy])]
    if harness:
        grab = host("aten::_to_copy", 9, 76, 79, [host("cudaMemcpyAsync", 105, 77, 78),
                                                 host("cudaStreamSynchronize", 106, 78, 79)])
        rnd.append(host("bench.capture", 13, 75, 80, [grab]))
    fin = host("ssumm.finalize", 14, 110, 150,
               [host("aten::mul", 10, 112, 118, [host("cudaLaunchKernel", 104, 113, 115)])])
    run = host("ssumm.run", 15, 0, 200, [host("ssumm.round", 16, 10, 100, rnd), fin])
    device = [dev("sort_kernel", 101, 20, 40), dev("sort_tail", 999, 40, 45, linked=7),
              dev("Memcpy DtoH", 102, 70, 72), dev("mul_kernel", 104, 120, 140)]
    if harness:
        device.append(dev("Memcpy DtoH", 105, 80, 95))
    return flatten([run]) + device


@pytest.mark.parametrize("harness", [False, True])
def test_device_time_syncs_and_idle_reach_the_open_spans(harness):
    t = spans.program_spans(run_events(harness))
    dev_us = {k: round(v.device_s * 1e6, 6) for k, v in t.items()}
    # 20 by the call's correlation id + 5 by the linked operation, 2 the copy
    assert dev_us == {"ssumm.run": 47, "ssumm.round": 27, "ssumm.pair_table": 25,
                      "ssumm.readback": 2, "ssumm.finalize": 20}
    assert {k: v.syncs for k, v in t.items()} == {
        "ssumm.run": 1, "ssumm.round": 1, "ssumm.pair_table": 0, "ssumm.readback": 1,
        "ssumm.finalize": 0}
    assert t["ssumm.readback"].calls == {"cudaMemcpyAsync": 1, "cudaStreamSynchronize": 1}
    # gaps (45, 70) and (72, 120) fall in the round and the run; the copy
    # the harness launched is no busy time
    idle_us = {k: round(v.idle_s * 1e6, 6) for k, v in t.items()}
    assert idle_us == {"ssumm.run": 73, "ssumm.round": 73, "ssumm.pair_table": 0,
                       "ssumm.readback": 0, "ssumm.finalize": 0}
    assert {k: v.count for k, v in t.items()} == dict.fromkeys(t, 1)
    assert t["ssumm.run"].host_s == pytest.approx(200e-6)


@pytest.mark.parametrize("flagged", [True, False])
def test_device_images_of_spans_are_no_work(flagged):
    events = run_events()
    images = [dev("ssumm.run", 0, 20, 140, annotation=flagged),
              dev("ssumm.round", 0, 20, 72, annotation=flagged)]
    with_images = spans.program_spans(events + images)
    assert with_images == spans.program_spans(events)
    if flagged:  # as the profiler marks a span's device-side image
        a, b = trace.summarize_events(events), trace.summarize_events(events + images)
        assert (a.busy_s, a.device_s, a.launches) == (b.busy_s, b.device_s, b.launches)


def test_no_program_span_gives_no_totals():
    sort = host("aten::sort", 7, 12, 30, [host("cudaLaunchKernel", 101, 14, 16)])
    events = flatten([sort]) + [dev("sort_kernel", 101, 20, 40), dev("k", 102, 50, 60)]
    assert spans.program_spans(events) == {}
    assert spans.program_spans([]) == {}


def test_a_profiled_cpu_run_gives_each_span_its_count(tiny_root):
    """On the profiler's own events: one run, one round span a history row,
    no device time on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    from bench import harness
    from repro_torch.core.summarize import summarize

    job = harness.Job.make(harness.load_cell(tiny_root, "tiny.summarize"), 5, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = summarize(job.src, job.dst, job.num_nodes, job.cfg, device="cpu")
    t = spans.program_spans(prof.events())
    rounds = len(res.history)
    assert t["ssumm.run"].count == 1 and t["ssumm.round"].count == rounds
    assert t["ssumm.gain_and_merge"].count == rounds and t["ssumm.finalize"].count == 1
    assert t["ssumm.run"].host_s >= t["ssumm.round"].host_s > 0.0
    assert all(v.device_s == 0.0 and v.idle_s == 0.0 for v in t.values())
