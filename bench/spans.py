"""The program's own spans in a ``torch.profiler`` trace of the window.

The port opens a ``ssumm.*`` span (``repro_torch/utils/spans.py``) around
each stage of a run while a profiler records. :func:`program_spans` reduces
``prof.events()`` to one :class:`SpanTotals` a span name:

* ``count`` and ``host_s``: the spans opened and the sum of their host
  durations;
* ``device_s``: the device activities (kernels, copies, sets) launched
  inside the span, counted inclusively: an activity counts for its
  innermost span and every span around it. It is tied to its span by the
  correlation id of the runtime call that launched it, or by its
  ``linked_correlation_id`` to the host operation, as
  :func:`bench.trace.summarize_events` ties the harness's copies to
  ``bench.capture``;
* ``syncs`` and ``calls``: the blocking runtime calls (:data:`SYNC_CALLS`)
  made inside the span, and every runtime call by name;
* ``idle_s``: the gaps between the device's busy intervals whose midpoint
  falls while the span is open.

What the harness launched inside ``bench.capture`` counts for no span, and
the device-side images of ``ssumm.*`` and ``bench.*`` spans are not device
work, as in :mod:`bench.trace`. The benchmark's result line does not carry
these totals yet: a traced run prints them with this file's command,

    python3 bench/spans.py --workload skitter.summarize --seed 7 --seconds 51 \\
        --out chiprun_out/spans.json

which runs the cell as ``bench/run.py --trace 1`` does and reads the same
events again for the spans.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import pathlib
import sys

PROGRAM = "ssumm."
#: runtime calls that block the host until the device has caught up
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})


@dataclasses.dataclass
class SpanTotals:
    count: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    syncs: int = 0
    idle_s: float = 0.0
    calls: dict[str, int] = dataclasses.field(default_factory=dict)


def _device_work(e, cuda) -> bool:
    return e.device_type == cuda and not (
        getattr(e, "is_user_annotation", False) or e.name.startswith(("bench.", PROGRAM)))


def program_spans(events, harness_span: str = "bench.capture") -> dict[str, SpanTotals]:
    """Each ``ssumm.*`` span's totals in ``prof.events()`` (times in µs)."""
    import torch

    from bench.trace import _union

    cuda = torch.autograd.DeviceType.CUDA
    events = list(events)
    totals: dict[str, SpanTotals] = {}
    by_call: dict[int, tuple[str, ...]] = {}  # runtime call's correlation id → spans
    by_op: dict[int, tuple[str, ...]] = {}  # host operation's id → spans
    harness_calls, harness_ops = set(), set()
    opened: list[tuple[float, float, str]] = []
    stack = [(e, (), False) for e in events if e.device_type != cuda and e.cpu_parent is None]
    while stack:
        e, names, harness = stack.pop()
        a, b = e.time_range.start, e.time_range.end
        harness = harness or e.name == harness_span
        call = e.name.startswith("cu")
        if harness:
            if e.id:
                (harness_calls if call else harness_ops).add(e.id)
        elif e.name.startswith(PROGRAM):
            t = totals.setdefault(e.name, SpanTotals())
            t.count += 1
            t.host_s += (b - a) * 1e-6
            opened.append((a, b, e.name))
            if e.name not in names:
                names = names + (e.name,)
        elif names and call and e.id:
            by_call[e.id] = names
            for n in names:
                t = totals[n]
                t.calls[e.name] = t.calls.get(e.name, 0) + 1
                t.syncs += e.name in SYNC_CALLS
        elif names and e.id:
            by_op[e.id] = names
        stack.extend((c, names, harness) for c in e.cpu_children)

    busy = []
    for e in events:
        if not _device_work(e, cuda):
            continue
        linked = getattr(e, "linked_correlation_id", 0)
        if e.id in harness_calls or linked in harness_ops:
            continue
        a, b = e.time_range.start, e.time_range.end
        busy.append((a, b))
        for n in by_call.get(e.id) or by_op.get(linked, ()):
            totals[n].device_s += (b - a) * 1e-6

    # each gap goes to the spans open at its midpoint; spans nest, so the
    # open ones are a stack swept in time order
    busy = _union(busy)
    gaps = sorted(((end + start) / 2, start - end)
                  for (_, end), (start, _) in zip(busy, busy[1:]))
    opened.sort()
    starts = [s for s, _, _ in opened]
    open_now: list[tuple[float, float, str]] = []
    i = 0
    for t, length in gaps:
        j = bisect.bisect_right(starts, t)
        open_now.extend(opened[i:j])
        i = j
        open_now = [s for s in open_now if s[1] >= t]
        for n in {name for _, _, name in open_now}:
            totals[n].idle_s += length * 1e-6
    return totals


def main(argv=None) -> int:
    import argparse
    import time

    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", help="also write the result and the spans as JSON here")
    args = ap.parse_args(argv)

    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    from bench import harness, trace

    harness.cache_dirs(root)
    read = {}
    summarize_events = trace.summarize_events

    def both(events, *a, **k):
        read["spans"] = program_spans(events)
        summary = summarize_events(events, *a, **k)
        read["idle_by_host"] = summary.idle_by_host
        return summary

    trace.summarize_events = both
    try:
        result = harness.run_cell(root, args.workload, args.seed, args.seconds, True,
                                  t_start=t_start)
    except harness.NoChip as exc:
        print(f"bench: no result: {exc}", file=sys.stderr)
        return 3
    finally:
        trace.summarize_events = summarize_events
    out = {"workload": args.workload, "seed": args.seed, "result": result,
           "idle_by_host": read["idle_by_host"],
           "spans": {k: dataclasses.asdict(v) for k, v in sorted(read["spans"].items())}}
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
