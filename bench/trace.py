"""Reading a ``torch.profiler`` trace of the window: the device's busy time,
each kernel's device time and launches, and what the host was doing in the
longest gaps in which nothing ran on the device.

Device work that the harness itself launched, inside a ``bench.capture``
span (the copies of the captured round), is not the program's: it is left
out of the busy time and the device times, and reported apart."""

from __future__ import annotations

import bisect
import dataclasses


@dataclasses.dataclass
class TraceSummary:
    busy_s: float  # union of every device activity (kernels, copies, sets)
    span_s: float  # first device activity's start to the last one's end
    device_s: dict[str, float]  # device seconds by activity name
    launches: dict[str, int]  # device activities by name
    idle_by_host: dict[str, float]  # gap seconds by what the host was doing
    harness_s: float = 0.0  # device seconds launched inside the harness's spans
    harness_note: str = ""


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_path(top: list, starts: list[float], t: float) -> list[str]:
    """Names of the nested host events running at time ``t``, outermost first."""
    path: list[str] = []
    level, level_starts = top, starts
    while level:
        i = bisect.bisect_right(level_starts, t) - 1
        if i < 0:
            break
        evt = level[i]
        if evt.time_range.end < t:
            break
        path.append(evt.name)
        level = sorted(evt.cpu_children, key=lambda e: e.time_range.start)
        level_starts = [e.time_range.start for e in level]
    return path


def _gap_name(path: list[str]) -> str:
    spans = [p for p in path if p.startswith("bench.")]
    ops = [p for p in path if not p.startswith("bench.")]
    where = spans[-1] if spans else "outside the runs' rounds"
    what = ops[-1] if ops else "Python"
    return f"{where}: {what}"


def _under(host: list, span: str) -> list:
    """The host events inside every span named ``span``, the spans too."""
    out = []
    stack = [e for e in host if e.name == span]
    while stack:
        e = stack.pop()
        out.append(e)
        stack.extend(e.cpu_children)
    return out


def summarize_events(events, longest_gaps: int = 400,
                     harness_span: str = "bench.capture") -> TraceSummary:
    """Reduce ``prof.events()`` (times in microseconds)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        if e.device_type != cuda:
            host.append(e)
        elif not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
            dev.append(e)  # a host span's image on the device's timeline is no work
    # A device activity shares its correlation id with the runtime call that
    # launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...), which
    # nests in the host operation; newer profilers also link it to the
    # operation itself
    inside = _under(host, harness_span)
    calls = {e.id for e in inside if e.name.startswith("cu")}
    ops = {e.id for e in inside if not e.name.startswith("cu")} - {0}

    def harness(e) -> bool:
        return e.id in calls or getattr(e, "linked_correlation_id", 0) in ops

    ours = [e for e in dev if harness(e)]
    harness_s = sum(e.time_range.end - e.time_range.start for e in ours) * 1e-6
    dev = [e for e in dev if not harness(e)]
    note = (f"{len(ours)} activities of {len(inside)} host events, "
            f"{len(calls)} runtime calls, in the spans")
    device_s: dict[str, float] = {}
    launches: dict[str, int] = {}
    spans = []
    for e in dev:
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        device_s[e.name] = device_s.get(e.name, 0.0) + (b - a) * 1e-6
        launches[e.name] = launches.get(e.name, 0) + 1
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    span_s = (busy[-1][1] - busy[0][0]) * 1e-6 if busy else 0.0

    top = sorted((e for e in host if e.cpu_parent is None), key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in top]
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:longest_gaps]
    idle: dict[str, float] = {}
    for length, a, b in gaps:
        name = _gap_name(_host_path(top, starts, (a + b) / 2))
        idle[name] = idle.get(name, 0.0) + length * 1e-6
    return TraceSummary(busy_s=busy_s, span_s=span_s, device_s=device_s,
                        launches=launches, idle_by_host=idle, harness_s=harness_s,
                        harness_note=note)


def top(d: dict[str, float], n: int = 10, width: int = 160) -> list[list]:
    """The ``n`` largest entries as ``[name, seconds]``, names cut to ``width``."""
    return [[k[:width], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
