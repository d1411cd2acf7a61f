"""One run of one cell: set-up, the timed window, the check, the result line.

Everything a cell is made of is found by name under the benchmark's folder:
``BENCHMARK.json`` names the cell's configuration and traffic mix, which are
``configs/<config>.json`` and ``traffic/<traffic>.json``; the limits of its
comparison are ``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``'s ``read(readings)``. Adding any of them is adding a
file.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = 2.0 ** 30
#: a traced run's profiler records the window's runs up to the first that
#: ends this long after the window opened: reading a longer trace would
#: take the run past its time limit
TRACE_S = 12.0


def cache_dirs(root: pathlib.Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a checkout's first run builds: the CUDA library goes to
    ``build/repro_torch/`` (the program's own choice), Triton's cache and the
    CUDA JIT cache under ``build/bench/``. Call before ``triton`` or
    CUDA loads."""
    import os

    cache = root / "build" / "bench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class NoChip(RuntimeError):
    """The machine lacks the cards the cell asks for."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: pathlib.Path, workload: str) -> Cell:
    """The cell named ``workload`` in ``root/BENCHMARK.json``, with its files."""
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    bench = root / "bench"

    def applies(metric: dict) -> bool:
        return workload in metric.get("workloads", [workload])

    return Cell(name=workload, chips=int(w["chips"]),
                config=_json(bench / "configs" / f"{w['config']}.json"),
                traffic=_json(bench / "traffic" / f"{w['traffic']}.json"),
                limits=_json(bench / "limits" / f"{workload}.json"),
                end_to_end=[m for m in spec["end_to_end"] if applies(m)],
                per_layer=[m for m in spec["per_layer"] if applies(m)])


def reader(root: pathlib.Path, metric: str):
    """``read`` of ``bench/metrics/<metric>.py``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read: each complete run's wall and round
    walls (host clock), the traced part of the window (its length and the
    trace's summary), and each traced kernel launch's bound (seconds, in
    launch order)."""

    runs: list[dict]
    window_s: float
    trace: object | None
    bounds: dict[str, list[float]]


@dataclasses.dataclass
class Job:
    """A cell's summarization job for one seed: the edge list made on the
    device and copied to the host as the user's int64 arrays, the config,
    the budget the reference holds it to, and the graph's degree figures."""

    src: object
    dst: object
    num_nodes: int
    cfg: object
    k_bits: float
    graph: dict
    seed: int
    device: object

    @classmethod
    def make(cls, cell: Cell, seed: int, device) -> "Job":
        import torch

        from bench import graphs
        from repro_torch.core.types import SummaryConfig

        src_d, dst_d, v = graphs.generate(cell.config, seed, device)
        figures = graphs.degree_figures(src_d, dst_d, v)
        src, dst = src_d.cpu().numpy(), dst_d.cpu().numpy()
        del src_d, dst_d
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        fields = dict(cell.config["summary"], **cell.traffic["summary"])
        # k as a share of Size(G) = 2|E|log₂|V|, Eq. (3)
        k_bits = float(fields["k_frac"]) * 2.0 * src.shape[0] * math.log2(v)
        return cls(src=src, dst=dst, num_nodes=v, cfg=SummaryConfig(seed=seed, **fields),
                   k_bits=k_bits, graph=figures, seed=seed, device=device)

    def seams(self, span=None):
        from bench.capture import Seams

        return Seams(seed=self.seed, device=self.device, span=span)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def run_cell(root: pathlib.Path, workload: str, seed: int, seconds: float, trace: bool,
             *, t_start: float, device: str = "cuda", log=None, break_program=None) -> dict:
    """Run one cell; returns the result's dict (``checks`` last).

    ``device="cpu"`` and ``break_program`` are for the benchmark's own tests:
    the CPU skips the look for a card, and ``break_program()`` may plant a
    fault in the program's modules before set-up.
    """
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = load_cell(root, workload)
    import torch

    from bench.reference import check

    on_card = device == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise NoChip("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell.chips:
            raise NoChip(f"{torch.cuda.device_count()} card(s), the cell asks for {cell.chips}")
    dev = torch.device(device)
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    from repro_torch.core.summarize import summarize
    from repro_torch.kernels import build

    if break_program is not None:
        break_program()
    phases = {"imports_s": time.perf_counter() - t_start}
    if on_card:
        build.build_all()
    phases["kernels_s"] = time.perf_counter() - t_start

    job = Job.make(cell, seed, dev)
    phases["graph_s"] = time.perf_counter() - t_start
    src, dst, v, k_bits = job.src, job.dst, job.num_nodes, job.k_bits
    e = int(src.shape[0])

    span = None
    if trace:
        from torch.profiler import record_function as span
    seams = job.seams(span=span)

    def one_run(capture_round=0, count_work=False):
        seams.begin_run(capture_round, count_work=count_work)
        return summarize(src, dst, v, job.cfg, device=dev)

    prof = None
    with seams.installed():
        # warm-up: every kernel built and every shape seen, the capture's
        # too (its first round, discarded: the pinned host buffers stay
        # cached). A run of one seed repeats it bit for bit, so in a traced
        # run it also counts each launch's work for the window's launches,
        # before the profiler starts
        warm = one_run(1, count_work=trace)
        seams.take()
        warm_launches = dict(seams.launches)
        work = seams.work_bounds() if trace else {}
        capture_round = check.capture_round(seed, len(warm.history))
        warm_digest = check.Summary.of(warm).digest()
        del warm
        sync()
        setup_s = time.perf_counter() - t_start
        phases = {k: round(x, 3) for k, x in phases.items()}
        log(f"set-up {setup_s:.3f} s (ended by then: {phases}): V={v} E={e}, "
            f"k={k_bits:.1f} bits, graph {job.graph}, captured round {capture_round}")

        if on_card:
            torch.cuda.reset_peak_memory_stats()
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)
            prof.start()
        runs, outs, launches, errors = [], [], [], []
        cap = None
        traced, traced_s = 0, 0.0
        attempted = failed = 0
        t0 = time.perf_counter()
        t_end = t0
        while True:
            attempted += 1
            t_run = time.perf_counter()
            try:
                # the window's first run captures the drawn round
                res = one_run(capture_round if attempted == 1 else 0)
            except Exception as exc:  # a run that raises is a failed run
                failed += 1
                errors.append(f"{type(exc).__name__}: {exc}")
                break
            t_end = time.perf_counter()
            runs.append({"wall_s": t_end - t_run,
                         "round_s": [row["round_s"] for row in res.history],
                         "re1": res.re1, "size_bits": res.size_bits})
            outs.append(check.Summary.of(res))
            launches.append(dict(seams.launches))
            if attempted == 1:
                cap = seams.take()
            if res.size_bits > k_bits * (1.0 + check.BUDGET_SLACK):
                failed += 1
            if prof is not None and not traced and t_end - t0 >= min(TRACE_S, seconds):
                sync()
                prof.stop()
                traced, traced_s = len(runs), t_end - t0
            if t_end - t0 >= seconds:
                break
        window_s = t_end - t0
        if prof is not None and not traced:
            sync()
            prof.stop()
            traced, traced_s = len(runs), window_s
        peak = torch.cuda.max_memory_allocated() if on_card else 0

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of a forbidden package are loaded: {found}")
    del seams
    # the counted launches stand for the window's only where every run
    # repeated the warm-up: the same launches and the same summary
    repeated = (all(n == warm_launches for n in launches)
                and all(o.digest() == warm_digest for o in outs))
    bounds = {k: b * traced for k, b in work.items()} if repeated else {}
    if trace and not repeated:
        log("the window's runs did not repeat the warm-up: no roofline share")
    if on_card:
        torch.cuda.empty_cache()
    for msg in errors:
        log(f"run failed: {msg}")
    log(f"window {window_s:.4f} s, {len(runs)} runs: walls "
        f"{[round(r['wall_s'], 4) for r in runs]}, rounds {[len(r['round_s']) for r in runs]}")
    if runs:
        slow = max(runs, key=lambda r: r["wall_s"])
        log(f"slowest run: outside the rounds {slow['wall_s'] - sum(slow['round_s']):.4f} s, "
            f"rounds {[round(x, 4) for x in slow['round_s']]}")

    result: dict = {"correct": False, "attempted": attempted, "failed": failed}
    done = len(runs)

    # the comparison, once the window has closed and the program's state is freed
    t_check = time.perf_counter()
    nums, re1 = check.judge(torch.from_numpy(src), torch.from_numpy(dst), v, k_bits,
                            job.cfg.max_neighbors, outs, [cap] if cap is not None else [])
    if cap is None:
        nums["round_faults"] += 1  # no round was captured: nothing judged
    checks = {k: {"value": nums[k], "limit": cell.limits[k]} for k in check.NUMBERS}
    ok = done > 0 and failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result["correct"] = bool(ok)
    log(f"check took {time.perf_counter() - t_check:.2f} s over {done} runs "
        f"(round {capture_round} of the first captured: {cap is not None})")

    if trace:
        from bench import trace as trace_mod

        t_read = time.perf_counter()
        summary = trace_mod.summarize_events(prof.events())
        del prof
        log(f"trace read in {time.perf_counter() - t_read:.2f} s: busy {summary.busy_s:.4f} s "
            f"of the first {traced} runs' {traced_s:.4f} s; the capture's own device work "
            f"{summary.harness_s:.6f} s, left out of busy ({summary.harness_note})")
        readings = Readings(runs=runs, window_s=traced_s, trace=summary, bounds=bounds)
        metrics = {}
        for m in cell.per_layer:
            value = reader(root, m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        # RE₁ as the reference works it out from each returned summary
        values = {"summarize_s": window_s / done if done else None,
                  "re1": sum(re1) / len(re1) if re1 else None,
                  "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end if values.get(m["name"]) is not None}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips if on_card else 0, "memory_peak_bytes": peak}
    if trace:
        device_info.update(busy_s=summary.busy_s, window_s=traced_s)
        result["breakdown"] = {"device_ops": trace_mod.top(summary.device_s),
                               "idle_gaps": trace_mod.top(summary.idle_by_host)}
    result["device"] = device_info
    for k, c in checks.items():
        log(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    result["checks"] = checks
    return result
