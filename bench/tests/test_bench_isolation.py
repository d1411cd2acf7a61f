"""Nothing a cell's run loads is of JAX or of the JAX package, and the
reference loads nothing of the program. Each check runs in a fresh
subprocess, since this test process may hold other modules."""

import json
import subprocess
import sys
import textwrap

from conftest import ROOT, TINY_CELL

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_level_modules(code: str) -> set[str]:
    prog = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / "src")!r}]
        {textwrap.indent(textwrap.dedent(code), "        ").strip()}
        print(json.dumps(sorted({{m.split(".")[0] for m in list(sys.modules)}})))
    """)
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cells_run_loads_no_jax(tmp_path):
    from conftest import make_tiny_root

    root = make_tiny_root(tmp_path)
    loaded = _top_level_modules(f"""
        import pathlib, time, torch
        torch.set_num_threads(1)
        from bench import harness, readings, run
        for m in ("round_ms", "rounds_per_run", "outside_rounds_ms", "merge_gain_roofline",
                  "pair_cost_roofline", "device_idle_pct"):
            harness.reader(pathlib.Path({str(root)!r}), m)
        for trace in (False, True):
            r = harness.run_cell(pathlib.Path({str(root)!r}), {TINY_CELL!r}, 3, 0.01, trace,
                                 t_start=time.perf_counter(), device="cpu",
                                 log=lambda msg: None)
            assert r["correct"], r["checks"]
    """)
    assert "repro_torch" in loaded and "bench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level_modules("""
        from bench.reference import check, control, kernels, summary
    """)
    assert "bench" in loaded
    assert not loaded & (FORBIDDEN | {"repro_torch"}), loaded & (FORBIDDEN | {"repro_torch"})
