"""``examples/torch_quickstart.py`` against the reference's quickstart.

The reference (``repro.core.summarize`` and ``repro.core.queries`` on the
quickstart's graph and config) runs once in a subprocess
(``tests/torch_examples_check.py quickstart``), which also records its
per-round ``(h, tie)`` draws; the port's example runs in this process on
the CPU with those draws replayed. Counts are exact; ``size_bits``, RE₁,
RE₂, the degree estimates and the PageRank values agree within
``rtol=1e-5``, and the five highest-degree and top-PageRank nodes are the
same nodes.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.convert import ReplayPermutations

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5

torch.set_num_threads(1)


def load_example(name: str):
    """A file of ``examples/`` as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("quickstart_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "torch_examples_check.py"),
                           "quickstart", str(out)],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    return dict(np.load(out))


@pytest.fixture(scope="module")
def port(ref):
    """The port's example on the CPU with the reference's draws: its record
    and what it printed."""
    example = load_example("torch_quickstart")
    perms = ReplayPermutations(list(zip(ref["h"], ref["tie"])))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = example.main(["--device", "cpu"], perms=perms)
    return out, buf.getvalue()


def test_the_summary_counts_equal_the_reference(ref, port):
    out, _ = port
    assert out["device"] == "cpu"
    assert (out["V"], out["E"]) == (int(ref["v"]), int(ref["e"]))
    assert out["num_supernodes"] == int(ref["num_supernodes"])
    assert out["num_superedges"] == int(ref["num_superedges"])
    assert out["iterations"] == int(ref["iterations"])


@pytest.mark.parametrize("key", ["size_bits", "re1", "re2"])
def test_the_summary_metrics_agree_with_the_reference(ref, port, key):
    np.testing.assert_allclose(port[0][key], float(ref[key]), rtol=RTOL)


def test_the_relative_size_is_within_the_budget(ref, port):
    out, _ = port
    np.testing.assert_allclose(out["relative_size"],
                               float(ref["size_bits"] / ref["input_size_bits"]), rtol=RTOL)
    assert out["relative_size"] <= 0.3


def test_the_degree_estimates_equal_the_reference(ref, port):
    degrees = np.asarray(port[0]["degrees"], np.float64)
    np.testing.assert_array_equal(degrees[:, 0], ref["deg_nodes"])
    np.testing.assert_array_equal(degrees[:, 1], ref["deg_true"])
    np.testing.assert_allclose(degrees[:, 2], ref["deg_est"], rtol=RTOL)


def test_the_top_pagerank_nodes_equal_the_reference(ref, port):
    top = np.asarray(port[0]["pagerank_top"], np.float64)
    want = np.argsort(-ref["pagerank"])[:5]
    np.testing.assert_array_equal(top[:, 0], want)
    np.testing.assert_allclose(top[:, 1], ref["pagerank"][want], rtol=RTOL)


def test_it_prints_the_reference_lines_then_one_json_line(ref, port):
    out, text = port
    lines = text.splitlines()
    assert lines[0] == f"input graph: |V|={int(ref['v'])} |E|={int(ref['e'])}"
    assert lines[1] == f"summary: |S|={out['num_supernodes']} |P|={out['num_superedges']}"
    assert lines[4] == f"iterations: {out['iterations']}"
    assert sum(x.startswith("  node ") for x in lines) == 5
    assert any(x.startswith("  top-PageRank nodes") for x in lines)
    assert json.loads(lines[-1]) == out


def test_it_refuses_to_run_without_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        load_example("torch_quickstart").main([])
