"""``examples/torch_distributed_summarize.py`` against the reference's
``examples/distributed_summarize.py``.

The reference example runs unchanged, once, in a subprocess on 8 XLA host
devices (``tests/torch_examples_check.py distributed``), which records what
its engine returned and the compact grouping's draws of its rounds, with
its merge gain kept unfused (as its single-device round computes it; the
helper's docstring says why); the
port's example spawns 8 gloo ranks on the CPU with those draws replayed.
Exact: the rounds, |S|, merges and bucket overflow each round, the
iterations, the sparsification's ξ and dropped superedges. Within
``rtol=1e-6``: ``size_bits`` and RE₁, each round's and the final ones (the
reference's chunked loop may part from its own per-round step by one
float32 ulp).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.core.convert import ReplayRoundPermutations

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6
RANKS = 8

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_example_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "torch_examples_check.py"),
                           "distributed", str(out)],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    return dict(np.load(out)), proc.stdout


@pytest.fixture(scope="module")
def port(ref):
    """The port's example on 8 spawned gloo ranks with the reference's
    draws: rank 0's record and what the ranks printed (the children write
    to this process's file descriptor 1, redirected to a file here)."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))  # the children import it by name
    perms = ReplayRoundPermutations(ref[0]["h"])
    with tempfile.TemporaryFile(mode="w+") as f:
        sys.stdout.flush()
        saved = os.dup(1)
        os.dup2(f.fileno(), 1)
        try:
            import torch_distributed_summarize as example

            out = example.main(["--device", "cpu"], perms=perms)
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
            sys.path.remove(os.path.join(ROOT, "examples"))
        f.seek(0)
        return out, f.read()


def test_the_run_is_eight_gloo_ranks_on_one_shard_each(ref, port):
    out, _ = port
    assert (out["world"], out["backend"], out["device"]) == (RANKS, "gloo", "cpu")
    assert out["shard_rows"] == -(-out["E"] // RANKS)
    assert out["peak_staging_bytes"] == 4 * out["shard_rows"]
    assert out["iterations"] == int(ref[0]["iterations"])
    np.testing.assert_allclose(out["k_bits"], float(ref[0]["k_bits"]), rtol=1e-12)


@pytest.mark.parametrize("key", ["t", "num_supernodes", "nmerges", "overflow"])
def test_each_round_counts_equal_the_reference(ref, port, key):
    got = [row[key] for row in port[0]["rounds"]]
    np.testing.assert_array_equal(got, ref[0][f"round_{key}"])


@pytest.mark.parametrize("key", ["size_bits", "re1"])
def test_each_round_metrics_agree_with_the_reference(ref, port, key):
    got = [row[key] for row in port[0]["rounds"]]
    np.testing.assert_allclose(got, ref[0][f"round_{key}"], rtol=RTOL)


def test_no_bucket_overflows_and_the_budget_is_reached(port):
    out, _ = port
    assert all(row["overflow"] == 0 for row in out["rounds"])
    assert out["budget_reached"] and out["rounds"][-1]["size_bits"] <= out["k_bits"]


@pytest.mark.parametrize("key", ["xi", "dropped"])
def test_the_sparsification_counts_equal_the_reference(ref, port, key):
    assert port[0][key] == float(ref[0][f"sparsify_{key}"])


@pytest.mark.parametrize("key", ["size_bits", "re1"])
def test_the_sparsified_metrics_agree_with_the_reference(ref, port, key):
    np.testing.assert_allclose(port[0][key], float(ref[0][f"sparsify_{key}"]), rtol=RTOL)


def test_rank_zero_prints_the_reference_lines(ref, port):
    (out, text), ref_text = port, ref[1]
    lines = text.splitlines()

    def rows(t):
        return [x for x in t.splitlines() if x.startswith("  t=")]

    assert len(rows(text)) == len(rows(ref_text)) == len(out["rounds"])
    assert ("  budget reached" in lines) == ("  budget reached" in ref_text.splitlines())
    assert sum(x.startswith("sparsify: ξ=") for x in lines) == 1
    assert lines[0] == ref_text.splitlines()[0]  # graph: |V| |E| Size(G)
    assert json.loads(lines[-1]) == out
