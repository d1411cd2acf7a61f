"""The port's copies of the SSumM scripts, on the CPU:
``scripts/torch_make_edgelist.py``, ``torch_measure_resume.py`` and
``torch_measure_feed_rss.py``.

* The edge-list writer writes the reference script's bytes (gzip'd files
  compared decompressed: gzip's header holds the write time) for a noisy
  registry case and an R-MAT case; the reference's ``main`` runs once, in a
  subprocess (``tests/torch_examples_check.py edgelist``).
* The resume measurement prints the reference script's JSON keys (taken
  from its source with ``ast``) and ``device``, saves at every round,
  resumes from the first committed step and commits bytes, on the
  single-device path and under ``torchrun`` with 2 gloo ranks. It runs
  dblp at scale 0.01 with T = 4: on the CPU the plain merge gain takes
  5.5 s a round at scale 0.05, and the script runs the rounds four times.
* The feed measurement's shard layout and staging equal the reference's
  ``shard_layout`` for |E| and 4 ranks; its RSS deltas are printed, not
  asserted (they are the host's, and small at this size).
"""

from __future__ import annotations

import ast
import contextlib
import gzip
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_examples_check as tec
from repro.graphs import feed as rfeed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESUME_ARGS = ["--dataset", "dblp", "--scale", "0.01", "--T", "4", "--driver-chunk", "1",
               "--device", "cpu"]

torch.set_num_threads(1)


def load_script(name: str):
    """A file of ``scripts/`` as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quiet(fn, *args, **kw):
    """``fn(*args, **kw)`` with its printing kept; returns (result, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def child_env() -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


# ---------------------------------------------------------------- edge lists

@pytest.fixture(scope="module")
def edge_lists(tmp_path_factory):
    """``(reference dir, port dir)``, each holding every case's file."""
    ref_dir = tmp_path_factory.mktemp("edgelist_ref")
    port_dir = tmp_path_factory.mktemp("edgelist_port")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "torch_examples_check.py"),
                           "edgelist", str(ref_dir)],
                          capture_output=True, text=True, timeout=300, env=child_env())
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    writer = load_script("torch_make_edgelist")
    for name, args in tec.EDGE_CASES.items():
        out, text = quiet(writer.main, args + ["--out", str(port_dir / name)])
        assert out == str(port_dir / name) and text.startswith(out)
    return ref_dir, port_dir


@pytest.mark.parametrize("name", sorted(tec.EDGE_CASES))
def test_the_edge_list_writer_writes_the_reference_bytes(edge_lists, name):
    ref_dir, port_dir = edge_lists
    read = gzip.open if name.endswith(".gz") else open
    with read(ref_dir / name, "rb") as f:
        want = f.read()
    with read(port_dir / name, "rb") as f:
        got = f.read()
    assert len(want) > 10_000 and got == want


# ------------------------------------------------------------------- resume

def reference_resume_keys() -> set[str]:
    """The keys of the JSON record ``scripts/measure_resume.py`` prints."""
    with open(os.path.join(ROOT, "scripts", "measure_resume.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps({...}) in scripts/measure_resume.py")


def check_resume_record(rec: dict, mode: str) -> None:
    assert set(rec) == reference_resume_keys() | {"device"}
    assert rec["mode"] == mode and rec["device"] == "cpu"
    assert rec["dataset"] == "dblp" and rec["E"] > 0
    assert rec["rounds"] >= 1 and rec["saves"] >= rec["rounds"]
    # every=1 with driver_chunk 1: round 1 is the first step committed
    assert rec["resumed_from_step"] == 1
    assert rec["checkpoint_bytes"] > 0
    for k in ("wall_plain_s", "wall_checkpointed_s", "wall_resumed_s", "snapshot_mean_ms",
              "write_mean_ms", "restore_wall_ms"):
        assert np.isfinite(rec[k]) and rec[k] >= 0, k


def test_the_resume_measurement_on_the_single_device_path():
    rec, text = quiet(load_script("torch_measure_resume").main, RESUME_ARGS)
    check_resume_record(rec, "local")
    assert json.loads(text) == rec


def test_the_resume_measurement_over_two_gloo_ranks_under_torchrun():
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", os.path.join(ROOT, "scripts", "torch_measure_resume.py"), *RESUME_ARGS,
         "--distributed"],
        capture_output=True, text=True, timeout=300, env=child_env(), cwd=ROOT)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    out = proc.stdout
    assert out.count('"mode"') == 1  # rank 0 alone prints
    check_resume_record(json.loads(out[out.index("{"):]), "distributed(world=2)")


# --------------------------------------------------------------------- feed

@pytest.fixture(scope="module")
def feed_rows(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("feed_rss")
    path = str(tmp / "rmat.txt")
    quiet(load_script("torch_make_edgelist").main,
          ["--v", "16384", "--e", "60000", "--shuffle", "--out", path])
    rows, text = quiet(load_script("torch_measure_feed_rss").main,
                       [path, "--ranks", "4", "--device", "cpu", "--out",
                        str(tmp / "feed_rss_torch.json")])
    print(text)  # the RSS deltas, for the log
    with open(tmp / "feed_rss_torch.json") as f:
        assert json.load(f) == rows
    return rows


def test_the_feed_holds_one_shard_of_staging_a_rank(feed_rows):
    dens, feed = feed_rows
    assert (dens["mode"], feed["mode"]) == ("densify", "feed")
    assert dens["E"] == feed["E"] and all(r["device"] == "cpu" for r in feed_rows)
    rows, padded = rfeed.shard_layout(feed["E"], 4)
    f = feed["feed"]
    assert (f["shard_rows"], f["padded_edges"], f["n_devices"]) == (rows, padded, 4)
    assert f["peak_staging_bytes"] == f["shard_bytes"] == 4 * rows
    assert f["local_shards"] == 4 and f["bytes_copied"] == 4 * 2 * 4 * rows
    assert f["path"] == "cache-mmap"


def test_both_children_report_their_rss_deltas(feed_rows):
    for r in feed_rows:
        assert r["ranks"] == 4
        assert np.isfinite(r["delta_resident_mb"]) and r["delta_peak_mb"] >= 0
        assert r["after_mb"] > 0 and r["device"] == "cpu"
