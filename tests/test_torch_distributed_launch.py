"""``repro_torch.launch.summarize --distributed`` over gloo on the CPU.

A world of one (no ``torchrun``: the launcher makes the group itself) and
``torchrun`` worlds of 2 and 4, on ego-facebook at scale 0.05 with T = 5:
rank 0 prints the digests and the reference's distributed JSON keys; every
world gives the partition of an in-process run with no group (the compact
grouping does not depend on the rank count).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.types import SummaryConfig, make_graph
from repro_torch.graphs import generate
from repro_torch.graphs.feed import shard_edges
from repro_torch.launch import summarize as launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--distributed", "--device", "cpu", "--dataset", "ego-facebook", "--scale", "0.05",
        "--T", "5"]
REFERENCE_KEYS = (
    "dataset", "V", "E", "mode", "size_bits", "size_bits_before_sparsify",
    "relative_size", "re1", "re2", "num_supernodes", "num_superedges",
    "superedges_dropped", "sparsify_wall_s", "feed_wall_s", "feed_path",
    "feed_shard_rows", "feed_shard_bytes", "feed_peak_staging_bytes",
    "feed_bytes_copied", "feed_local_shards", "process_count", "process_index",
    "chunk_wall_s", "straggler_events", "resumed_from", "checkpoint_saves",
    "checkpoint_snapshot_wall_s", "wall_s", "source", "load_wall_s",
    "ingest_bytes_parsed", "peak_rss_mb")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def alone():
    """The launcher's backend in this process, with no process group."""
    src, dst, v = generate("ego-facebook", seed=0, scale=0.05)
    g, _ = make_graph(src, dst, v, "cpu")
    sh = shard_edges(g.src.numpy(), g.dst.numpy(), 0, 1, device="cpu")
    state, stats, size_g, run = launch.run_distributed(
        sh, v, SummaryConfig(T=5, k_frac=0.3), "cpu")
    return launch.digest(state.node2super.to(torch.int32).numpy()), stats, run


@pytest.mark.parametrize("world", [1, 2, 4])
def test_launcher_distributed_prints_the_reference_keys(alone, world):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    if world == 1:  # no torchrun: a world of one
        cmd = [sys.executable, "-m", "repro_torch.launch.summarize", *ARGS]
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(world), "-m", "repro_torch.launch.summarize", *ARGS]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env,
                          cwd=ROOT)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    out = proc.stdout
    assert out.count("digests node2super=") == 1  # rank 0 alone prints
    head, body = out[out.index("digests"):].split("\n", 1)
    res = json.loads(body)
    for k in REFERENCE_KEYS:
        assert k in res, k
    assert res["mode"] == f"distributed{{'ranks': {world}}}"
    assert res["process_count"] == world and res["process_index"] == 0
    assert res["backend"] == "gloo" and res["device"] == "cpu"
    assert res["feed_path"] == "memory" and res["feed_local_shards"] == 1
    assert res["feed_peak_staging_bytes"] == res["feed_shard_bytes"]
    assert res["feed_shard_rows"] == -(-res["E"] // world)
    assert res["relative_size"] <= 0.3 * (1 + 1e-6)
    assert res["kernel_launches"] == {"merge_gain": 0, "pair_cost": 0, "segment_sum": 0,
                                      "ordered_sum": 0}
    assert all(h["overflow"] == 0 for h in res["history"])
    # the partition of the run with no group, and its results
    want_digest, stats, run = alone
    assert head.split()[1] == f"node2super={want_digest}"
    assert res["iterations"] == run.iterations_run
    for k, key in (("size_bits", "size_bits"), ("num_supernodes", "num_supernodes"),
                   ("superedges_dropped", "dropped")):
        assert res[k] == stats[key], k
    np.testing.assert_allclose(res["re1"], stats["re1"], rtol=1e-6)
