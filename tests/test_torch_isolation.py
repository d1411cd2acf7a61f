"""The port stands alone and stays on the device it was asked for: no module
of ``repro_torch`` imports JAX or the reference package, nor does
``chip_smoke.py``; entry points without an explicit ``device="cpu"`` refuse
to run on a machine without CUDA, and the kernel seam takes the plain
versions for CPU tensors only."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import SummaryConfig, summarize
from repro_torch.kernels import ops, ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = []
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib", "repro."))
             or k == "repro" or k == "triton" or k.startswith("triton."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_no_module_imports_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for m in ("repro_torch.core.engine", "repro_torch.kernels.merge_gain",
              "repro_torch.kernels.entropy_bits", "repro_torch.launch.summarize",
              "repro_torch.core.convert", "repro_torch.graphs.synthetic",
              "repro_torch.graphs.io", "repro_torch.core.queries",
              "repro_torch.core.query_engine", "repro_torch.launch.query_serve",
              "repro_torch.kernels.segment_sum", "repro_torch.core.distributed",
              "repro_torch.dist", "repro_torch.dist.sharding", "repro_torch.graphs.feed"):
        assert m in res["modules"]


def test_chip_smoke_imports_nothing_of_jax_or_the_reference():
    """Every import statement of ``chip_smoke.py``, at any depth."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "repro_torch.core" in names and "torch" in names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device runs")


def test_summarize_without_device_refuses_the_cpu():
    _no_cuda()
    src, dst = np.array([0, 1, 2]), np.array([1, 2, 3])
    with pytest.raises(RuntimeError, match="CUDA"):
        summarize(src, dst, 4, SummaryConfig(T=2))


def test_launcher_without_device_refuses_the_cpu():
    _no_cuda()
    from repro_torch.launch import summarize as launch

    with pytest.raises(RuntimeError, match="device"):
        launch.main(["--dataset", "ego-facebook", "--scale", "0.02", "--T", "2"])


def test_query_server_without_device_refuses_the_cpu():
    _no_cuda()
    from repro_torch.launch import query_serve

    with pytest.raises(RuntimeError, match="device"):
        query_serve.main(["--dataset", "ego-facebook", "--scale", "0.02", "--T", "2"])


def test_launcher_on_the_cpu_prints_the_reference_keys(capsys):
    from repro_torch.launch import summarize as launch

    res = launch.main(["--dataset", "ego-facebook", "--scale", "0.03", "--T", "3",
                       "--device", "cpu"])
    digests, body = capsys.readouterr().out.split("\n", 1)
    assert digests.startswith("digests node2super=")
    printed = json.loads(body)
    assert printed == json.loads(json.dumps(res))
    for k in ("dataset", "V", "E", "mode", "size_bits", "relative_size", "re1", "re2",
              "num_supernodes", "num_superedges", "iterations", "chunk_wall_s",
              "wall_s", "device", "kernel_launches"):
        assert k in res, k
    assert res["device"] == "cpu" and res["mode"] == "local"
    assert res["kernel_launches"] == {"merge_gain": 0, "pair_cost": 0, "segment_sum": 0,
                                     "ordered_sum": 0}
    assert res["relative_size"] <= 0.3 * (1 + 1e-6)


def test_ops_on_cpu_tensors_return_the_plain_result():
    rng = np.random.default_rng(0)
    cnt = torch.as_tensor(rng.poisson(2.0, 500).astype(np.float32))
    pi = cnt + torch.as_tensor(rng.integers(0, 9, 500).astype(np.float32))
    scal = torch.tensor([30.0, 11.0])
    before = ops.launch_counts()
    assert torch.equal(ops.pair_cost(cnt, pi, scal),
                       ref.pair_cost_ref(cnt, pi, scal[0], scal[1]))
    g, c, u = 2, 4, 8
    m = torch.as_tensor(rng.poisson(1.0, (g, c, u)).astype(np.float32))
    n = torch.full((g, c), 3.0)
    s = torch.zeros(g, c)
    t = torch.full((g, c), 100.0)
    n_u = torch.full((g, u), 2.0)
    cidx = torch.full((g, c), u, dtype=torch.int32)
    w = torch.zeros(g, c, c)
    got = ops.merge_gain(m, n, s, t, n_u, cidx, w, scal)
    want = ref.merge_gain_ref(m, n, s, t, n_u, cidx, w, scal[0], scal[1])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts() == before  # no kernel launched
