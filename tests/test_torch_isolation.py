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
              "repro_torch.dist", "repro_torch.dist.sharding", "repro_torch.graphs.feed",
              "repro_torch.dist.compress", "repro_torch.launch.mesh",
              "repro_torch.baselines", "repro_torch.baselines.common",
              "repro_torch.baselines.kgs", "repro_torch.baselines.s2l",
              "repro_torch.baselines.saa_gs", "repro_torch.configs",
              "repro_torch.configs.base", "repro_torch.configs.qwen2_5_14b",
              "repro_torch.configs.ssumm_paper", "repro_torch.models",
              "repro_torch.models.common", "repro_torch.models.flash",
              "repro_torch.models.attention", "repro_torch.models.transformer",
              "repro_torch.models.moe", "repro_torch.models.mamba2",
              "repro_torch.models.zamba2", "repro_torch.models.xlstm",
              "repro_torch.models.api", "repro_torch.launch.serve",
              "repro_torch.models.whisper", "repro_torch.models.losses",
              "repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.dist.microbatch",
              "repro_torch.data", "repro_torch.data.tokens", "repro_torch.data.loader",
              "repro_torch.launch.train"):
        assert m in res["modules"]


_TIERS = r"""
import json, sys
import numpy as np
from repro_torch.core import SummaryConfig, summarize
from repro_torch.core.query_engine import PartitionedQueryEngine, QueryEngine, RoutedQueryEngine
src, dst = np.arange(40) % 13, (np.arange(40) * 7 + 3) % 13
res = summarize(src, dst, 13, SummaryConfig(T=2), device="cpu", collect_history=False)
kinds, u = np.arange(7) % 7, np.arange(7)
want = QueryEngine(res, device="cpu").answer_batch(kinds, u, u[::-1])
same = [bool(np.array_equal(e.answer_batch(kinds, u, u[::-1]), want)) for e in (
    RoutedQueryEngine(res, device="cpu", ranks=2),
    PartitionedQueryEngine(res, device="cpu", ranks=2, dense_row_nnz=0))]
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib", "repro.")) or k == "repro")
print(json.dumps({"same": same, "bad": bad}))
"""


def test_query_tiers_run_without_jax_or_the_reference():
    """The multi-rank tiers, run in one process at 2 ranks, load no JAX."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _TIERS], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"same": [True, True], "bad": []}


def _imports(path: pathlib.Path) -> list[str]:
    """The modules every import statement of ``path`` names, at any depth."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    return names


def test_chip_smoke_imports_nothing_of_jax_or_the_reference():
    """Every import statement of ``chip_smoke.py``, at any depth."""
    names = _imports(ROOT / "chip_smoke.py")
    assert "repro_torch.core" in names and "torch" in names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


@pytest.mark.parametrize("script,banned", [
    ("torch_multihost_check.py", ("jax", "jaxlib", "repro", "repro_torch", "torch")),
    ("torch_wire_check.py", ("jax", "jaxlib", "repro"))])
def test_multihost_check_scripts_import_neither_package(script, banned):
    """The gate only launches subprocesses; its wire leg imports the port alone."""
    names = _imports(ROOT / "tests" / script)
    assert [n for n in names if n.split(".")[0] in banned] == []


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


_SERVE_AND_BASELINES = r"""
import json, sys
import numpy as np
from repro_torch.baselines import summarize_kgs, summarize_s2l, summarize_saa_gs
from repro_torch.launch import serve
src, dst = np.arange(40) % 13, (np.arange(40) * 7 + 3) % 13
keep = src != dst
src, dst = np.minimum(src, dst)[keep], np.maximum(src, dst)[keep]
sizes = [f(src, dst, 13, device="cpu").num_supernodes
         for f in (summarize_kgs, summarize_s2l, summarize_saa_gs)]
res = serve.main(["--smoke", "--device", "cpu", "--requests", "2", "--slots", "2",
                  "--prompt-len", "3", "--gen-len", "2", "--max-len", "16"])
moe = serve.main(["--arch", "granite_moe_3b_a800m", "--smoke", "--device", "cpu",
                  "--requests", "2", "--slots", "2", "--prompt-len", "3", "--gen-len", "2",
                  "--max-len", "16"])
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib", "repro.")) or k == "repro")
print(json.dumps({"sizes": sizes, "tokens": [res["tokens"], moe["tokens"]], "bad": bad}))
"""


def test_baselines_and_lm_serving_run_without_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _SERVE_AND_BASELINES], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [] and res["tokens"] == [4, 4]
    assert all(2 <= n <= 13 for n in res["sizes"])


_TRAIN_AND_WHISPER = r"""
import json, sys
from repro_torch.launch import serve, train
res = train.main(["--arch", "h2o_danube_1_8b", "--smoke", "--device", "cpu", "--steps", "2",
                  "--batch", "2", "--seq", "8", "--accum", "2", "--compress", "int8"])
srv = serve.main(["--arch", "whisper_large_v3", "--smoke", "--device", "cpu", "--requests", "2",
                  "--slots", "2", "--prompt-len", "3", "--gen-len", "2", "--max-len", "16"])
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib", "repro.")) or k == "repro")
print(json.dumps({"steps": res["steps"], "tokens": srv["tokens"], "bad": bad}))
"""


def test_training_and_whisper_serving_run_without_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _TRAIN_AND_WHISPER], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"steps": 2, "tokens": 4, "bad": []}


def test_trainer_and_loader_without_device_refuse_the_cpu():
    _no_cuda()
    from repro_torch.data import Loader
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "h2o_danube_1_8b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        Loader(lambda i: np.zeros(2, np.int32))


def test_lm_server_and_baselines_without_device_refuse_the_cpu():
    _no_cuda()
    from repro_torch.baselines import evaluate_partition, summarize_s2l
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model

    src, dst = np.array([0, 1, 2]), np.array([1, 2, 3])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--requests", "1", "--slots", "1"])
    for arch in ("qwen2_5_14b", "granite_moe_3b_a800m", "zamba2_7b", "xlstm_350m",
                 "paligemma_3b", "whisper_large_v3"):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(get_smoke_config(arch))
    with pytest.raises(RuntimeError, match="CUDA"):
        summarize_s2l(src, dst, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_partition(src, dst, 4, np.arange(4))


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
