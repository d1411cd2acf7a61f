"""Shared set-up of the benchmark's tests: the repository's root and the
port's ``src`` on the path, the ``card`` marker, and a tiny cell laid out as
a checkout's ``BENCHMARK.json`` and ``bench/`` files in a temporary root."""

import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CELL = "tiny.summarize"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skipped without one")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_tiny_root(dest: pathlib.Path, num_nodes: int = 2048, num_edges: int = 5000,
                   rounds: int = 5) -> pathlib.Path:
    """A checkout-like root holding the benchmark's files and one tiny cell:
    the skitter configuration at ``num_nodes``/``num_edges``, the summarize
    mix at ``rounds`` rounds, and skitter's limits."""
    bench = dest / "bench"
    shutil.copytree(ROOT / "bench", bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((bench / "configs" / "skitter.json").read_text())
    conf.update(name="tiny", num_nodes=num_nodes, num_edges=num_edges)
    (bench / "configs" / "tiny.json").write_text(json.dumps(conf))
    mix = json.loads((bench / "traffic" / "summarize.json").read_text())
    mix["name"] = "tiny"
    mix["summary"]["T"] = rounds
    (bench / "traffic" / "tiny.json").write_text(json.dumps(mix))
    shutil.copy(bench / "limits" / "skitter.summarize.json",
                bench / "limits" / f"{TINY_CELL}.json")
    spec["configs"].append(dict(spec["configs"][0], name="tiny",
                                file="bench/configs/tiny.json"))
    spec["workloads"].append(dict(spec["workloads"][0], name=TINY_CELL, config="tiny",
                                  traffic="tiny"))
    for m in spec["per_layer"]:
        m["workloads"].append(TINY_CELL)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
