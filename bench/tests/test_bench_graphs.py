"""The on-device R-MAT copy, on the CPU at a small size."""

import json

import pytest
import torch
from conftest import ROOT

from bench import graphs


def _config(v=3000, e=20000):
    conf = json.loads((ROOT / "bench" / "configs" / "skitter.json").read_text())
    conf.update(num_nodes=graphs.num_nodes(v), num_edges=e)
    return conf


def test_sizes_and_canonical_edges():
    lo, hi, v = graphs.generate(_config(), 12345678901, "cpu")
    assert v == 4096 == 2 ** 12
    assert lo.numel() == hi.numel() == 20000
    assert bool((lo < hi).all()) and bool((lo >= 0).all()) and bool((hi < v).all())
    key = lo * v + hi
    assert bool((key[1:] > key[:-1]).all())  # ascending, so unique


def test_seed_repeats_and_differs():
    a = graphs.generate(_config(), 2 ** 33 + 5, "cpu")
    b = graphs.generate(_config(), 2 ** 33 + 5, "cpu")
    c = graphs.generate(_config(), 2 ** 33 + 6, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not (torch.equal(a[0], c[0]) and torch.equal(a[1], c[1]))


def test_too_few_distinct_edges_raise():
    with pytest.raises(ValueError, match="distinct"):
        graphs.generate(_config(v=64, e=5000), 1, "cpu")


@pytest.mark.parametrize("name", ["skitter", "livejournal"])
def test_configs_round_vertices_up_to_a_power_of_two(name):
    conf = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    assert conf["num_nodes"] == graphs.num_nodes(conf["published"]["num_nodes"])
    assert conf["num_edges"] == conf["published"]["num_edges"]
    assert set(conf["reduced"]) == {"num_nodes", "edges"}
