"""The plain reference held to the port on a small stand-in on the CPU, and
its controls refused."""

import json

import pytest
import torch
from conftest import ROOT, TINY_CELL, make_tiny_root

from bench import readings
from bench.reference import check, kernels


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    torch.set_num_threads(1)
    root = make_tiny_root(tmp_path_factory.mktemp("tiny"))
    got = []
    # seed 5 captures round 5 of 5, where supernodes have merged
    readings.readings(root, TINY_CELL, [5], controls=1, device="cpu",
                      emit=lambda line: got.append(json.loads(line)))
    limits = json.loads((root / "bench" / "limits" / f"{TINY_CELL}.json").read_text())
    return {g["source"]: g for g in got}, limits


def test_port_passes_every_number(lines):
    by_source, limits = lines
    prog = by_source["program"]
    for k in check.EXACT:
        assert prog[k] == 0, k
    for k in check.GAPS:
        assert prog[k] < 1e-5, (k, prog[k])
        assert prog[k] <= limits[k]


@pytest.mark.parametrize("source, numbers", [
    ("bfloat16", ("metric_gap", "cost_gap", "gain_gap")),
    ("node_moved", ("weight_faults",)),
    ("weight_changed", ("weight_faults",)),
])
def test_controls_fail(lines, source, numbers):
    by_source, limits = lines
    got = by_source[source]
    for k in numbers:
        assert got[k] > limits[k], (source, k, got[k], limits[k])


def test_weight_changed_is_one_fault(lines):
    assert lines[0]["weight_changed"]["weight_faults"] == 1


def _gain_operands(gen, g=3, c=5, u=7):
    m = torch.poisson(torch.full((g, c, u), 1.5), generator=gen)
    n = torch.randint(1, 9, (g, c), generator=gen).float()
    n[0, 4] = 0.0  # a padding member
    s = torch.poisson(torch.full((g, c), 0.5), generator=gen)
    n_u = torch.randint(1, 9, (g, u), generator=gen).float()
    cidx = torch.randint(0, u + 1, (g, c), generator=gen).int()
    w = torch.poisson(torch.full((g, c, c), 0.4), generator=gen)
    w = torch.maximum(w, w.transpose(1, 2))
    w.diagonal(dim1=1, dim2=2).zero_()
    t = 40.0 + 30.0 * torch.rand((g, c), generator=gen)
    return m, n, s, t, n_u, cidx, w


def test_frozen_kernels_match_the_ports_plain_versions():
    from repro_torch.kernels import ref

    gen = torch.Generator().manual_seed(3)
    cbar, log2v = torch.tensor(41.5), torch.tensor(21.0)
    cnt = torch.poisson(torch.full((500,), 2.0), generator=gen)
    pi = cnt + torch.randint(0, 40, (500,), generator=gen).float()
    want = ref.pair_cost_ref(cnt, pi, cbar, log2v).double()
    got = kernels.pair_cost(cnt.double(), pi.double(), cbar.double(), log2v.double())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)

    ops = _gain_operands(gen)
    rel_p, red_p = ref.merge_gain_ref(*ops, cbar, log2v)
    d = [x.double() if x.is_floating_point() else x for x in ops]
    rel_r, red_r, _ = kernels.merge_gain(*d, cbar.double(), log2v.double())
    assert torch.equal(rel_p == float("-inf"), rel_r == float("-inf"))
    ok = rel_r > float("-inf")
    torch.testing.assert_close(rel_p.double()[ok], rel_r[ok], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(red_p.double(), red_r, rtol=1e-5, atol=1e-3)


@pytest.mark.card
def test_hand_kernels_pass_on_the_card(tmp_path):
    """The same readings with the CUDA and Triton kernels, on a graph of
    2**16 vertices: the program within every limit, the control outside."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the hand kernels run only there")
    root = make_tiny_root(tmp_path, num_nodes=2 ** 16, num_edges=400_000, rounds=8)
    got = []
    readings.readings(root, TINY_CELL, [2 ** 31 + 11], controls=1, device="cuda",
                      emit=lambda line: got.append(json.loads(line)))
    by_source = {g["source"]: g for g in got}
    limits = json.loads((root / "bench" / "limits" / f"{TINY_CELL}.json").read_text())
    assert all(by_source["program"][k] <= limits[k] for k in check.NUMBERS)
    assert any(by_source["bfloat16"][k] > limits[k] for k in check.NUMBERS)


@pytest.mark.parametrize("max_neighbors, union_size", [(64, 128), (4, 16), (9, 40)])
def test_plain_group_tables_match_the_ports(max_neighbors, union_size):
    """The reference's union-space tables equal the program's on a coarse
    partition of a small R-MAT graph, where members have more neighbours
    than ``D`` and groups more than ``U``."""
    from bench import graphs
    from bench.reference import summary
    from repro_torch.core import costs, tables
    from repro_torch.core.types import SummaryState

    conf = json.loads((ROOT / "bench" / "configs" / "skitter.json").read_text())
    conf.update(num_nodes=2048, num_edges=12000)
    src, dst, v = graphs.generate(conf, 77, "cpu")
    gen = torch.Generator().manual_seed(5)
    # a partition of ~600 supernodes, some ids dead
    n2s = torch.randint(0, 600, (v,), generator=gen) * 3
    size = torch.bincount(n2s, minlength=v)
    state = SummaryState(node2super=n2s, size=size, t=torch.ones((), dtype=torch.int64))
    pt = costs.build_pair_table(src, dst, state)
    groups = torch.randint(0, 1800, (24, 32), generator=gen)
    groups[:, -3:] = -1  # padding members
    scal = torch.tensor([30.0, 11.0])
    gt = tables.build_group_tables(pt, state, groups, max_neighbors, union_size, scal, v)

    lo, hi, cnt = summary.pair_table(src, dst, n2s, v)
    m, n_u, cidx, w = summary.group_tables(lo, hi, cnt, size, groups, max_neighbors,
                                           union_size, v)
    assert torch.equal(gt.m.long(), m) and torch.equal(gt.n_u.long(), n_u)
    assert torch.equal(gt.cidx.long(), cidx) and torch.equal(gt.w.long(), w)
    # both cuts were in play
    deg = torch.bincount(torch.cat([lo[lo != hi], hi[lo != hi]]), minlength=v)
    live = groups[groups >= 0]
    assert int(deg[live].max()) > max_neighbors
    assert bool((m.sum(1) > 0).sum(-1).eq(union_size).any())
    assert bool((cidx < union_size).any()) and bool((cidx == union_size).any())
