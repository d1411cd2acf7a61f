"""The port's round and whole run against the live reference.

One round: every round of a live reference run (the golden fixture and one
rmat fixture) is fed, state and permutations, into the port's
``merge_iteration``; the merge set and the integer stats must be identical,
the float stats within the reference's tolerance. Whole run: the port's
``summarize(..., device="cpu")`` with the reference's permutations replayed
against ``repro.core.summarize`` run live on the same graph.
"""

import numpy as np
import pytest
import torch

from test_torch_reference import (
    CPU,
    FIXTURES,
    RTOL,
    configs,
    graph,
    perm_chain,
    port_state,
    reference_result,
    reference_rounds,
    replay,
)

from repro_torch.core import evaluate as pev
from repro_torch.core import merge as pmerge
from repro_torch.core import summarize
from repro_torch.core.convert import ReplayPermutations

INT_STATS = ("nmerges", "num_supernodes", "num_superedges")
FLOAT_STATS = ("size_bits", "mdl_cost", "re1", "re2", "total_reduction")


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_one_round_fed_the_same_state(name):
    _, pg, v, rows = reference_rounds(name)
    _, pcfg = configs(name)
    assert rows
    for row in rows:
        theta = torch.tensor(row["theta"], dtype=torch.float32)
        new_state, stats = pmerge.merge_iteration(pg.src, pg.dst, port_state(row),
                                                  pcfg, theta, replay(row))
        where = (name, row["t"])
        np.testing.assert_array_equal(new_state.node2super.numpy(),
                                      row["next_node2super"], err_msg=str(where))
        np.testing.assert_array_equal(new_state.size.numpy(), row["next_size"],
                                      err_msg=str(where))
        assert new_state.t == row["t"] + 1
        for k in INT_STATS:
            assert float(stats[k]) == row["stats"][k], (where, k)
        for k in FLOAT_STATS:
            np.testing.assert_allclose(float(stats[k]), row["stats"][k], rtol=RTOL,
                                       err_msg=str((where, k)))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_whole_run_matches_live_reference(name):
    src, dst, v = graph(name)
    rcfg, pcfg = configs(name)
    want = reference_result(name)
    chain = perm_chain(rcfg.seed, v, rcfg.T + rcfg.max_extra_iters)
    got = summarize(src, dst, v, pcfg, device="cpu",
                    perms=ReplayPermutations(chain))

    assert got.iterations_run == want.iterations_run
    assert len(got.history) == len(want.history)
    for hg, hw in zip(got.history, want.history):
        assert hg["t"] == hw["t"] and hg["theta"] == hw["theta"]
        for k in INT_STATS:
            assert hg[k] == hw[k], (name, hw["t"], k)
        for k in FLOAT_STATS:
            np.testing.assert_allclose(hg[k], hw[k], rtol=RTOL,
                                       err_msg=str((name, hw["t"], k)))
    assert got.num_supernodes == want.num_supernodes
    assert got.num_superedges == want.num_superedges
    np.testing.assert_array_equal(got.node2super, want.node2super)
    np.testing.assert_array_equal(got.super_size, want.super_size)
    np.testing.assert_array_equal(got.edge_lo, want.edge_lo)
    np.testing.assert_array_equal(got.edge_hi, want.edge_hi)
    np.testing.assert_array_equal(got.edge_w, want.edge_w)
    assert got.node2super.dtype == np.int32 and got.edge_lo.dtype == np.int32
    for k in ("size_bits", "input_size_bits", "re1", "re2", "mdl_cost"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=RTOL,
                                   err_msg=k)
    assert got.size_bits <= rcfg.k_frac * got.input_size_bits * (1 + 1e-6)


def test_result_metrics_match_dense_bruteforce():
    """The port's summary reproduces its own Eq. 2/4 metrics by dense
    reconstruction (the port's default permutation source)."""
    from repro_torch.graphs import generate

    src, dst, v = generate("ego-facebook", seed=3, scale=0.04)
    _, pcfg = configs("ego-facebook", T=8)
    res = summarize(src, dst, v, pcfg, device=CPU)
    a = pev.dense_adjacency(src, dst, v)
    a_hat = pev.reconstruct_dense(res)
    np.testing.assert_allclose(res.re1, pev.re_p_dense(a, a_hat, 1), rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(res.re2, pev.re_p_dense(a, a_hat, 2), rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(res.size_bits, pev.summary_size_bits_dense(res), rtol=1e-5)
    assert res.size_bits <= pcfg.k_frac * res.input_size_bits * (1 + 1e-6)
