"""``repro_torch.core.merge`` against ``repro.core.merge``: θ(t), the
mutual-argmax matching (equal maxima and all -inf rows included) and the
merge application, on crafted gains and on the gains of live reference
rounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import (
    CPU,
    FIXTURES,
    configs,
    np_,
    port_state,
    ref_state,
    reference_rounds,
)

from repro.core import engine as rengine
from repro.core import merge as rmerge

from repro_torch.core import engine as pengine
from repro_torch.core import merge as pmerge

NEG = float("-inf")


def _matching(rel, members, theta):
    want = rmerge.select_matching(jnp.asarray(rel), jnp.asarray(members, jnp.int32),
                                  jnp.float32(theta))
    got = pmerge.select_matching(torch.as_tensor(rel), torch.as_tensor(members, dtype=torch.int64),
                                 torch.tensor(theta, dtype=torch.float32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_(g), np_(w))
    return got


def test_theta_schedule():
    for big_t in (1, 5, 20):
        for t in range(0, big_t + 3):
            want = rmerge.theta_schedule(jnp.int32(t), big_t)
            assert float(pmerge.theta_schedule(t, big_t, CPU)) == float(want)
            assert pengine.theta_schedule_host(t, big_t) == rengine.theta_schedule_host(t, big_t)
    # θ is float32: 1/3 in float64 is not the threshold the reference uses
    assert pmerge.theta_schedule(2, 20, CPU).dtype == torch.float32
    assert float(pmerge.theta_schedule(2, 20, CPU)) != 1.0 / 3.0


def test_matching_equal_maxima_and_all_neg_inf_rows():
    rel = np.array([[[NEG, 0.5, 0.5, 0.1],   # tie: the first maximum (1) wins
                     [0.5, NEG, 0.2, 0.5],   # tie: 0 wins, so 0-1 are mutual
                     [0.5, 0.2, NEG, 0.2],
                     [NEG, NEG, NEG, NEG]],  # all -inf: argmax 0, never accepted
                    [[NEG, 0.9, 0.9, 0.9],
                     [0.9, NEG, 0.9, 0.9],
                     [0.9, 0.9, NEG, 0.9],
                     [0.9, 0.9, 0.9, NEG]]], np.float32)
    members = np.array([[0, 1, 2, 3], [4, 5, 6, -1]])
    a, b, sel = _matching(rel, members, 0.0)
    assert sel.reshape(2, 4).tolist() == [[True, False, False, False],
                                          [True, False, False, False]]
    assert b.reshape(2, 4)[0, 0] == 1 and b.reshape(2, 4)[1, 0] == 5
    # θ is strict
    _, _, sel = _matching(rel, members, 0.5)
    assert not sel.reshape(2, 4)[0].any()


@pytest.mark.parametrize("seed", range(4))
def test_matching_random_ties(seed):
    rng = np.random.default_rng(seed)
    rel = rng.integers(0, 4, size=(6, 8, 8)).astype(np.float32) / 4  # many ties
    rel[rng.random(rel.shape) < 0.3] = NEG
    rel[:, np.arange(8), np.arange(8)] = NEG
    rel[0] = NEG
    members = rng.permutation(60)[:48].reshape(6, 8)
    members[rng.random(members.shape) < 0.1] = -1
    for theta in (0.0, 0.25, 0.5):
        _matching(rel, members, theta)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_apply_merges_on_reference_rounds(name):
    _, _, v, rows = reference_rounds(name)
    rng = np.random.default_rng(0)
    for row in rows[:4]:
        rs, ps = ref_state(row), port_state(row)
        alive = np.flatnonzero(row["size"] > 0)
        pick = rng.permutation(alive)[: 2 * (len(alive) // 4)]
        a, b = pick[0::2], pick[1::2]
        sel = rng.random(len(a)) < 0.7
        a_full = np.concatenate([a, [0, 1]])
        b_full = np.concatenate([b, [-1, 2]])
        sel_full = np.concatenate([sel, [False, False]])
        want, n_want = jax.jit(rmerge.apply_merges)(
            rs, jnp.asarray(a_full, jnp.int32), jnp.asarray(b_full, jnp.int32),
            jnp.asarray(sel_full))
        got, n_got = pmerge.apply_merges(ps, torch.as_tensor(a_full),
                                         torch.as_tensor(b_full), torch.as_tensor(sel_full))
        np.testing.assert_array_equal(np_(got.node2super), np_(want.node2super))
        np.testing.assert_array_equal(np_(got.size), np_(want.size))
        assert int(n_got) == int(n_want) and got.t == row["t"]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_rounds_take_the_reference_theta(name):
    """The port's engine feeds each round the reference's float32 θ."""
    _, _, _, rows = reference_rounds(name)
    rcfg, _ = configs(name)
    for row in rows:
        th = pengine.theta_schedule_host(row["t"], rcfg.T) if row["t"] <= rcfg.T else 0.0
        assert np.float32(th) == row["theta"]
