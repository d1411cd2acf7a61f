"""Shared fixtures of the port's parity tests: the reference (``repro``, JAX)
run live on the same inputs as the port (``repro_torch``, CPU), plus checks
that the fixtures themselves reproduce the reference.

Both packages get the same numpy arrays. The reference's per-round
permutations are rebuilt from its key chain, which does not depend on the
state: ``PRNGKey(seed)``, then each round ``rng, k = split(rng)``,
``k_shingle, k_tie = split(k)``, ``h = permutation(k_shingle, V)`` and
``tie = permutation(k_tie, V)``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import costs as rcosts
from repro.core import merge as rmerge
from repro.core import shingles as rshingles
from repro.core import tables as rtables
from repro.core import types as rtypes
from repro.core.engine import theta_schedule_host
from repro.graphs import generate as rgenerate

from repro_torch.core import shingles as pshingles
from repro_torch.core import types as ptypes
from repro_torch.core.convert import ReplayPermutations, state_from_numpy
from repro_torch.graphs import generate

# Small tensors on a shared CPU: extra intra-op threads only add overhead.
torch.set_num_threads(1)

CPU = torch.device("cpu")

# The golden fixture's graph and config, and one rmat graph.
FIXTURES = {
    "ego-facebook": dict(dataset="ego-facebook", gen_seed=0, scale=0.08,
                         T=10, k_frac=0.3, seed=1),
    "caida": dict(dataset="caida", gen_seed=0, scale=0.02,
                  T=10, k_frac=0.3, seed=1),
}

# Float tolerances of the reference's own kernel tests (tests/test_kernels.py).
RTOL = 1e-5
ATOL_RED = 1e-3
ATOL_REL = 1e-4


@functools.lru_cache(maxsize=None)
def graph(name: str):
    fx = FIXTURES[name]
    src, dst, v = generate(fx["dataset"], seed=fx["gen_seed"], scale=fx["scale"])
    return src, dst, v


def configs(name: str, **over):
    fx = FIXTURES[name]
    kw = dict(T=fx["T"], k_frac=fx["k_frac"], seed=fx["seed"])
    kw.update(over)
    return rtypes.SummaryConfig(**kw), ptypes.SummaryConfig(**kw)


def perm_chain(seed: int, num_nodes: int, rounds: int) -> list:
    """The reference's ``(h, tie)`` for each of its first ``rounds`` rounds."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(rounds):
        rng, k = jax.random.split(rng)
        k_shingle, k_tie = jax.random.split(k)
        out.append((np.asarray(jax.random.permutation(k_shingle, num_nodes)),
                    np.asarray(jax.random.permutation(k_tie, num_nodes))))
    return out


@functools.partial(jax.jit, static_argnames=("cfg",))
def _ref_round(src, dst, state, cfg, theta):
    return rmerge.merge_iteration(src, dst, state, cfg, theta)


@functools.lru_cache(maxsize=None)
def reference_rounds(name: str):
    """The rounds of a live reference run, walked as its engine walks them.

    Returns ``(ref_graph, port_graph, v, rows)``; each row holds the state
    before the round (numpy), θ (float32), the round's ``(h, tie)``, the
    reference's stats (floats) and the state after the round. The rounds
    stop where ``SummaryEngine.run`` stops (``driver_chunk=1``), and the
    ``ensure_budget`` θ = 0 rounds are included.
    """
    src, dst, v = graph(name)
    rcfg, _ = configs(name)
    rg, _ = rtypes.make_graph(src, dst, v)
    pg, _ = ptypes.make_graph(src, dst, v, CPU)
    k_bits = rcfg.target_bits(rcosts.input_size_bits(v, rg.num_edges))
    chain = perm_chain(rcfg.seed, v, rcfg.T + rcfg.max_extra_iters)
    state = rtypes.init_state(v, rcfg.seed)
    rows = []

    def step(theta):
        nonlocal state
        t = len(rows) + 1
        new_state, stats = _ref_round(rg.src, rg.dst, state, rcfg, jnp.float32(theta))
        rows.append(dict(
            t=t, theta=np.float32(theta), perms=chain[t - 1],
            node2super=np.asarray(state.node2super), size=np.asarray(state.size),
            stats={k: float(x) for k, x in stats.items()},
            next_node2super=np.asarray(new_state.node2super),
            next_size=np.asarray(new_state.size),
        ))
        state = new_state
        return rows[-1]["stats"]

    for t in range(1, rcfg.T + 1):
        theta = theta_schedule_host(t, rcfg.T)
        st = step(theta)
        if st["size_bits"] <= k_bits or (st["nmerges"] == 0 and theta == 0.0):
            break
    for _ in range(rcfg.max_extra_iters):
        s_now = int(np.sum(np.asarray(state.size) > 0))
        if v * float(np.log2(max(s_now, 2))) <= k_bits or s_now <= 2:
            break
        if step(0.0)["nmerges"] == 0:
            break
    return rg, pg, v, rows


# The reference's functions, jitted: op-by-op dispatch compiles every op.
ref_pair_table = jax.jit(rcosts.build_pair_table)
ref_metrics = jax.jit(rcosts.summary_metrics, static_argnums=(2, 3),
                      static_argnames=("cbar_mode", "re_guard"))
ref_neighbor_tables = jax.jit(rtables.build_neighbor_tables, static_argnums=(1, 2))
ref_group_tables = jax.jit(rtables.build_group_tables, static_argnums=(3, 4, 6))


def ref_state(row) -> rtypes.SummaryState:
    """The reference's state before ``row``'s round (rng unused by callers)."""
    return rtypes.SummaryState(node2super=jnp.asarray(row["node2super"]),
                               size=jnp.asarray(row["size"]),
                               rng=jax.random.PRNGKey(0),
                               t=jnp.int32(row["t"]))


def port_state(row) -> ptypes.SummaryState:
    return state_from_numpy(row["node2super"], row["size"], row["t"], CPU)


def replay(row) -> ReplayPermutations:
    return ReplayPermutations([row["perms"]])


def np_(x):
    """numpy view of a torch or jax array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_gain_close(rel_got, red_got, rel_want, red_want):
    """rel/red at the reference's tolerances, with identical -inf masks."""
    rel_got, red_got, rel_want, red_want = map(np_, (rel_got, red_got, rel_want, red_want))
    np.testing.assert_allclose(red_got, red_want, rtol=RTOL, atol=ATOL_RED)
    fin_got, fin_want = np.isfinite(rel_got), np.isfinite(rel_want)
    np.testing.assert_array_equal(fin_got, fin_want)
    np.testing.assert_array_equal(np.isneginf(rel_got), np.isneginf(rel_want))
    np.testing.assert_allclose(rel_got[fin_got], rel_want[fin_want],
                               rtol=RTOL, atol=ATOL_REL)


# ---------------------------------------------------------------------------
# The fixtures reproduce the reference
# ---------------------------------------------------------------------------


def test_generators_give_the_reference_edges():
    for name, fx in FIXTURES.items():
        src, dst, v = graph(name)
        rsrc, rdst, rv = rgenerate(fx["dataset"], seed=fx["gen_seed"], scale=fx["scale"])
        assert v == rv
        np.testing.assert_array_equal(src, rsrc)
        np.testing.assert_array_equal(dst, rdst)


def test_perm_chain_reproduces_reference_groups():
    """The rebuilt key chain gives the groups the reference draws itself."""
    rg, pg, v, rows = reference_rounds("ego-facebook")
    rcfg, _ = configs("ego-facebook")
    rng = jax.random.PRNGKey(rcfg.seed)
    for row in rows[:3]:
        rng, k_groups = jax.random.split(rng)
        want = rshingles.build_groups(rg.src, rg.dst, ref_state(row), k_groups,
                                      rcfg.group_size)
        groups = pshingles.build_groups(pg.src, pg.dst, port_state(row), replay(row),
                                        rcfg.group_size)
        np.testing.assert_array_equal(np_(groups), np_(want))


@functools.lru_cache(maxsize=None)
def reference_result(name: str):
    """The live reference ``repro.core.summarize`` on a fixture."""
    from repro.core import summarize as rsummarize

    src, dst, v = graph(name)
    rcfg, _ = configs(name)
    return rsummarize(src, dst, v, rcfg)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reference_rounds_follow_the_live_run(name):
    """Stepping the reference round by round reproduces its own summarize."""
    res = reference_result(name)
    _, _, _, rows = reference_rounds(name)
    assert len(res.history) == len(rows)
    for h, row in zip(res.history, rows):
        assert np.float32(h["theta"]) == row["theta"]
        for k in ("nmerges", "num_supernodes", "num_superedges", "size_bits"):
            assert h[k] == row["stats"][k], (row["t"], k)
