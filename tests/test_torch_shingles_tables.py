"""``repro_torch.core.shingles`` and ``tables`` against the reference on the
states of live reference runs: shingles, candidate groups (given the
reference's permutations), the top-D neighbor tables and the union-space
group tables. ``max_neighbors`` below the max degree exercises the top-D cut
and its ties, which the stable sort has to break as the reference does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import (
    CPU,
    FIXTURES,
    RTOL,
    configs,
    np_,
    port_state,
    ref_group_tables,
    ref_metrics,
    ref_neighbor_tables,
    ref_pair_table,
    ref_state,
    reference_rounds,
    replay,
)

from repro_torch.core import costs as pcosts
from repro_torch.core import shingles as pshingles
from repro_torch.core import tables as ptables
from repro_torch.core.convert import ReplayPermutations, group_tables_from_numpy

INT_FIELDS = ("n", "s", "m", "n_u", "cidx", "w", "members")


def _rows(name):
    rg, pg, v, rows = reference_rounds(name)
    return rg, pg, v, [rows[0], rows[len(rows) // 2], rows[-1]]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_shingles_and_groups(name):
    rg, pg, v, rows = _rows(name)
    _, pcfg = configs(name)
    for row in rows:
        h, tie = (jnp.asarray(x) for x in row["perms"])
        rs, ps = ref_state(row), port_state(row)
        th, ttie = (torch.as_tensor(x.astype(np.int64)) for x in row["perms"])
        # the reference's shingle passes, fed the same h
        want_f = h.at[rg.src].min(h[rg.dst]).at[rg.dst].min(h[rg.src])
        np.testing.assert_array_equal(np_(pshingles.node_shingles(pg.src, pg.dst, th)),
                                      np_(want_f))
        want_sh = jnp.full((v,), v, jnp.int32).at[rs.node2super].min(want_f)
        got_sh = pshingles.supernode_shingles(pg.src, pg.dst, ps, th)
        np.testing.assert_array_equal(np_(got_sh), np_(want_sh))
        # the reference's 3-key sort, fed the same tie permutation
        dead = (rs.size <= 0).astype(jnp.int32)
        ids = jnp.arange(v, dtype=jnp.int32)
        _, _, _, order = jax.lax.sort((dead, want_sh, tie, ids), num_keys=3)
        for c in (pcfg.group_size, 7):
            want = np.concatenate([np_(order), -np.ones((-v) % c, np.int32)]).reshape(-1, c)
            np.testing.assert_array_equal(
                np_(pshingles.chunk_groups(got_sh, ps.size, ttie, c)), want)
        groups = pshingles.build_groups(pg.src, pg.dst, ps, replay(row), pcfg.group_size)
        c = pcfg.group_size
        np.testing.assert_array_equal(
            np_(groups),
            np.concatenate([np_(order), -np.ones((-v) % c, np.int32)]).reshape(-1, c))


def test_torch_permutations_are_seeded_and_fresh():
    a = pshingles.TorchPermutations(5, "cpu")
    b = pshingles.TorchPermutations(5, "cpu")
    h1, t1 = a.draw(100, CPU)
    h2, t2 = b.draw(100, CPU)
    assert torch.equal(h1, h2) and torch.equal(t1, t2)
    assert sorted(h1.tolist()) == list(range(100))
    h3, _ = a.draw(100, CPU)
    assert not torch.equal(h1, h3)
    r = ReplayPermutations([(np.arange(4), np.arange(4)[::-1])])
    h, t = r.draw(4, CPU)
    assert h.tolist() == [0, 1, 2, 3] and t.tolist() == [3, 2, 1, 0]
    with pytest.raises(IndexError):
        r.draw(4, CPU)


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("max_neighbors", [64, 4])
def test_neighbor_tables(name, max_neighbors):
    rg, pg, v, rows = _rows(name)
    for row in rows:
        rs, ps = ref_state(row), port_state(row)
        rpt = ref_pair_table(rg.src, rg.dst, rs)
        ppt = pcosts.build_pair_table(pg.src, pg.dst, ps)
        deg = np.bincount(np_(rpt.lo)[np_(rpt.valid) & (np_(rpt.lo) != np_(rpt.hi))],
                          minlength=v)
        if max_neighbors == 4:
            assert deg.max() > max_neighbors  # the cut binds
        want = ref_neighbor_tables(rpt, v, max_neighbors)
        got = ptables.build_neighbor_tables(ppt, v, max_neighbors)
        for g, w, f in zip(got, want, ("nbr_id", "nbr_cnt", "self_cnt")):
            np.testing.assert_array_equal(np_(g), np_(w), err_msg=f)


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("max_neighbors,union_size", [(64, 128), (4, 16)])
def test_group_tables(name, max_neighbors, union_size):
    rg, pg, v, rows = _rows(name)
    rcfg, pcfg = configs(name)
    for row in rows:
        rs, ps = ref_state(row), port_state(row)
        rpt = ref_pair_table(rg.src, rg.dst, rs)
        ppt = pcosts.build_pair_table(pg.src, pg.dst, ps)
        rm = ref_metrics(rpt, rs, v, rg.num_edges)
        pm = pcosts.summary_metrics(ppt, ps, v, pg.num_edges)
        groups = pshingles.build_groups(pg.src, pg.dst, ps, replay(row), pcfg.group_size)
        want = ref_group_tables(rpt, rs, jnp.asarray(np_(groups).astype(np.int32)),
                                          max_neighbors, union_size, rm["cbar"], v)
        scal = torch.stack([pm["cbar"], pcosts.log2_f32(v, CPU)])
        got = ptables.build_group_tables(ppt, ps, groups, max_neighbors, union_size,
                                         scal, v)
        for f in INT_FIELDS:
            np.testing.assert_array_equal(np_(getattr(got, f)), np_(getattr(want, f)),
                                          err_msg=f)
        np.testing.assert_allclose(np_(got.t), np_(want.t), rtol=RTOL)
        assert got.cidx.dtype == torch.int32 and got.m.is_contiguous()
        # the reference's tables carried over give the same operands
        back = group_tables_from_numpy(*(np_(getattr(want, f)) for f in
                                         ("m", "n", "s", "t", "n_u", "cidx", "w",
                                          "members")), device=CPU)
        for f in INT_FIELDS:
            assert torch.equal(getattr(back, f).to(getattr(got, f).dtype),
                               getattr(got, f)), f
