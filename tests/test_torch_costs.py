"""``repro_torch.core.costs`` against ``repro.core.costs`` on the states of
short live reference runs (the golden fixture and an rmat graph): the pair
table, Π, the Eq. 2/4/14 metrics, the keep mask and the exact per-supernode
totals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import (
    ATOL_REL,
    CPU,
    FIXTURES,
    RTOL,
    np_,
    port_state,
    ref_metrics,
    ref_pair_table,
    ref_state,
    reference_rounds,
)

from repro.core import costs as rcosts

from repro_torch.core import costs as pcosts
from repro_torch.core.types import PairTable
from repro_torch.utils import f32math

METRIC_INTS = ("num_supernodes", "num_superedges", "omega_max")
METRIC_FLOATS = ("size_bits", "mdl_cost", "re1", "re2", "cbar", "membership_bits")


def _rows(name):
    rg, pg, v, rows = reference_rounds(name)
    # the first, a middle and the last state of the run
    return rg, pg, v, [rows[0], rows[len(rows) // 2], rows[-1]]


def _assert_pair_table(ppt, rpt):
    for f in ("lo", "hi", "cnt", "valid"):
        np.testing.assert_array_equal(np_(getattr(ppt, f)), np_(getattr(rpt, f)),
                                      err_msg=f)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_pair_table_and_pi(name):
    rg, pg, v, rows = _rows(name)
    for row in rows:
        rs, ps = ref_state(row), port_state(row)
        rpt = ref_pair_table(rg.src, rg.dst, rs)
        ppt = pcosts.build_pair_table(pg.src, pg.dst, ps)
        _assert_pair_table(ppt, rpt)
        assert ppt.lo.dtype == torch.int64 and ppt.cnt.dtype == torch.float32
        np.testing.assert_array_equal(np_(pcosts.pair_pi(ppt, ps.size)),
                                      np_(rcosts.pair_pi(rpt, rs.size)))


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("cbar_mode", ["tight", "paper"])
@pytest.mark.parametrize("re_guard", [0, 1])
def test_summary_metrics(name, cbar_mode, re_guard):
    rg, pg, v, rows = _rows(name)
    for row in rows:
        rs, ps = ref_state(row), port_state(row)
        rpt = ref_pair_table(rg.src, rg.dst, rs)
        ppt = pcosts.build_pair_table(pg.src, pg.dst, ps)
        want = ref_metrics(rpt, rs, v, rg.num_edges, cbar_mode=cbar_mode,
                                      re_guard=re_guard)
        got = pcosts.summary_metrics(ppt, ps, v, pg.num_edges, cbar_mode=cbar_mode,
                                     re_guard=re_guard)
        np.testing.assert_array_equal(np_(got["keep"]), np_(want["keep"]))
        for k in METRIC_INTS:
            assert float(got[k]) == float(want[k]), k
        for k in METRIC_FLOATS:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, err_msg=k)
        # a drop mask removes exactly its superedges
        drop = np_(want["keep"]) & (np.arange(len(np_(want["keep"]))) % 3 == 0)
        want_d = ref_metrics(rpt, rs, v, rg.num_edges, cbar_mode=cbar_mode,
                                        re_guard=re_guard, drop_mask=jnp.asarray(drop))
        got_d = pcosts.summary_metrics(ppt, ps, v, pg.num_edges, cbar_mode=cbar_mode,
                                       re_guard=re_guard, drop_mask=torch.as_tensor(drop))
        np.testing.assert_array_equal(np_(got_d["keep"]), np_(want_d["keep"]))
        np.testing.assert_allclose(float(got_d["size_bits"]), float(want_d["size_bits"]),
                                   rtol=RTOL)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_supernode_total_costs(name):
    rg, pg, v, rows = _rows(name)
    for row in rows:
        rs, ps = ref_state(row), port_state(row)
        rpt = ref_pair_table(rg.src, rg.dst, rs)
        ppt = pcosts.build_pair_table(pg.src, pg.dst, ps)
        pm = pcosts.summary_metrics(ppt, ps, v, pg.num_edges)
        log2v = jnp.log2(jnp.float32(v))
        # one C̄ for both, so that the totals alone are compared
        want = rcosts.supernode_total_costs(rpt, rcosts.pair_pi(rpt, rs.size),
                                            jnp.float32(float(pm["cbar"])), log2v, v)
        scal = torch.stack([pm["cbar"], pcosts.log2_f32(v, CPU)])
        got = pcosts.supernode_total_costs(ppt, pcosts.pair_pi(ppt, ps.size), scal, v)
        # the same float32 arithmetic in the same order: bit for bit on the CPU
        np.testing.assert_array_equal(np_(got), np_(want))


def test_elementwise_costs_and_scalars():
    rng = np.random.default_rng(0)
    cnt = rng.poisson(3.0, size=4000).astype(np.float32)
    pi = (cnt + rng.integers(0, 50, size=4000)).astype(np.float32)
    pi[:10] = 0.0
    cbar, log2v = 30.0, 12.0
    jc, jp = jnp.asarray(cnt), jnp.asarray(pi)
    tc, tp = torch.as_tensor(cnt), torch.as_tensor(pi)
    tcb, tlv = torch.tensor(cbar), torch.tensor(log2v)
    np.testing.assert_array_equal(np_(pcosts.entropy_bits(tc, tp)),
                                  np_(rcosts.entropy_bits(jc, jp)))
    np.testing.assert_array_equal(np_(pcosts.explicit_bits(tc, tlv)),
                                  np_(rcosts.explicit_bits(jc, jnp.float32(log2v))))
    np.testing.assert_allclose(np_(pcosts.pair_cost_star(tc, tp, tcb, tlv)),
                               np_(rcosts.pair_cost_star(jc, jp, jnp.float32(cbar),
                                                         jnp.float32(log2v))),
                               rtol=RTOL, atol=ATOL_REL)
    for guard in (0, 1, 2):
        np.testing.assert_array_equal(
            np_(pcosts.keep_superedge(tc, tp, tcb, tlv, guard)),
            np_(rcosts.keep_superedge(jc, jp, jnp.float32(cbar), jnp.float32(log2v), guard)))
    for v, e in ((323, 6277), (1024, 2135), (2_097_152, 11_095_298)):
        assert pcosts.input_size_bits(v, e) == rcosts.input_size_bits(v, e)
        for s_count, w in ((2.0, 2.0), (311.0, 17.0), (1e6, 3.0)):
            for mode in ("tight", "paper"):
                np.testing.assert_allclose(
                    float(pcosts.cbar_value(mode, v, e, torch.tensor(s_count),
                                            torch.tensor(w))),
                    float(rcosts.cbar_value(mode, v, e, jnp.float32(s_count),
                                            jnp.float32(w))), rtol=RTOL)


def test_log2_rounds_as_the_reference():
    """f32math.log2 gives jnp.log2's float32 results bit for bit."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.random(50_000), rng.uniform(1, 1e7, 50_000),
                        np.arange(1, 70_000), [1e-38, 1.0, 2.0, 0.5]]).astype(np.float32)
    np.testing.assert_array_equal(np_(f32math.log2(torch.as_tensor(x))),
                                  np.asarray(jnp.log2(jnp.asarray(x))))
    assert float(f32math.log2(torch.tensor(0.0))) == float("-inf")


def test_pair_table_capacity_rows_are_masked():
    rg, pg, v, rows = _rows("ego-facebook")
    ppt = pcosts.build_pair_table(pg.src, pg.dst, port_state(rows[-1]))
    assert isinstance(ppt, PairTable) and ppt.capacity == pg.num_edges
    valid = np_(ppt.valid)
    n = int(valid.sum())
    assert valid[:n].all() and not valid[n:].any()
    assert (np_(ppt.cnt)[n:] == 0).all() and (np_(ppt.cnt)[:n] > 0).all()
