"""``repro_torch.core.sparsify`` against ``repro.core.sparsify``: the
footnote-4 deltas, ξ, the drop rule and the whole drop-to-k pass (the drop
mask must be identical) on the states of live reference runs, across budgets
that leave nothing, something and everything to drop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import (
    FIXTURES,
    RTOL,
    np_,
    port_state,
    ref_pair_table,
    ref_state,
    reference_rounds,
)

from repro.core import costs as rcosts
from repro.core import sparsify as rsparsify

from repro_torch.core import costs as pcosts
from repro_torch.core import sparsify as psparsify

ref_further = jax.jit(rsparsify.further_sparsify, static_argnums=(2, 3),
                      static_argnames=("cbar_mode", "re_guard", "error_p"))


@pytest.mark.parametrize("error_p", [1, 2])
def test_deltas_xi_and_drop_rule(error_p):
    rng = np.random.default_rng(error_p)
    cnt = rng.poisson(4.0, size=3000).astype(np.float32) + 1
    pi = (cnt + rng.integers(0, 40, size=3000)).astype(np.float32)
    np.testing.assert_array_equal(
        np_(psparsify.sparsify_deltas(torch.as_tensor(cnt), torch.as_tensor(pi), error_p)),
        np_(rsparsify.sparsify_deltas(jnp.asarray(cnt), jnp.asarray(pi), error_p)))
    for size_bits, k_bits, s, w in ((1e5, 9e4, 300.0, 17.0), (1e5, 2e5, 3.0, 2.0),
                                    (5e6, 1.0, 1e5, 1000.0), (12345.5, 12000.25, 2.0, 2.0)):
        got = psparsify.sparsify_xi(torch.tensor(size_bits), torch.tensor(k_bits),
                                    torch.tensor(s), torch.tensor(w))
        want = rsparsify.sparsify_xi(jnp.float32(size_bits), jnp.float32(k_bits),
                                     jnp.float32(s), jnp.float32(w))
        assert int(got) == int(want)
    keep = rng.random(3000) < 0.6
    delta = rng.normal(size=3000).astype(np.float32)
    for xi, p_count, thr in ((0, 1800, 0.1), (10, 1800, -1.0), (1800, 1800, 0.0),
                             (5000, 1800, 0.5)):
        got = psparsify.drop_from_threshold(torch.as_tensor(keep), torch.as_tensor(delta),
                                            torch.tensor(thr), torch.tensor(xi),
                                            torch.tensor(p_count))
        want = rsparsify.drop_from_threshold(jnp.asarray(keep), jnp.asarray(delta),
                                             jnp.float32(thr), jnp.int32(xi),
                                             jnp.int32(p_count))
        np.testing.assert_array_equal(np_(got), np_(want))


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("k_frac", [0.05, 0.2, 0.3, 2.0])
@pytest.mark.parametrize("error_p", [1, 2])
def test_further_sparsify(name, k_frac, error_p):
    rg, pg, v, rows = reference_rounds(name)
    size_g = rcosts.input_size_bits(v, rg.num_edges)
    for row in (rows[len(rows) // 2], rows[-1]):
        rs, ps = ref_state(row), port_state(row)
        rpt = ref_pair_table(rg.src, rg.dst, rs)
        ppt = pcosts.build_pair_table(pg.src, pg.dst, ps)
        k_bits = k_frac * size_g
        drop_w, after_w = ref_further(rpt, rs, v, rg.num_edges, k_bits, error_p=error_p)
        drop_g, after_g = psparsify.further_sparsify(ppt, ps, v, pg.num_edges, k_bits,
                                                     error_p=error_p)
        np.testing.assert_array_equal(np_(drop_g), np_(drop_w))
        np.testing.assert_array_equal(np_(after_g["keep"]), np_(after_w["keep"]))
        for k in ("num_superedges", "num_supernodes", "omega_max"):
            assert float(after_g[k]) == float(after_w[k]), k
        for k in ("size_bits", "re1", "re2", "mdl_cost"):
            np.testing.assert_allclose(float(after_g[k]), float(after_w[k]), rtol=RTOL,
                                       err_msg=k)
