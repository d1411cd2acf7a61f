"""The port's MoE block (``repro_torch.models.moe``) against the reference's
GSPMD path (``repro.models.moe.apply_moe_gspmd``) on the CPU, on the
reference's own weights: both smoke configs (granite pads 5 experts to 6,
moonshot 4 to 16), at a decode shape (dropless), a prefill shape at the
default capacity factor (records dropped) and at capacity factor 8; the
router's ties and padded experts; the fixed-order combine against XLA:CPU's
scatter-add bit for bit; dropped records against an expert output of NaN."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import moe as ref_moe

from repro_torch import configs
from repro_torch.models import moe

torch.set_num_threads(1)

ARCHS = ["granite_moe_3b_a800m", "moonshot_v1_16b_a3b"]
# float32: the two sides add the expert products' terms in other orders (XLA's
# dot, torch's bmm); measured differences are below 1e-6 at |y| ~ 1.
RTOL = ATOL = 1e-5
AUX_RTOL = 1e-6
# (batch shape, capacity factor): decode-shaped (s = 1, dropless), prefill
# at the config's capacity factor (records dropped), prefill at cf 8 (none)
SHAPES = {"decode": ((6, 1), None), "prefill": ((4, 32), None), "prefill_cf8": ((4, 32), 8.0)}


@functools.lru_cache(maxsize=None)
def weights(arch: str, seed: int = 1):
    """The reference's ``init_moe`` weights (float32) as numpy arrays."""
    p = ref_moe.init_moe(jax.random.PRNGKey(seed), ref_configs.get_smoke_config(arch),
                         jnp.float32)
    return {k: np.array(getattr(v, "value", v)) for k, v in p.items()}


def _inputs(arch, shape, seed=0):
    """Normal activations around one shared direction, as hidden states sit,
    so that the router favours some experts and the capacity binds."""
    d = configs.get_smoke_config(arch).d_model
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((*shape, d)) + rng.standard_normal(d)).astype(np.float32)


def _both(arch, p, x, cf=None):
    """(reference y, aux) and (port y, aux), as numpy."""
    rcfg, pcfg = ref_configs.get_smoke_config(arch), configs.get_smoke_config(arch)
    ry, raux = jax.jit(lambda p, x: ref_moe.apply_moe_gspmd(p, x, rcfg, None, cf))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    py, paux = moe.apply_moe(
        {k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x), pcfg, cf)
    ref = (np.asarray(ry), {k: np.asarray(v) for k, v in raux.items()})
    return ref, (py.numpy(), {k: v.numpy() for k, v in paux.items()})


@pytest.mark.parametrize("case", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_block_equals_the_reference(arch, case):
    shape, cf = SHAPES[case]
    (ry, raux), (py, paux) = _both(arch, weights(arch), _inputs(arch, shape), cf)
    assert py.shape == ry.shape and py.dtype == np.float32
    np.testing.assert_allclose(py, ry, rtol=RTOL, atol=ATOL)
    assert paux["moe_drop_frac"] == raux["moe_drop_frac"]  # exact
    np.testing.assert_allclose(paux["moe_aux"], raux["moe_aux"], rtol=AUX_RTOL)
    if case == "prefill":  # the case is there to drop records
        assert raux["moe_drop_frac"] > 0
    else:
        assert raux["moe_drop_frac"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_router_equals_the_reference(arch):
    """Probabilities, the chosen experts (exactly) and their weights."""
    cfg = configs.get_smoke_config(arch)
    p = weights(arch)
    xt = _inputs(arch, (64,))
    rprobs = ref_moe._router_probs(jnp.asarray(p["router"]), jnp.asarray(xt),
                                   cfg.moe.num_experts)
    rw, re = jax.lax.top_k(rprobs, cfg.moe.top_k)
    rw = rw / jnp.maximum(jnp.sum(rw, axis=-1, keepdims=True), 1e-9)
    probs, w, e = moe.route(torch.as_tensor(p["router"]), torch.as_tensor(xt),
                            cfg.moe.num_experts, cfg.moe.top_k)
    np.testing.assert_allclose(probs.numpy(), np.asarray(rprobs), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(e.numpy(), np.asarray(re))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-6)
    assert (e < cfg.moe.num_experts).all()
    assert (probs[:, cfg.moe.num_experts:] == 0).all()  # padded experts: an exact 0


@pytest.mark.parametrize("arch", ARCHS)
def test_ties_go_to_the_lower_expert_as_lax_top_k(arch):
    """A zero router gives every real expert the same probability: experts
    0..k-1 are chosen, as ``lax.top_k`` chooses them, and never a padded one."""
    cfg = configs.get_smoke_config(arch)
    e_real, e_pad, k = cfg.moe.num_experts, cfg.moe.experts_padded(16), cfg.moe.top_k
    assert e_pad > e_real
    xt = _inputs(arch, (16,))
    zero = np.zeros((cfg.d_model, e_pad), np.float32)
    probs, w, e = moe.route(torch.as_tensor(zero), torch.as_tensor(xt), e_real, k)
    _, re = jax.lax.top_k(ref_moe._router_probs(jnp.asarray(zero), jnp.asarray(xt), e_real), k)
    np.testing.assert_array_equal(e.numpy(), np.asarray(re))
    np.testing.assert_array_equal(e.numpy(), np.broadcast_to(np.arange(k), (16, k)))
    assert (probs[:, :e_real] == probs[0, 0]).all() and (probs[:, e_real:] == 0).all()
    np.testing.assert_allclose(w.numpy(), 1.0 / k, rtol=1e-6)
    # the whole block with a zero router against the reference's
    p = dict(weights(arch), router=zero)
    (ry, raux), (py, paux) = _both(arch, p, _inputs(arch, (4, 32)))
    np.testing.assert_allclose(py, ry, rtol=RTOL, atol=ATOL)
    assert paux["moe_drop_frac"] == raux["moe_drop_frac"] > 0  # k experts hold every record


@pytest.mark.parametrize("n,k,d", [(7, 1, 3), (24, 3, 5), (40, 8, 16)])
def test_combine_equals_xla_scatter_add_bit_for_bit(n, k, d):
    """Every row named k times in a random order, values across many
    magnitudes (so the order of the adds shows in the last bits)."""
    rng = np.random.default_rng(n * k)
    index = rng.permutation(np.repeat(np.arange(n), k)).astype(np.int32)
    values = (rng.standard_normal((n * k, d))
              * 10.0 ** rng.integers(-6, 7, (n * k, 1))).astype(np.float32)
    want = np.asarray(jnp.zeros((n, d), jnp.float32).at[jnp.asarray(index)].add(
        jnp.asarray(values)))
    got = moe.combine_in_order(torch.as_tensor(values), torch.as_tensor(index).long(), n, k)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    if k >= 3:  # the reverse order of adds is another float32 result on these values
        rev = np.zeros((n, d), np.float32)
        for i in reversed(range(n * k)):
            rev[index[i]] += values[i]
        assert not np.array_equal(rev, want)


def test_dropped_records_add_an_exact_zero():
    """An expert whose outputs are NaN: a dropped record reads a live bucket
    row (the clamped gather) and must add 0, not NaN, as the reference's
    select does; tokens never routed to that expert stay finite."""
    arch = "granite_moe_3b_a800m"
    p = dict(weights(arch))
    p["wo"] = p["wo"].copy()
    p["wo"][0] = np.nan
    (ry, raux), (py, _) = _both(arch, p, _inputs(arch, (4, 32)))
    assert raux["moe_drop_frac"] > 0
    np.testing.assert_array_equal(np.isnan(py), np.isnan(ry))
    assert np.isfinite(ry).any() and np.isnan(ry).any()
    ok = ~np.isnan(ry)
    np.testing.assert_allclose(py[ok], ry[ok], rtol=RTOL, atol=ATOL)
