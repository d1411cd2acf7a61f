"""The port's hybrid family (``repro_torch.models.mamba2``, ``zamba2``)
against the reference's on the CPU, on the reference's own smoke weights
carried across by ``lm_params_from_numpy``: the SSD block at one chunk and
at four-token chunks (the carried state), its decode step by step, zamba2's
forward and decode logits (float32 and bfloat16), the port's
decode-vs-forward, the parameter tree, and the full config's shapes and
bytes counted without allocating."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import mamba2 as ref_mamba2
from repro.models import zamba2 as ref_zamba2
from repro.models.api import build_model as ref_build_model
from repro.models.common import split_tree

from repro_torch import configs
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.models import mamba2, zamba2
from repro_torch.models.api import build_model, param_shapes
from repro_torch.models.common import param_bytes

from test_torch_lm import (BF16_ATOL, BF16_RTOL, RTOL, ATOL, N, _decode_both, _port_forward,
                           _ref_forward, carried)

torch.set_num_threads(1)

ARCH = "zamba2_7b"
# the reference's own decode-vs-forward tolerance (tests/test_decode_consistency.py)
DECODE_TOL = 2e-3


def block_inputs(arch, layer, seed=5, dtype="float32"):
    """(reference cfg, reference block params, port cfg, port block params,
    x [2, N, d] as numpy) for the block ``layer`` of the carried weights."""
    rcfg, _, rparams, pcfg, _, pparams, _ = carried(arch, dtype)
    x = np.random.default_rng(seed).standard_normal((2, N, rcfg.d_model)).astype(np.float32)
    return rcfg, rparams[layer], pcfg, pparams[layer], x


def ref_leaves(tree):
    """``{path: (shape, dtype name)}`` of a reference tree (arrays or
    ShapeDtypeStructs)."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): (tuple(x.shape), x.dtype.name) for p, x in leaves}


def ref_param_leaves(cfg):
    """The reference's parameter leaves for ``cfg``, without allocating."""
    values, _ = split_tree(jax.eval_shape(ref_build_model(cfg).init_px, jax.random.PRNGKey(0)))
    return ref_leaves(values)


def shape_leaves(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(shape_leaves(v, f"{path}['{k}']"))
        return out
    return {path: tuple(tree)}


def port_leaves(tree, path=""):
    """``{path: (shape, dtype name)}`` of a port tree, in ``ref_leaves``' form."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_leaves(v, f"{path}['{k}']"))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}


@pytest.mark.parametrize("chunk", [None, 4])
def test_ssd_forward_equals_the_reference(chunk):
    """One chunk of 12 tokens, and three chunks of 4 (the state carried across)."""
    rcfg, rp, pcfg, pp, x = block_inputs(ARCH, "ssm_0")
    want = np.asarray(ref_mamba2.ssd_forward(rp, jnp.asarray(x), rcfg, chunk=chunk))
    got = mamba2.ssd_forward(pp, torch.as_tensor(x), pcfg, chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_ssd_chunks_carry_the_state():
    """The port's own forward at chunk 4 equals its forward at one chunk: the
    carried [B, H, N, P] state stands in for the earlier chunks."""
    _, _, pcfg, pp, x = block_inputs(ARCH, "ssm_1")
    one = mamba2.ssd_forward(pp, torch.as_tensor(x), pcfg)
    for chunk in (4, 6, 3):
        torch.testing.assert_close(mamba2.ssd_forward(pp, torch.as_tensor(x), pcfg, chunk=chunk),
                                   one, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        mamba2.ssd_forward(pp, torch.as_tensor(x), pcfg, chunk=5)


def test_ssd_decode_step_by_step_equals_the_reference():
    rcfg, rp, pcfg, pp, x = block_inputs(ARCH, "ssm_0")
    rstate = ref_mamba2.init_ssm_state(rcfg, 2, jnp.float32)
    pstate = mamba2.init_ssm_state(pcfg, 2, torch.float32, "cpu")
    fwd = mamba2.ssd_forward(pp, torch.as_tensor(x), pcfg).numpy()
    for t in range(N):
        want, rstate = ref_mamba2.ssd_decode(rp, jnp.asarray(x[:, t:t + 1]), rcfg, rstate)
        got, pstate = mamba2.ssd_decode(pp, torch.as_tensor(x[:, t:t + 1]), pcfg, pstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(pstate["h"].numpy(), np.asarray(rstate["h"]), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(pstate["conv"].numpy(), np.asarray(rstate["conv"]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.numpy()[:, 0], fwd[:, t], rtol=RTOL, atol=ATOL)
    assert port_leaves(pstate) == ref_leaves(rstate)


def test_ssd_decode_keeps_the_reference_state_types_in_bfloat16():
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), dtype="bfloat16")
    state = mamba2.init_ssm_state(cfg, 2, torch.bfloat16, "cpu")
    p = build_model(cfg, "cpu").init(0)["ssm_0"]
    x = torch.randn(2, 1, cfg.d_model).to(torch.bfloat16)
    out, state = mamba2.ssd_decode(p, x, cfg, state)
    assert out.dtype == torch.bfloat16
    assert state["h"].dtype == torch.float32 and state["conv"].dtype == torch.bfloat16


def test_forward_logits_equal_the_reference():
    want, got = _ref_forward(ARCH), _port_forward(ARCH)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_decode_logits_equal_the_reference():
    want, got = _decode_both(ARCH)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_decode_matches_forward():
    fwd = _port_forward(ARCH)
    _, dec = _decode_both(ARCH)
    for t in range(N):
        np.testing.assert_allclose(dec[t], fwd[:, t], rtol=DECODE_TOL, atol=DECODE_TOL,
                                   err_msg=f"decode diverges from forward at {t}")


def test_bfloat16_forward_and_decode():
    np.testing.assert_allclose(_port_forward(ARCH, "bfloat16"), _ref_forward(ARCH, "bfloat16"),
                               rtol=BF16_RTOL, atol=BF16_ATOL)
    want, got = _decode_both(ARCH, "bfloat16")
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


def test_prefill_step_is_the_forwards_last_position():
    *_, pmodel, pparams, tokens = carried(ARCH)
    torch.testing.assert_close(
        pmodel.prefill_step(pparams, {"tokens": torch.as_tensor(tokens).long()}),
        torch.as_tensor(_port_forward(ARCH)[:, -1]), rtol=RTOL, atol=ATOL)


def test_shared_attention_sites_and_cache():
    """One shared block's weights at every site, a KV cache per site; 13
    sites at full depth (i = 5, 11, ..., 77)."""
    full = configs.get_config(ARCH)
    assert zamba2.attn_sites(full) == ref_zamba2.attn_sites(ref_configs.get_config(ARCH))
    assert zamba2.attn_sites(full) == list(range(5, 81, 6))
    cache = build_model(configs.get_smoke_config(ARCH), "cpu").init_cache(2, 16)
    ref_cache = ref_zamba2.init_cache(ref_configs.get_smoke_config(ARCH), 2, 16, jnp.float32)
    assert port_leaves(cache) == ref_leaves(ref_cache)


def test_lm_params_from_numpy_takes_the_tree_and_refuses_a_foreign_one():
    _, _, rparams, pcfg, _, pparams, _ = carried(ARCH, "bfloat16")
    tree = jax.tree.map(np.asarray, rparams)
    assert port_leaves(pparams) == ref_leaves(tree)  # each leaf in its own type
    assert pparams["ssm_0"]["a_log"].dtype == torch.float32
    assert pparams["ssm_0"]["in_proj"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="ssm_0"):
        lm_params_from_numpy(dict(tree, ssm_0={k: v for k, v in tree["ssm_0"].items()
                                                if k != "d_skip"}), pcfg, "cpu")
    xl = jax.tree.map(np.asarray, carried("xlstm_350m")[2])
    with pytest.raises(ValueError, match="the tree"):
        lm_params_from_numpy(xl, pcfg, "cpu")


def test_full_config_shapes_types_and_bytes():
    """zamba2-7b at 81 layers, counted without allocating: the port's tree of
    shapes is the reference's, and its bfloat16 tree (with float32 norms,
    a_log, dt_bias, d_skip) is 13,274,703,424 bytes."""
    check_full_config(ARCH, 13_274_703_424)


def check_full_config(arch, want_bytes):
    """The full config's shapes against the reference's, its bytes, and a
    seeded bfloat16 smoke model's leaf types and bytes against the reference's."""
    ref = ref_param_leaves(ref_configs.get_config(arch))
    assert shape_leaves(param_shapes(configs.get_config(arch))) == \
        {p: s for p, (s, _) in ref.items()}
    assert sum(int(np.prod(s)) * jnp.dtype(t).itemsize for s, t in ref.values()) == want_bytes
    small = dataclasses.replace(configs.get_smoke_config(arch), dtype="bfloat16")
    params = build_model(small, "cpu").init(0)
    rsmall = ref_param_leaves(dataclasses.replace(ref_configs.get_smoke_config(arch),
                                                  dtype="bfloat16"))
    assert port_leaves(params) == rsmall
    assert param_bytes(params) == sum(int(np.prod(s)) * jnp.dtype(t).itemsize
                                      for s, t in rsmall.values())
