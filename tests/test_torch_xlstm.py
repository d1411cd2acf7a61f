"""The port's xLSTM family (``repro_torch.models.xlstm``) against the
reference's on the CPU, on the reference's own smoke weights carried across
by ``lm_params_from_numpy``: the mLSTM block at one chunk and at three (the
carried C and n states) and its decode step by step, the sLSTM block and
its decode, the LM's forward and decode logits (float32 and bfloat16), the
port's decode-vs-forward at the reference's 2e-3 (the forward's global
stabiliser against decode's running one), the parameter tree, the state's
bytes and the full config counted without allocating."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import xlstm as ref_xlstm

from repro_torch import configs
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.models import xlstm
from repro_torch.models.api import build_model
from repro_torch.models.common import param_bytes

from test_torch_hybrid import (DECODE_TOL, block_inputs, check_full_config, port_leaves,
                               ref_leaves)
from test_torch_lm import (BF16_ATOL, BF16_RTOL, RTOL, ATOL, N, _decode_both, _port_forward,
                           _ref_forward, carried)

torch.set_num_threads(1)

ARCH = "xlstm_350m"


def _step_by_step(ref_fn, port_fn, rp, pp, rcfg, pcfg, x, rstate, pstate):
    """Both decode functions over every position of ``x``; the outputs agree
    to 1e-5, and so does every leaf of the state after each step."""
    outs = []
    for t in range(x.shape[1]):
        want, rstate = ref_fn(rp, jnp.asarray(x[:, t:t + 1]), rcfg, rstate)
        got, pstate = port_fn(pp, torch.as_tensor(x[:, t:t + 1]), pcfg, pstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        for k in rstate:
            np.testing.assert_allclose(pstate[k].numpy(), np.asarray(rstate[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"state {k} at {t}")
        outs.append(got.numpy()[:, 0])
    assert port_leaves(pstate) == ref_leaves(rstate)
    return np.stack(outs, axis=1)


@pytest.mark.parametrize("chunk", [256, 4])
def test_mlstm_forward_equals_the_reference(chunk):
    """One chunk of 12 tokens (the default 256, cut to S), and three of 4."""
    rcfg, rp, pcfg, pp, x = block_inputs(ARCH, "layer_0")
    want = np.asarray(ref_xlstm.mlstm_forward(rp, jnp.asarray(x), rcfg, chunk=chunk))
    got = xlstm.mlstm_forward(pp, torch.as_tensor(x), pcfg, chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_mlstm_chunks_carry_the_state():
    _, _, pcfg, pp, x = block_inputs(ARCH, "layer_2")
    one = xlstm.mlstm_forward(pp, torch.as_tensor(x), pcfg)
    for chunk in (4, 6, 2):
        torch.testing.assert_close(xlstm.mlstm_forward(pp, torch.as_tensor(x), pcfg,
                                                       chunk=chunk), one, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        xlstm.mlstm_forward(pp, torch.as_tensor(x), pcfg, chunk=5)


def test_mlstm_decode_step_by_step_equals_the_reference():
    rcfg, rp, pcfg, pp, x = block_inputs(ARCH, "layer_0")
    dec = _step_by_step(ref_xlstm.mlstm_decode, xlstm.mlstm_decode, rp, pp, rcfg, pcfg, x,
                        ref_xlstm.init_mlstm_state(rcfg, 2),
                        xlstm.init_mlstm_state(pcfg, 2, "cpu"))
    fwd = xlstm.mlstm_forward(pp, torch.as_tensor(x), pcfg).numpy()
    np.testing.assert_allclose(dec, fwd, rtol=DECODE_TOL, atol=DECODE_TOL)


def test_slstm_forward_equals_the_reference():
    rcfg, rp, pcfg, pp, x = block_inputs(ARCH, "layer_1")
    want = np.asarray(ref_xlstm.slstm_forward(rp, jnp.asarray(x), rcfg))
    got = xlstm.slstm_forward(pp, torch.as_tensor(x), pcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_slstm_decode_step_by_step_equals_the_reference():
    rcfg, rp, pcfg, pp, x = block_inputs(ARCH, "layer_1")
    dec = _step_by_step(ref_xlstm.slstm_decode, xlstm.slstm_decode, rp, pp, rcfg, pcfg, x,
                        ref_xlstm.init_slstm_state(rcfg, 2),
                        xlstm.init_slstm_state(pcfg, 2, "cpu"))
    # the sLSTM forward is the same recurrence step by step
    fwd = xlstm.slstm_forward(pp, torch.as_tensor(x), pcfg).numpy()
    np.testing.assert_allclose(dec, fwd, rtol=RTOL, atol=ATOL)


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
    """Against the reference run op by op, as its forward runs here: each op
    rounds to bfloat16 where the code says, as the port's eager ops do. The
    reference's jitted decode keeps XLA's fused chains in float32 and parts
    from its own op-by-op decode by 0.0215 at logits below 0.6 on these
    weights (measured), past the bfloat16 tolerance; the port parts from the
    op-by-op decode by 0.0044, as its forward does."""
    np.testing.assert_allclose(_port_forward(ARCH, "bfloat16"), _ref_forward(ARCH, "bfloat16"),
                               rtol=BF16_RTOL, atol=BF16_ATOL)
    want, got = _decode_both(ARCH, "bfloat16", jit=False)
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


def test_prefill_step_is_the_forwards_last_position():
    *_, pmodel, pparams, tokens = carried(ARCH)
    torch.testing.assert_close(
        pmodel.prefill_step(pparams, {"tokens": torch.as_tensor(tokens).long()}),
        torch.as_tensor(_port_forward(ARCH)[:, -1]), rtol=RTOL, atol=ATOL)


def test_cache_is_the_references_and_ignores_positions():
    """Both stabilisers start at -30; the decode step takes no position."""
    pcfg, rcfg = configs.get_smoke_config(ARCH), ref_configs.get_smoke_config(ARCH)
    cache = build_model(pcfg, "cpu").init_cache(2, 16)
    assert port_leaves(cache) == ref_leaves(ref_xlstm.init_xlstm_cache(rcfg, 2, 16))
    assert (cache["layer_0"]["m"] == -30.0).all() and (cache["layer_1"]["m"] == -30.0).all()
    *_, pmodel, pparams, tokens = carried(ARCH)
    batch = {"token": torch.as_tensor(tokens[:, 0]).long(), "cache": cache}
    a, _ = pmodel.serve_step(pparams, dict(batch, pos=torch.tensor(0),
                                           cache=pmodel.init_cache(2, 16)))
    b, _ = pmodel.serve_step(pparams, dict(batch, pos=torch.tensor(9),
                                           cache=pmodel.init_cache(2, 16)))
    assert torch.equal(a, b)


def test_state_bytes_at_full_width():
    """xlstm-350m's recurrent state at 8 slots: 12 mLSTM layers of
    C [4, 512, 512], n, m and 12 sLSTM layers of c, n, h, m [4, 256], all
    float32: 405,014,016 bytes, whatever the sequence length."""
    cfg = configs.get_config(ARCH)
    shapes = jax.eval_shape(lambda: ref_xlstm.init_xlstm_cache(
        ref_configs.get_config(ARCH), 8, 128))
    want = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(shapes))
    assert want == 405_014_016
    small = configs.get_smoke_config(ARCH)
    assert param_bytes(build_model(small, "cpu").init_cache(8, 128)) == sum(
        x.size * x.dtype.itemsize for x in jax.tree.leaves(jax.eval_shape(
            lambda: ref_xlstm.init_xlstm_cache(ref_configs.get_smoke_config(ARCH), 8, 128))))
    assert xlstm.mlstm_dims(cfg) == (1024, 2048, 4, 512) and xlstm.slstm_dims(cfg) == (1024, 4,
                                                                                       256)


def test_lm_params_from_numpy_takes_the_tree_and_refuses_a_foreign_one():
    _, _, rparams, pcfg, _, pparams, _ = carried(ARCH, "bfloat16")
    tree = jax.tree.map(np.asarray, rparams)
    assert port_leaves(pparams) == ref_leaves(tree)  # each leaf in its own type
    for k in ("w_if", "b_if"):
        assert pparams["layer_0"][k].dtype == torch.float32
    for k in ("r", "b"):
        assert pparams["layer_1"][k].dtype == torch.float32
    assert pparams["layer_1"]["w_in"].dtype == torch.bfloat16
    bad = dict(tree, layer_1=dict(tree["layer_1"], r=tree["layer_1"]["r"][:, :, :-1]))
    with pytest.raises(ValueError, match="layer_1/r"):
        lm_params_from_numpy(bad, pcfg, "cpu")
    # an mLSTM block where the port takes an sLSTM one
    with pytest.raises(ValueError, match="layer_1"):
        lm_params_from_numpy(dict(tree, layer_1=tree["layer_0"]), pcfg, "cpu")


def test_full_config_shapes_types_and_bytes():
    """xlstm-350m at 24 layers, counted without allocating: the reference's
    tree of shapes, 906,465,664 bytes in bfloat16 (w_if, b_if, r, b and the
    norms float32); the GeGLU width 2,688."""
    check_full_config(ARCH, 906_465_664)
    assert xlstm.slstm_shapes(configs.get_config(ARCH))["ffn_wi"] == (1024, 2688)
