"""The port's VLM family (paligemma: ``img_proj`` and
``transformer.forward(prefix_emb=...)``) against the reference's on the CPU,
on the reference's own smoke weights carried across by
``lm_params_from_numpy``: forward logits with an ``img_emb`` prefix
(float32 and bfloat16), the decode step (the dense step with no image, as
in the reference), prefill, the parameter tree and the full config counted
without allocating."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.models import transformer

from test_torch_hybrid import check_full_config, port_leaves, ref_leaves
from test_torch_lm import BF16_ATOL, BF16_RTOL, RTOL, ATOL, B, N, _decode_both, carried

torch.set_num_threads(1)

ARCH = "paligemma_3b"


@functools.lru_cache(maxsize=None)
def image(dtype="float32"):
    """``img_emb`` [B, img_tokens, img_dim], float32 as a frontend gives it."""
    cfg = carried(ARCH, dtype)[0]
    return np.random.default_rng(4).standard_normal(
        (B, cfg.img_tokens, cfg.img_dim)).astype(np.float32)


def forward_both(dtype="float32", last_only=False):
    _, rmodel, rparams, _, pmodel, pparams, tokens = carried(ARCH, dtype)
    want, _ = rmodel.forward(rparams, {"tokens": jnp.asarray(tokens),
                                       "img_emb": jnp.asarray(image(dtype))}, None, False,
                             last_only=last_only)
    got, _ = pmodel.forward(pparams, {"tokens": torch.as_tensor(tokens).long(),
                                      "img_emb": torch.as_tensor(image(dtype))},
                            last_only=last_only)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("last_only", [False, True])
def test_forward_with_an_image_prefix_equals_the_reference(last_only):
    want, got = forward_both(last_only=last_only)
    cfg = carried(ARCH)[3]
    assert got.shape == want.shape == (B, 1 if last_only else cfg.img_tokens + N, cfg.vocab)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_the_prefix_conditions_the_text():
    """Another image changes every text position's logits; the prefix sits
    before the tokens in sequence order."""
    *_, pmodel, pparams, tokens = carried(ARCH)
    batch = {"tokens": torch.as_tensor(tokens).long(), "img_emb": torch.as_tensor(image())}
    a, _ = pmodel.forward(pparams, batch)
    b, _ = pmodel.forward(pparams, dict(batch, img_emb=-batch["img_emb"]))
    k = pmodel.prefix_len
    assert k == pmodel.cfg.img_tokens
    assert not torch.allclose(a[:, k:], b[:, k:])
    # the first image position sees only itself: the text cannot reach it
    c, _ = pmodel.forward(pparams, dict(batch, tokens=batch["tokens"].flip(1)))
    torch.testing.assert_close(a[:, 0], c[:, 0], rtol=RTOL, atol=ATOL)


def test_prefix_emb_is_cast_to_the_activation_type():
    *_, pcfg, pmodel, pparams, tokens = carried(ARCH, "bfloat16")
    tok = torch.as_tensor(tokens).long()
    prefix = torch.randn(B, 3, pcfg.d_model)  # float32 into a bfloat16 model
    got, _ = transformer.forward(pparams, tok, pcfg, prefix_emb=prefix)
    want, _ = transformer.forward(pparams, tok, pcfg, prefix_emb=prefix.to(torch.bfloat16))
    assert torch.equal(got, want) and got.shape[1] == 3 + N


def test_bfloat16_forward_equals_the_reference():
    want, got = forward_both("bfloat16")
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_is_the_dense_step_and_equals_the_reference(dtype):
    want, got = _decode_both(ARCH, dtype)
    tol = (RTOL, ATOL) if dtype == "float32" else (BF16_RTOL, BF16_ATOL)
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])


def test_prefill_step_is_the_forwards_last_position():
    *_, pmodel, pparams, tokens = carried(ARCH)
    batch = {"tokens": torch.as_tensor(tokens).long(), "img_emb": torch.as_tensor(image())}
    torch.testing.assert_close(pmodel.prefill_step(pparams, batch),
                               torch.as_tensor(forward_both()[1][:, -1]), rtol=RTOL, atol=ATOL)


def test_lm_params_from_numpy_takes_the_tree_and_refuses_a_foreign_one():
    _, _, rparams, pcfg, _, pparams, _ = carried(ARCH, "bfloat16")
    tree = jax.tree.map(np.asarray, rparams)
    assert port_leaves(pparams) == ref_leaves(tree)
    assert pparams["img_proj"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="img_proj"):
        lm_params_from_numpy({k: v for k, v in tree.items() if k != "img_proj"}, pcfg, "cpu")
    with pytest.raises(ValueError, match="img_proj"):
        lm_params_from_numpy(dict(tree, img_proj=tree["img_proj"].T), pcfg, "cpu")


def test_full_config_shapes_types_and_bytes():
    """paligemma-3b at 18 layers, counted without allocating: the reference's
    tree of shapes with ``img_proj`` [1152, 2048], 5,022,195,712 bytes in
    bfloat16."""
    check_full_config(ARCH, 5_022_195_712)
