"""The port's encoder-decoder family (whisper: ``models/whisper.py``,
``attention.cross_attention``/``project_cross_kv``, ``common.sinusoidal_pos``)
against the reference's on the CPU, on the reference's own smoke weights
carried across by ``lm_params_from_numpy``: the position table bit for bit,
cross attention, the encoder, the teacher-forced decoder and the forward
(float32 to 1e-5, bfloat16 to ``BF16_RTOL``/``BF16_ATOL``), the decode step
with the encoder's cross K/V in the cache against the reference's and
against the port's own teacher-forced decoder at every position, prefill,
the server's tokens at 1, 2 and 4 slots, and the full config counted
without allocating."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import whisper as ref_whisper

from repro_torch import configs
from repro_torch.models import attention, whisper
from repro_torch.models.common import param_bytes, sinusoidal_pos

from test_torch_hybrid import check_full_config, shape_leaves
from test_torch_lm import ATOL, B, BF16_ATOL, BF16_RTOL, N, RTOL, carried
from test_torch_lm_serving import serve_port, serve_reference

torch.set_num_threads(1)

ARCH = "whisper_large_v3"


@functools.lru_cache(maxsize=None)
def frames(dtype="float32"):
    """The stub frontend's frame embeddings [B, enc_len, d], float32."""
    cfg = carried(ARCH, dtype)[0]
    return np.random.default_rng(5).standard_normal(
        (B, cfg.enc_len, cfg.d_model)).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@functools.lru_cache(maxsize=None)
def encoded(dtype="float32"):
    """(reference encoder output, port encoder output), each in the model type."""
    rcfg, _, rparams, pcfg, _, pparams, _ = carried(ARCH, dtype)
    rdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    pdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = ref_whisper.encode(rparams, jnp.asarray(frames(dtype)).astype(rdt), rcfg)
    got = whisper.encode(pparams, _t(frames(dtype)).to(pdt), pcfg)
    return want, got


@pytest.mark.parametrize("seq,d", [(12, 64), (128, 1280), (1500, 1280)])
def test_sinusoidal_pos_equals_the_reference_bit_for_bit(seq, d):
    want = np.asarray(ref_common.sinusoidal_pos(seq, d))
    got = sinusoidal_pos(seq, d, "cpu").numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_cross_attention_and_project_cross_kv_equal_the_reference():
    rcfg, _, rparams, _, _, pparams, _ = carried(ARCH)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, N, rcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, rcfg.enc_len, rcfg.d_model)).astype(np.float32)
    rp, pp = rparams["dec_1"]["cross_attn"], pparams["dec_1"]["cross_attn"]
    rk, rv = ref_attn.project_cross_kv(rp, jnp.asarray(enc))
    pk, pv = attention.project_cross_kv(pp, _t(enc))
    assert pk.shape == (B, rcfg.enc_len, rcfg.n_kv_heads, rcfg.hd)
    np.testing.assert_allclose(pk.numpy(), np.asarray(rk), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=RTOL, atol=ATOL)
    want = ref_attn.cross_attention(rp, jnp.asarray(x), rk, rv)
    got = attention.cross_attention(pp, _t(x), pk, pv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_equals_the_reference(dtype):
    """In bfloat16 the encoder's output (a LayerNorm's, |x| up to ~4, where
    the logits are below 1) is held to the logits' four roundings scaled to
    its largest magnitude: ``BF16_ATOL · max|x|``."""
    want, got = encoded(dtype)
    want = np.asarray(want.astype(jnp.float32))
    rtol, atol = (RTOL, ATOL) if dtype == "float32" else (
        BF16_RTOL, BF16_ATOL * max(1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol)


def test_decode_train_equals_the_reference():
    rcfg, _, rparams, pcfg, _, pparams, tokens = carried(ARCH)
    renc, penc = encoded()
    want = ref_whisper.decode_train(rparams, jnp.asarray(tokens), renc, rcfg)
    got = whisper.decode_train(pparams, _t(tokens).long(), penc, pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_equals_the_reference(dtype):
    _, rmodel, rparams, _, pmodel, pparams, tokens = carried(ARCH, dtype)
    want, raux = rmodel.forward(rparams, {"frames": jnp.asarray(frames(dtype)),
                                          "tokens": jnp.asarray(tokens)}, None, False)
    got, paux = pmodel.forward(pparams, {"frames": _t(frames(dtype)),
                                         "tokens": _t(tokens).long()})
    assert got.dtype == torch.float32 and raux == paux == {}
    rtol, atol = (RTOL, ATOL) if dtype == "float32" else (BF16_RTOL, BF16_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)
    if dtype == "float32":
        assert np.array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))


def _conditioned_decode(dtype="float32"):
    """Per-position logits [N, B, V] of the reference's and the port's decode
    steps, each with its own encoder's cross K/V in the cache (the reference's
    composition: encode, project_cross_kv into the cache, decode_step), the
    reference's step jitted as its server runs it."""
    rcfg, rmodel, rparams, pcfg, pmodel, pparams, tokens = carried(ARCH, dtype)
    renc, penc = encoded(dtype)
    rcache = rmodel.init_cache(B, 2 * N)
    for i in range(rcfg.n_layers):
        k, v = ref_attn.project_cross_kv(rparams[f"dec_{i}"]["cross_attn"], renc)
        rcache[f"dec_{i}"] = dict(rcache[f"dec_{i}"], xk=k, xv=v)
    pcache = whisper.fill_cross_cache(pparams, pmodel.init_cache(B, 2 * N), penc, pcfg)
    rstep = jax.jit(lambda p, c, t, pos: rmodel.serve_step(p, {"token": t, "pos": pos,
                                                               "cache": c}))
    ref, port = [], []
    for t in range(N):
        pos = np.full(B, t, np.int32)  # a per-slot position vector
        lr, rcache = rstep(rparams, rcache, jnp.asarray(tokens[:, t]), jnp.asarray(pos))
        lp, pcache = pmodel.serve_step(pparams, {"token": _t(tokens[:, t]).long(),
                                                 "pos": _t(pos).long(), "cache": pcache})
        ref.append(np.asarray(lr))
        port.append(lp.numpy())
    return np.stack(ref), np.stack(port)


def test_decode_with_the_encoders_cross_cache_equals_the_reference():
    want, got = _conditioned_decode()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_decode_matches_the_teacher_forced_decoder():
    """Stepping the decoder with the encoder's cross K/V in the cache gives
    ``decode_train``'s logits at every position."""
    _, _, _, pcfg, _, pparams, tokens = carried(ARCH)
    full = whisper.decode_train(pparams, _t(tokens).long(), encoded()[1], pcfg).numpy()
    _, dec = _conditioned_decode()
    for t in range(N):
        np.testing.assert_allclose(dec[t], full[:, t], rtol=RTOL, atol=ATOL,
                                   err_msg=f"decode diverges from decode_train at {t}")


def test_the_cross_cache_conditions_the_decode():
    """The negative control: the same steps on the zero cross K/V that
    ``init_cache`` (and the server) leave give other logits."""
    _, _, _, _, pmodel, pparams, tokens = carried(ARCH)
    cache = pmodel.init_cache(B, 2 * N)
    lp, _ = pmodel.serve_step(pparams, {"token": _t(tokens[:, 0]).long(),
                                        "pos": torch.tensor(0), "cache": cache})
    assert not np.allclose(lp.numpy(), _conditioned_decode()[1][0], rtol=RTOL, atol=ATOL)


def test_prefill_step_is_the_forwards_last_position():
    *_, pmodel, pparams, tokens = carried(ARCH)
    batch = {"frames": _t(frames()), "tokens": _t(tokens).long()}
    full, _ = pmodel.forward(pparams, batch)
    torch.testing.assert_close(pmodel.prefill_step(pparams, batch), full[:, -1],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("slots", [1, 2, 4])
def test_server_tokens_equal_the_reference(slots):
    """The reference's server never runs the encoder (its cross K/V stay
    zero); the port's serves the same way and gives the same token lists."""
    assert serve_port(ARCH, slots) == serve_reference(ARCH, slots)


def test_full_config_counted_without_allocating():
    """whisper-large-v3's tree against the reference's: 1,535,178,240
    parameters with the biases and norms (the config's ``param_count``,
    1,954,234,880, counts a gated MLP's third matrix that whisper's plain MLP
    does not have), 3,071,185,920 bytes in bfloat16 with float32 norms; and
    the decode cache at 8 slots of 128 positions on the meta device: the self
    K/V plus the 1500-frame cross K/V of 32 layers."""
    cfg = configs.get_config(ARCH)
    check_full_config(ARCH, 3_071_185_920)
    assert sum(int(np.prod(s)) for s in shape_leaves(whisper.param_shapes(cfg)).values()) \
        == 1_535_178_240
    cache = whisper.init_cache(cfg, 8, 128, torch.bfloat16, "meta")
    assert param_bytes(cache) == 32 * 2 * 8 * (128 + 1500) * 1280 * 2
