"""The port's dense and MoE LMs (``repro_torch.models``) against the
reference's (``repro.models``) on the CPU, on the reference's own weights
carried across by ``lm_params_from_numpy``: forward and decode-step logits,
greedy tokens, the port's decode-vs-forward consistency, bfloat16 cases, the
config registry and the full-width trees counted without allocating. The
hybrid, xLSTM, VLM and encoder-decoder families have their own files
(``test_torch_hybrid.py``, ``_xlstm.py``, ``_vlm.py``, ``_whisper.py``), which
take this file's helpers; training has ``test_torch_train.py``."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import ssumm_paper as ref_paper
from repro.models.api import build_model as ref_build_model

from repro_torch import configs
from repro_torch.configs import ssumm_paper
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.models import transformer
from repro_torch.models.api import build_model
from repro_torch.models.common import param_bytes, param_count

torch.set_num_threads(1)

DENSE = ["gemma_7b", "qwen2_5_14b", "h2o_danube_1_8b", "deepseek_coder_33b"]
MOE = ["granite_moe_3b_a800m", "moonshot_v1_16b_a3b"]
# float32: both sides add the same terms in other orders (XLA's dot, torch's
# matmul); measured differences are below 1e-6 at logits of ~0.6.
RTOL = ATOL = 1e-5
# bfloat16: the two frameworks round intermediates at other places (the jitted
# reference keeps fused elementwise chains in float32, eager PyTorch rounds
# every op to bfloat16). One bfloat16 rounding is a relative 2^-8; the logits
# (|x| < 1) are held to four roundings of 1, 2^-6 (measured: 0.0066).
BF16_RTOL, BF16_ATOL = 2.0 ** -8, 2.0 ** -6
B, N, CACHE = 2, 12, 32


def _with(cfg, dtype, cf):
    cfg = dataclasses.replace(cfg, dtype=dtype)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


@functools.lru_cache(maxsize=None)
def carried(arch: str, dtype: str = "float32", cf: float | None = None):
    """(ref cfg, ref model, ref params, port cfg, port model, port params, tokens);
    ``cf`` replaces an MoE config's capacity factor on both sides."""
    rcfg = _with(ref_configs.get_smoke_config(arch), dtype, cf)
    pcfg = _with(configs.get_smoke_config(arch), dtype, cf)
    rmodel = ref_build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    pmodel = build_model(pcfg, "cpu")
    pparams = lm_params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg, "cpu")
    tokens = np.random.default_rng(3).integers(0, rcfg.vocab, (B, N)).astype(np.int32)
    return rcfg, rmodel, rparams, pcfg, pmodel, pparams, tokens


def _ref_forward(arch, dtype="float32", cf=None, aux=False):
    _, rmodel, rparams, *_, tokens = carried(arch, dtype, cf)
    logits, out = rmodel.forward(rparams, {"tokens": jnp.asarray(tokens)}, None, False)
    return (np.asarray(logits), out) if aux else np.asarray(logits)


def _port_forward(arch, dtype="float32", cf=None, aux=False):
    *_, pmodel, pparams, tokens = carried(arch, dtype, cf)
    logits, out = pmodel.forward(pparams, {"tokens": torch.as_tensor(tokens).long()})
    return (logits.numpy(), out) if aux else logits.numpy()


def _decode_both(arch, dtype="float32", cf=None, jit=True):
    """Per-position decode logits of the reference and the port, [N, B, V]
    each; the reference's step jitted, as its server runs it, or op by op."""
    _, rmodel, rparams, _, pmodel, pparams, tokens = carried(arch, dtype, cf)
    rcache, pcache = rmodel.init_cache(B, CACHE), pmodel.init_cache(B, CACHE)

    def rstep(p, c, t, pos):
        return rmodel.serve_step(p, {"token": t, "pos": pos, "cache": c})

    if jit:
        rstep = jax.jit(rstep)
    ref, port = [], []
    for t in range(N):
        lr, rcache = rstep(rparams, rcache, jnp.asarray(tokens[:, t]), jnp.asarray(t, jnp.int32))
        lp, pcache = pmodel.serve_step(pparams, {"token": torch.as_tensor(tokens[:, t]).long(),
                                                 "pos": torch.tensor(t), "cache": pcache})
        ref.append(np.asarray(lr))
        port.append(lp.numpy())
    return np.stack(ref), np.stack(port)


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_forward_logits_equal_the_reference(arch):
    (want, raux), (got, paux) = _ref_forward(arch, aux=True), _port_forward(arch, aux=True)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))  # greedy tokens
    if arch in MOE:  # the mean of the layers' load-balance losses
        np.testing.assert_allclose(float(paux["moe_aux"]), float(raux["moe_aux"]), rtol=1e-6)
    else:
        assert paux == {}


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_decode_logits_equal_the_reference(arch):
    want, got = _decode_both(arch)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_decode_matches_forward(arch):
    """The port's counterpart of tests/test_decode_consistency.py: stepping
    the serve path token by token reproduces the forward's logits (an MoE
    model at capacity factor 16, so that the forward drops no record, as
    decode drops none)."""
    cf = 16.0 if arch in MOE else None
    fwd = _port_forward(arch, cf=cf)
    _, dec = _decode_both(arch, cf=cf)
    for t in range(N):
        np.testing.assert_allclose(dec[t], fwd[:, t], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{arch}: decode diverges from forward at {t}")


def test_bfloat16_forward_and_decode():
    arch = "qwen2_5_14b"
    np.testing.assert_allclose(_port_forward(arch, "bfloat16"), _ref_forward(arch, "bfloat16"),
                               rtol=BF16_RTOL, atol=BF16_ATOL)
    want, got = _decode_both(arch, "bfloat16")
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


def test_bfloat16_moe_forward_and_decode():
    arch = "granite_moe_3b_a800m"
    np.testing.assert_allclose(_port_forward(arch, "bfloat16"), _ref_forward(arch, "bfloat16"),
                               rtol=BF16_RTOL, atol=BF16_ATOL)
    want, got = _decode_both(arch, "bfloat16")
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("arch", ["qwen2_5_14b", "gemma_7b"] + MOE)
def test_prefill_step_is_the_forwards_last_position(arch):
    *_, pmodel, pparams, tokens = carried(arch)
    batch = {"tokens": torch.as_tensor(tokens).long()}
    # one position through the matmuls rounds apart from twelve: the same tolerance
    torch.testing.assert_close(pmodel.prefill_step(pparams, batch), torch.as_tensor(
        _port_forward(arch)[:, -1]), rtol=RTOL, atol=ATOL)


def test_seeded_init_has_the_reference_shapes_and_statistics():
    cfg = configs.get_smoke_config("qwen2_5_14b")
    model = build_model(cfg, "cpu")
    a, b = model.init(7), model.init(7)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    rparams = jax.tree.map(np.asarray, ref_build_model(
        ref_configs.get_smoke_config("qwen2_5_14b")).init(jax.random.PRNGKey(0)))
    assert param_count(a) == sum(x.size for x in jax.tree.leaves(rparams))
    wq = a["layer_0"]["attn"]["wq"]  # dense_init: std 1/sqrt(fan_in)
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.1
    assert abs(float(a["embed"].std()) / 0.02 - 1.0) < 0.1
    lm_params_from_numpy(rparams, cfg, "cpu")  # the same tree the port makes


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def test_lm_params_from_numpy_refuses_a_foreign_tree():
    cfg = configs.get_smoke_config("qwen2_5_14b")
    tree = carried("qwen2_5_14b")[2]
    tree = jax.tree.map(np.asarray, tree)
    bad = dict(tree, embed=tree["embed"][:, :-1])
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_numpy(bad, cfg, "cpu")
    missing = {k: v for k, v in tree.items() if k != "ln_f"}
    with pytest.raises(ValueError, match="ln_f"):
        lm_params_from_numpy(missing, cfg, "cpu")


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_configs_equal_the_reference(arch):
    assert configs.ARCHS == ref_configs.ARCHS
    for get in ("get_config", "get_smoke_config"):
        ref = getattr(ref_configs, get)(arch)
        got = dataclasses.asdict(getattr(configs, get)(arch))
        # the port's one added field: the reference scales the embeddings by
        # sqrt(d_model) for the vlm family and for names starting with "gemma"
        assert got.pop("embed_scale") == (ref.family == "vlm" or ref.name.startswith("gemma"))
        assert got == dataclasses.asdict(ref)
    assert configs.get_config(arch).param_count() == ref_configs.get_config(arch).param_count()
    assert configs.applicable_shapes(configs.get_config(arch)) == \
        ref_configs.applicable_shapes(ref_configs.get_config(arch))


def test_ssumm_paper_workloads_equal_the_reference():
    assert ssumm_paper.TARGET_FRACS == ref_paper.TARGET_FRACS
    assert ssumm_paper.DEFAULT_T == ref_paper.DEFAULT_T
    assert ssumm_paper.WORKLOADS.keys() == ref_paper.WORKLOADS.keys()
    for name, w in ssumm_paper.WORKLOADS.items():
        r = ref_paper.WORKLOADS[name]
        assert (w.dataset, w.k_frac, w.dry_run_only, w.v, w.e) == \
            (r.dataset, r.k_frac, r.dry_run_only, r.v, r.e)
        assert dataclasses.asdict(w.cfg) == dataclasses.asdict(r.cfg)


def test_full_width_shapes_and_bytes():
    """qwen2.5-14B at full width, counted without allocating: 27.98 GB of
    bfloat16 parameters, and the KV cache of 8 slots of 128 positions."""
    cfg = configs.get_config("qwen2_5_14b")
    shapes = transformer.param_shapes(cfg)
    n = sum(int(np.prod(s)) for s in _shape_leaves(shapes))
    bias = cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
    assert n == cfg.param_count() + bias + cfg.d_model  # + QKV biases and ln_f
    assert 2 * n == 27_982_931_968
    assert transformer.kv_cache_bytes(cfg, 8, 128) == 2 * 48 * 8 * 128 * 8 * 128 * 2


def _shape_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _shape_leaves(v)
    else:
        yield tree


def _tree_bytes(shapes, path=""):
    """Bytes of a bfloat16 model's tree: routers and norms stay float32."""
    if isinstance(shapes, dict):
        return sum(_tree_bytes(v, f"{path}/{k}") for k, v in shapes.items())
    f32 = path.endswith("/router") or "/ln" in path
    return int(np.prod(shapes)) * (4 if f32 else 2)


@pytest.mark.parametrize("arch", MOE)
def test_moe_full_width_shapes_and_bytes(arch):
    """granite-moe-3b-a800m and moonshot-v1-16b-a3b at full width, counted
    without allocating: the analytic count plus the padded experts, the
    routers and ln_f; granite's tree is 7,811,251,200 bytes."""
    cfg = configs.get_config(arch)
    shapes = transformer.param_shapes(cfg)
    n = sum(int(np.prod(s)) for s in _shape_leaves(shapes))
    d, f, e_pad = cfg.d_model, cfg.d_ff, cfg.moe.experts_padded(16)
    pad = 3 * d * f * (e_pad - cfg.moe.num_experts)
    assert n == cfg.param_count() + cfg.n_layers * (pad + d * e_pad) + d
    assert shapes["layer_0"]["moe"] == {"router": (d, e_pad), "wi": (e_pad, d, f),
                                        "wg": (e_pad, d, f), "wo": (e_pad, f, d)}
    want = {"granite_moe_3b_a800m": 7_811_251_200, "moonshot_v1_16b_a3b": 55_457_882_112}
    assert _tree_bytes(shapes) == want[arch]
    # a seeded bfloat16 smoke model holds its leaves in the types counted here
    small = dataclasses.replace(configs.get_smoke_config(arch), dtype="bfloat16")
    params = build_model(small, "cpu").init(0)
    assert params["layer_0"]["moe"]["router"].dtype == torch.float32
    assert params["layer_0"]["moe"]["wi"].dtype == torch.bfloat16
    assert param_bytes(params) == _tree_bytes(transformer.param_shapes(small))
