"""The port's training path against the reference's on the CPU: the loss
(``models/losses.py``), ``Model.loss`` and every gradient leaf against
``jax.value_and_grad`` for a smoke config of each family, rematerialization,
``Model.train_step``, AdamW and its schedule (``optim/adamw.py``),
microbatched accumulation (``dist/microbatch.py``) and the token pipeline
(``data/``). The trainer has ``test_torch_trainer.py``.

Tolerances, float32: the loss to rtol 1e-5; a gradient leaf to rtol 1e-4
plus an atol of 1e-5 times the tree's largest gradient (leaves whose exact
gradient is 0, such as an attention's ``bk``, hold rounding noise of ~1e-10
on both sides; measured worst: 1e-5 at xLSTM's embedding of |g| ≤ 2.4);
AdamW's parameters and moments to rtol 1e-6 plus an atol of 1e-6 times the
leaf's largest magnitude (the two frameworks round the same float32
operations, XLA may fuse a multiply and an add; a moment's two terms can
cancel)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as RefRunConfig
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import SyntheticTokens as RefTokens
from repro.data import TokenDatasetConfig as RefTokenConfig
from repro.dist import microbatch_grads as ref_microbatch_grads
from repro.models import losses as ref_losses
from repro.models.api import build_model as ref_build_model
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import cosine_schedule as ref_cosine_schedule

from repro_torch.configs import get_smoke_config
from repro_torch.core.convert import lm_params_from_numpy, tree_from_numpy
from repro_torch.data import Loader, SyntheticTokens, TokenDatasetConfig
from repro_torch.dist import microbatch_grads, value_and_grad
from repro_torch.dist.compress import tree_leaves
from repro_torch.models import losses
from repro_torch.models.api import build_model
from repro_torch.optim import AdamWState, adamw_init, adamw_update, cosine_schedule

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-4, 1e-5
OPT_RTOL = 1e-6
FAMILIES = {"dense": "h2o_danube_1_8b", "moe": "granite_moe_3b_a800m", "vlm": "paligemma_3b",
            "hybrid": "zamba2_7b", "xlstm": "xlstm_350m", "encdec": "whisper_large_v3"}
B, S = 2, 16
ARCH = "h2o_danube_1_8b"


@functools.lru_cache(maxsize=None)
def carried(arch):
    """(ref model, ref params, port model, port params, numpy batch)."""
    rcfg = ref_smoke_config(arch)
    rmodel = ref_build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    pcfg = get_smoke_config(arch)
    pparams = lm_params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg, "cpu")
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)}
    if rcfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, rcfg.enc_len, rcfg.d_model)).astype(np.float32)
    if rcfg.family == "vlm":
        batch["img_emb"] = rng.standard_normal((B, rcfg.img_tokens, rcfg.img_dim)).astype(
            np.float32)
    return rmodel, rparams, build_model(pcfg, "cpu"), pparams, batch


def _port_batch(batch):
    return {k: torch.as_tensor(v).long() if k == "tokens" else torch.as_tensor(v)
            for k, v in batch.items()}


def assert_grads_close(got, want):
    """Port gradient tree against a reference one, leaf by leaf (jax's order)."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got = [x.float().numpy() for x in tree_leaves(got)]
    assert len(got) == len(flat)
    atol = GRAD_ATOL_FRAC * max(float(np.abs(np.asarray(w)).max()) for _, w in flat)
    for g, (path, w) in zip(got, flat):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=GRAD_RTOL, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def assert_opt_close(got, want):
    """An optimizer-updated tree leaf by leaf, to ``OPT_RTOL`` plus as much of
    the leaf's largest magnitude (a moment's terms can cancel)."""
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=OPT_RTOL,
                                   atol=OPT_RTOL * float(np.abs(w).max()))


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"z_loss": 0.0}, {"prefix_len": 3},
                                {"moe_aux": 0.37}, {"prefix_len": 2, "moe_aux": 1.5}])
def test_causal_lm_loss_equals_the_reference(kw):
    rng = np.random.default_rng(1)
    pre = kw.get("prefix_len", 0)
    logits = (3 * rng.standard_normal((B, pre + S, 50))).astype(np.float32)
    tokens = rng.integers(0, 50, (B, S)).astype(np.int32)
    rkw = dict(kw, moe_aux=None if "moe_aux" not in kw else jnp.float32(kw["moe_aux"]))
    pkw = dict(kw, moe_aux=None if "moe_aux" not in kw else torch.tensor(kw["moe_aux"]))
    want, wm = ref_losses.causal_lm_loss(jnp.asarray(logits), jnp.asarray(tokens), **rkw)
    got, gm = losses.causal_lm_loss(torch.as_tensor(logits), torch.as_tensor(tokens), **pkw)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    for k in ("nll", "ppl_proxy"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=LOSS_RTOL)
    got_s2s, _ = losses.seq2seq_loss(torch.as_tensor(logits), torch.as_tensor(tokens), **pkw)
    assert float(got_s2s) == float(got)


# ---------------------------------------------------------------------------
# Model.loss and its gradients, every family
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def ref_value_and_grad(arch):
    rmodel, rparams, *_, batch = carried(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.jit(jax.value_and_grad(lambda p: rmodel.loss(p, jb, None, True), has_aux=True))
    return fn(rparams)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_every_gradient_leaf_equal_the_reference(family):
    arch = FAMILIES[family]
    _, _, pmodel, pparams, batch = carried(arch)
    (want, wm), wg = ref_value_and_grad(arch)
    (got, gm), gg = value_and_grad(lambda p: pmodel.loss(p, _port_batch(batch)), pparams)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(gm["nll"]), float(wm["nll"]), rtol=LOSS_RTOL)
    assert_grads_close(gg, wg)


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid", "xlstm"])
def test_remat_gives_the_same_gradients(family):
    """Every block under ``torch.utils.checkpoint`` recomputes the same
    operations: the loss and the gradients are equal bit for bit."""
    _, _, pmodel, pparams, batch = carried(FAMILIES[family])
    pb = _port_batch(batch)
    (l0, _), g0 = value_and_grad(lambda p: pmodel.loss(p, pb, remat=False), pparams)
    (l1, _), g1 = value_and_grad(lambda p: pmodel.loss(p, pb, remat=True), pparams)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))


def test_train_step_equals_the_reference():
    """``Model.train_step``: the loss, the AdamW step at the schedule's rate
    for step 1, every parameter after it. A first step from zero moments
    moves an element by about ``lr·g/(|g| + eps)``, which is sensitive where
    |g| is near eps = 1e-8, far inside the gradients' atol: an element whose
    clipped gradient is below 100·eps is held to the step's own bound, 2·lr;
    every other to rtol 1e-6 plus 1e-3·lr."""
    _, rparams, pmodel, pparams, batch = carried(ARCH)
    run = RefRunConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    # the reference's Model.train_step (repro/models/api.py:62-83) on its
    # jitted value_and_grad: the schedule at step + 1, then adamw_update
    (loss, metrics), grads = ref_value_and_grad(ARCH)
    ropt = ref_adamw_init(rparams)
    lr = ref_cosine_schedule(ropt.step + 1, base_lr=run.lr, warmup=run.warmup_steps,
                             total=run.total_steps, min_ratio=run.lr_min_ratio)
    rp, ropt, om = ref_adamw_update(grads, ropt, rparams, lr=lr, weight_decay=run.weight_decay,
                                    grad_clip=run.grad_clip)
    rm = {"loss": loss, **metrics, **om}
    pp, popt, pm = pmodel.train_step(pparams, adamw_init(pparams), _port_batch(batch), run)
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]), rtol=OPT_RTOL)
    assert int(popt.step) == int(ropt.step) == 1
    assert_grads_close(popt.mu, ropt.mu)
    for g, w, mu in zip(tree_leaves(pp), jax.tree.leaves(rp), jax.tree.leaves(ropt.mu)):
        g, w = g.numpy(), np.asarray(w)
        near_eps = np.abs(np.asarray(mu)) / 0.1 < 100 * 1e-8  # the clipped |g| near eps
        np.testing.assert_allclose(g[~near_eps], w[~near_eps], rtol=OPT_RTOL,
                                   atol=1e-3 * run.lr)
        assert np.all(np.abs(g - w)[near_eps] <= 2 * run.lr * (1 + OPT_RTOL))


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------


def test_cosine_schedule_equals_the_reference():
    """Warm-up, its last step, the decay and past the end."""
    kw = dict(base_lr=3e-4, warmup=10, total=100, min_ratio=0.1)
    for step in [0, 1, 5, 9, 10, 11, 37, 64, 99, 100, 150]:
        want = ref_cosine_schedule(jnp.asarray(step, jnp.int32), **kw)
        got = cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=OPT_RTOL, err_msg=f"step {step}")


def _opt_tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 8)).astype(dtype),
            "blk": {"b": rng.standard_normal(8).astype(dtype),
                    "s": rng.standard_normal((3, 4, 5)).astype(dtype)}}


@pytest.mark.parametrize("grad_scale,clip", [(0.01, 1.0), (10.0, 1.0), (10.0, 0.0)])
def test_adamw_update_equals_the_reference(grad_scale, clip):
    """Three steps from zero moments: parameters, mu, nu, grad_norm and lr;
    with the gradient clipped (global norm above ``clip``) and not."""
    params = _opt_tree(0)
    rp, pp = jax.tree.map(jnp.asarray, params), tree_from_numpy(params, "cpu")
    ropt, popt = ref_adamw_init(rp), adamw_init(pp)
    for step in range(3):
        grads = jax.tree.map(lambda x: grad_scale * x, _opt_tree(10 + step))
        lr = 1e-2 * (step + 1)
        rp, ropt, rm = ref_adamw_update(jax.tree.map(jnp.asarray, grads), ropt, rp,
                                        lr=jnp.float32(lr), grad_clip=clip)
        pp, popt, pm = adamw_update(tree_from_numpy(grads, "cpu"), popt, pp,
                                    lr=torch.tensor(lr, dtype=torch.float32), grad_clip=clip)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=OPT_RTOL)
        assert float(pm["lr"]) == float(rm["lr"])
        assert int(popt.step) == int(ropt.step) == step + 1
        for got, want in ((pp, rp), (popt.mu, ropt.mu), (popt.nu, ropt.nu)):
            assert all(g.dtype == torch.float32 for g in tree_leaves(got))
            assert_opt_close(got, want)


def test_adamw_keeps_bfloat16_parameters_with_float32_moments():
    params = tree_from_numpy(jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
                                          _opt_tree(0)), "cpu")
    opt = adamw_init(params)
    grads = tree_from_numpy(jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
                                         _opt_tree(1)), "cpu")
    new, opt, _ = adamw_update(grads, opt, params, lr=torch.tensor(1e-2))
    assert isinstance(opt, AdamWState)
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(new))
    assert all(x.dtype == torch.float32 for x in tree_leaves(opt.mu) + tree_leaves(opt.nu))
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(new), tree_leaves(params)))


# ---------------------------------------------------------------------------
# microbatched accumulation
# ---------------------------------------------------------------------------


def _mb_batch():
    rcfg = ref_smoke_config(ARCH)
    return {"tokens": np.random.default_rng(8).integers(0, rcfg.vocab, (4, S)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def ref_microbatch(accum):
    rmodel, rparams, *_ = carried(ARCH)
    batch = {"tokens": jnp.asarray(_mb_batch()["tokens"])}
    return jax.jit(lambda p: ref_microbatch_grads(
        lambda q, b: rmodel.loss(q, b, None, True), p, batch, accum))(rparams)


@pytest.mark.parametrize("accum", [1, 2])
def test_microbatch_grads_equal_the_reference(accum):
    *_, pmodel, pparams, _ = carried(ARCH)
    loss, aux, grads = microbatch_grads(lambda p, b: pmodel.loss(p, b), pparams,
                                        _port_batch(_mb_batch()), accum)
    wloss, waux, wgrads = ref_microbatch(accum)
    np.testing.assert_allclose(float(loss), float(wloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["nll"]), float(waux["nll"]), rtol=LOSS_RTOL)
    assert_grads_close(grads, wgrads)


def test_microbatch_accum_2_equals_accum_1():
    """Two equal halves average to the whole batch's loss and gradients (up
    to rounding: the halves' means are added in float32)."""
    *_, pmodel, pparams, _ = carried(ARCH)
    pb = _port_batch(_mb_batch())
    l1, _, g1 = microbatch_grads(lambda p, b: pmodel.loss(p, b), pparams, pb, 1)
    l2, _, g2 = microbatch_grads(lambda p, b: pmodel.loss(p, b), pparams, pb, 2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=LOSS_RTOL)
    atol = GRAD_ATOL_FRAC * max(float(g.abs().max()) for g in tree_leaves(g1))
    for a, b in zip(tree_leaves(g2), tree_leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_RTOL, atol=atol)


def test_microbatch_refuses_a_batch_that_does_not_divide():
    *_, pmodel, pparams, _ = carried(ARCH)
    with pytest.raises(ValueError, match="not divisible by accum=3"):
        microbatch_grads(lambda p, b: pmodel.loss(p, b), pparams, _port_batch(_mb_batch()), 3)


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seed", [(512, 0), (32000, 3), (40, 1)])
def test_synthetic_tokens_equal_the_reference(vocab, seed):
    cfg = dict(vocab=vocab, seq_len=24, global_batch=8, seed=seed)
    ref, port = RefTokens(RefTokenConfig(**cfg)), SyntheticTokens(TokenDatasetConfig(**cfg))
    for i in (0, 1, 17):
        got = port.batch(i)
        assert got.dtype == np.int32 and np.array_equal(got, ref.batch(i))
        for rank, dp in ((0, 2), (1, 2), (3, 4)):
            assert np.array_equal(port.batch_for_rank(i, rank, dp), ref.batch_for_rank(i, rank, dp))


def test_loader_streams_resumes_and_closes():
    ds = SyntheticTokens(TokenDatasetConfig(vocab=512, seq_len=8, global_batch=4))
    loader = Loader(ds.batch, device="cpu", prefetch=2)
    first = [next(loader) for _ in range(5)]
    loader.close()
    assert not loader._thread.is_alive()
    assert [i for i, _ in first] == list(range(5))
    assert all(isinstance(b, torch.Tensor) and np.array_equal(b.numpy(), ds.batch(i))
               for i, b in first)
    resumed = Loader(ds.batch, device="cpu", start_index=3)
    for want in first[3:]:
        i, b = next(resumed)
        assert i == want[0] and torch.equal(b, want[1])
    resumed.close()


def test_loader_raises_the_batch_functions_error():
    def bad(i):
        if i == 1:
            raise RuntimeError("no batch 1")
        return np.zeros((2, 2), np.int32)

    loader = Loader(bad, device="cpu")
    assert next(loader)[0] == 0
    with pytest.raises(RuntimeError, match="no batch 1"):
        next(loader)
    loader.close()
