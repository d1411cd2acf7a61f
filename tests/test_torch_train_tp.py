"""Training with tensor parallelism and FSDP's sharded storage
(``repro_torch.launch.train --want-model``, ``dist/sharding.py``'s train
table, ``dist/fsdp.py``, ``dist/tensor_parallel.py``) against the
reference's trainer on (data, model) XLA host meshes.

The reference side runs in two subprocesses with 4 XLA host devices
(``tests/torch_train_tp_check.py reference``), started when the module's
first test starts; the port's side on 4 spawned gloo ranks. Both start
from the reference's weights.

* ``param_axes(cfg)`` equals the reference's ``model.axes()`` for the
  smoke version of every LM config.
* The port's rule table gives the reference's ``MeshRules.spec`` for every
  leaf of every smoke config on 1-, 2-, 4- and 8-rank plans, pods included
  (the reference's table on a stand-in mesh object: ``spec`` reads only the
  mesh's axis names and sizes).
* The trainer at ``--want-model 2`` (data 2, model 2) and 4 (data 1, model
  4), danube and granite smoke at accum 1 and 2, ``--compress int8`` once,
  zamba2 (its Mamba2 blocks head-parallel, the shared block split as the
  dense family's) once: per-step losses within rtol 1e-5 of the
  reference's; the final global parameters within 1e-3 of each leaf's
  largest |value| (``PARAM_TOL``: the reference parts from itself across
  meshes by more than 1e-5); every rank holds the same global state; every rank's
  stored shard is the reference's device's shard (the same index of the
  global leaf, the same values within that tolerance), and
  ``stored_bytes_per_rank`` is those shards plus two float32 moments each.
* Reshard on restore: 3 steps on (2, 2), checkpointed, resumed on (2, 2)
  bit for bit and on (1, 4) and (4, 1) within rtol 2e-4, atol 1e-5 (the
  reference's ``tests/elastic_check.py`` tolerance).
* Each tensor-parallel layer's ranks in one process (``models/tp_ranks.py``)
  against the unsplit layer: forward and the gradients of Σy².
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import torch_train_dp_check as dp_chk
import torch_train_tp_check as chk
from repro.configs import get_smoke_config as ref_smoke_config
from repro.dist import sharding as ref_sharding
from repro.models.api import build_model as ref_build_model

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.dist.sharding import make_rules
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import tp_ranks, transformer
from repro_torch.models.api import param_axes, param_shapes
from repro_torch.models.common import apply_mlp
from repro_torch.models.losses import causal_lm_loss
from repro_torch.runtime import plan_mesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5  # the per-step tolerance of tests/test_torch_train_dp.py
# the final parameters, of each leaf's largest |value|: AdamW's first steps
# move an element by about the learning rate whatever its gradient's size,
# so a gradient summed in another order (near zero, its sign) moves a leaf
# of small values by much more than its gradient's error. The reference on
# 4 host devices parts from its own one-device run by up to 2.7e-3 (danube
# smoke, (1, 4), 3 steps); the port from the reference on the same mesh by
# up to 5.2e-4 (zamba2's norm scales)
PARAM_TOL = 1e-3
RESHARD_RTOL, RESHARD_ATOL = 2e-4, 1e-5  # tests/elastic_check.py's
# the layers' ranks in one process against the unsplit layer (float32): the
# forward to rtol 1e-5 and 1e-5 of its largest |y|, the gradients to 1e-5 of
# each leaf's largest |g| (the parts add in another order)
Y_RTOL, TOL = 1e-5, 1e-5
CASES = [c for part in chk.TRAIN_CASES for c in part]
REPEAT = (chk.DANUBE, 2, 1, "none")  # run twice: the same bits


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "XLA_FLAGS"):
        env.pop(k, None)
    return env


@functools.lru_cache(maxsize=None)
def ref_weights() -> dict:
    """Each arch's reference weights (``model.init(PRNGKey(0))``), numpy."""
    archs = {c[0] for c in CASES}
    return {a: jax.tree.map(np.asarray, ref_build_model(ref_smoke_config(a)).init(
        jax.random.PRNGKey(0))) for a in archs}


def _runs() -> list:
    return [(a, chk.train_argv(a, wm, acc, comp)) for a, wm, acc, comp in CASES + [REPEAT]]


class Runs:
    """The reference's two parts (subprocesses) and the port's runs on 4
    gloo ranks (spawned from a thread), started with the module."""

    def __init__(self, tmp):
        self.paths = [str(tmp / f"part{i}.pkl") for i in (0, 1)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_train_tp_check.py"),
             "reference", str(i), self.paths[i]], env=_env(), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in (0, 1)]
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        weights = ref_weights()
        self.port = self.pool.submit(dp_chk.spawn, chk.WORLD, chk.case_train, runs=_runs(),
                                     weights=weights)
        self.reshard = self.pool.submit(dp_chk.spawn, chk.WORLD, chk.case_reshard,
                                        weights=weights[chk.DANUBE], tmp=str(tmp))
        self.merged = {}

    def reference(self) -> dict:
        if not self.merged:
            for proc, path in zip(self.procs, self.paths):
                _, err = proc.communicate(timeout=900)
                assert proc.returncode == 0, err[-3000:]
                with open(path, "rb") as f:
                    self.merged.update(pickle.load(f))
        return self.merged

    def close(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        self.pool.shutdown(wait=True)


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    r = Runs(tmp_path_factory.mktemp("train_tp_reference"))
    yield r
    r.close()


# ---------------------------------------------------------------------------
# The logical axes and the rule table
# ---------------------------------------------------------------------------


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_the_reference_model_axes(arch):
    want = ref_build_model(ref_smoke_config(arch)).axes()
    got = param_axes(get_smoke_config(arch))
    assert _tuples(got) == _tuples(jax.tree.map(lambda a: a, want,
                                                is_leaf=lambda x: isinstance(x, tuple)))


def _dict_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _dict_leaves(tree[k], prefix + (k,))]
    return [(prefix, tuple(tree))]


@pytest.mark.parametrize("world,want_model,want_pods", [
    (1, 1, 1), (2, 2, 1), (4, 1, 1), (4, 2, 1), (4, 4, 1), (8, 2, 2), (8, 4, 1)])
def test_the_train_table_gives_the_reference_specs(world, want_model, want_pods):
    plan = plan_mesh(world, global_batch=8, want_model=want_model, want_pods=want_pods)
    mesh = types.SimpleNamespace(axis_names=plan.axes, shape=dict(zip(plan.axes, plan.shape)))
    ref = ref_sharding.make_rules(mesh, "train")
    rules = make_rules(plan, "train")
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        for (path, axes), (_, shape) in zip(_dict_leaves(param_axes(cfg)),
                                            _dict_leaves(param_shapes(cfg))):
            want = tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e)
                         for e in ref.spec(axes, shape))
            want += ((),) * (len(shape) - len(want))
            assert rules.spec(axes, shape) == want, (arch, path, axes, shape)


def test_granite_at_model_4_moves_the_split_to_each_experts_ff():
    """6 smoke experts: ``model`` 4 does not divide them, so the router and
    the experts' first dimension stay whole on ``model`` and each expert's
    ``ff`` takes it; at ``model`` 2 the experts are split."""
    cfg = get_smoke_config(chk.GRANITE)
    shapes, axes = param_shapes(cfg)["layer_0"]["moe"], param_axes(cfg)["layer_0"]["moe"]
    r4 = make_rules(plan_mesh(4, global_batch=8, want_model=4))
    r2 = make_rules(plan_mesh(4, global_batch=8, want_model=2))
    assert r4.spec(axes["router"], shapes["router"]) == (("data",), ())
    assert r4.spec(axes["wi"], shapes["wi"]) == ((), ("data",), ("model",))
    assert r4.spec(axes["wo"], shapes["wo"]) == ((), ("model",), ("data",))
    assert r2.spec(axes["router"], shapes["router"]) == (("data",), ("model",))
    assert r2.spec(axes["wi"], shapes["wi"]) == (("model",), ("data",), ())


# ---------------------------------------------------------------------------
# The trainer against the reference's
# ---------------------------------------------------------------------------


def _ranks_of(runs, case) -> list:
    i = CASES.index(case)
    return [rank[i] for rank in runs.port.result()]


def _close(got, want, tol=PARAM_TOL) -> bool:
    return all(np.allclose(g, w, rtol=0, atol=tol * max(float(np.abs(w).max()), 1e-30))
               for g, w in zip(got, want))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-model{c[1]}-accum{c[2]}-{c[3]}")
def test_trainer_on_a_data_model_mesh_tracks_the_reference(case, runs):
    ranks = _ranks_of(runs, case)
    want = runs.reference()[case]
    got = ranks[0]
    assert got["result"]["mesh"] == want["mesh"] and got["result"]["world"] == chk.WORLD
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert _close(got["params"], want["params"])
    if case[3] != "none":
        assert got["result"]["wire_bytes_per_step"] == got["result"][
            "wire_bytes_expected"] == want["wire"]
    for other in ranks[1:]:  # every rank returns the same losses; rank 0 the global state
        assert other["losses"] == got["losses"]
        assert other["params"] == [] and len(got["params"]) > 0


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-model{c[1]}-accum{c[2]}-{c[3]}")
def test_every_rank_stores_the_reference_devices_shard(case, runs):
    want = runs.reference()[case]
    for r, rank in enumerate(_ranks_of(runs, case)):
        assert len(rank["shards"]) == len(want["index"])
        for shard, index, full in zip(rank["shards"], want["index"], want["params"]):
            sl = tuple(slice(a, b) for a, b in index[r])
            assert shard.shape == full[sl].shape, (r, index[r])
            assert _close([shard], [full[sl]])
        elem = sum(s.nbytes + 8 * s.size for s in rank["shards"])
        assert rank["result"]["stored_bytes_per_rank"] == elem


def test_two_runs_on_one_plan_are_equal_bit_for_bit(runs):
    first = _ranks_of(runs, REPEAT)[0]
    second = runs.port.result()[0][len(CASES)]
    assert first["losses"] == second["losses"]
    assert all(np.array_equal(a, b) for a, b in zip(first["params"], second["params"]))


def test_a_checkpoint_reshards_on_restore(runs):
    """3 steps on (data 2, model 2), the step-3 checkpoint resumed: on the
    same plan the uninterrupted run's last 3 losses and final parameters
    bit for bit; on (1, 4) and (4, 1) within the reference's tolerance."""
    for r in runs.reshard.result():
        whole = r["whole"]
        assert whole["mesh"] == {"data": 2, "model": 2} and len(whole["losses"]) == 6
        assert r["same"]["losses"] == whole["losses"][3:]
        assert all(np.array_equal(a, b) for a, b in zip(r["same"]["params"], whole["params"]))
        for name, mesh in (("model4", {"data": 1, "model": 4}),
                           ("data4", {"data": 4, "model": 1})):
            assert r[name]["mesh"] == mesh
            np.testing.assert_allclose(r[name]["losses"], whole["losses"][3:],
                                       rtol=RESHARD_RTOL, atol=RESHARD_ATOL)


# ---------------------------------------------------------------------------
# Each layer's ranks in one process against the unsplit layer
# ---------------------------------------------------------------------------


def _fwd_bwd(fn, leaves):
    y = fn()
    return y.detach(), torch.autograd.grad((y.float() ** 2).sum(), leaves)


def _hold(split, whole, leaves, exact=False):
    y, g = _fwd_bwd(split, leaves)
    y0, g0 = _fwd_bwd(whole, leaves)
    if exact:
        assert torch.equal(y, y0)
    torch.testing.assert_close(y, y0, rtol=Y_RTOL, atol=TOL * float(y0.abs().max()))
    for a, b in zip(g, g0):
        torch.testing.assert_close(a, b, rtol=0, atol=TOL * float(b.abs().max()))


def _leaf(gen, *shape, scale=0.2):
    return (torch.randn(shape, generator=gen) * scale).requires_grad_(True)


@functools.lru_cache(maxsize=None)
def _layer_inputs():
    cfg = get_smoke_config(chk.DANUBE)
    gen = torch.Generator().manual_seed(0)
    x = _leaf(gen, 2, 16, cfg.d_model, scale=1.0)
    return cfg, gen, x


@pytest.mark.parametrize("size", [2, 4])
def test_the_mlps_ranks_give_the_unsplit_mlp(size):
    cfg, gen, x = _layer_inputs()
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": _leaf(gen, d, f), "wg": _leaf(gen, d, f), "wo": _leaf(gen, f, d)}
    _hold(lambda: tp_ranks.mlp(p, x, "silu", size), lambda: apply_mlp(p, x, "silu"),
          [x, *p.values()])


@pytest.mark.parametrize("size", [2, 4])
def test_the_head_parallel_ranks_give_the_unsplit_attention(size):
    """4 heads, 2 KV heads: at 2 ranks each rank takes its KV head, at 4
    ranks every rank computes both and reads its query head's."""
    cfg, gen, x = _layer_inputs()
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": _leaf(gen, d, h, hd), "wk": _leaf(gen, d, k, hd), "wv": _leaf(gen, d, k, hd),
         "wo": _leaf(gen, h, hd, d), "bq": _leaf(gen, h, hd), "bk": _leaf(gen, k, hd),
         "bv": _leaf(gen, k, hd)}
    _hold(lambda: tp_ranks.attention(p, x, cfg, size, window=cfg.swa_window),
          lambda: attn.attention(p, x, cfg, window=cfg.swa_window), [x, *p.values()])


@pytest.mark.parametrize("size", [2, 4])
def test_the_vocab_parallel_ranks_give_the_unsplit_embedding_and_loss(size):
    cfg, gen, _ = _layer_inputs()
    cfg = dataclasses.replace(cfg, tie_embeddings=True, embed_scale=True)
    table = _leaf(gen, cfg.vocab, cfg.d_model)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen)

    def whole():
        h = torch.tanh(transformer.embed_tokens({"embed": table}, tokens, cfg))
        return causal_lm_loss(transformer.unembed({"embed": table}, h, cfg), tokens)[0]

    _hold(lambda: tp_ranks.embed_and_loss(table, torch.tanh, tokens, cfg, size)[2][0],
          whole, [table])


@pytest.mark.parametrize("size", [2, 3, 4])
def test_the_moe_blocks_ranks_give_the_unsplit_block(size):
    """6 padded smoke experts: at 2 and 3 ranks each multiplies its
    experts' buckets, and the block's ``y`` is the unsplit block's bit for
    bit; at 4 ranks each computes its ``ff`` part of every product."""
    cfg = get_smoke_config(chk.GRANITE)
    _, gen, x = _layer_inputs()
    p = {k: v.requires_grad_(True) for k, v in
         moe_lib.init_moe(gen, cfg, torch.float32, "cpu").items()}
    _hold(lambda: tp_ranks.moe(p, x, cfg, size)[0],
          lambda: moe_lib.apply_moe_gspmd(p, x, cfg)[0], [x, *p.values()],
          exact=size in (2, 3))
