"""Serving across ranks (``repro_torch.launch.serve`` in a process group,
``dist/sharding.py``'s serve table, the split decode step of
``models/transformer.py`` and ``models/attention.py::attention_decode_tp``)
against the reference's ``BatchServer`` under ``make_rules(mesh, "serve")``
on XLA host meshes.

The reference side runs in three subprocesses with 4 XLA host devices
(``tests/torch_serve_ranks_check.py reference``), started when the module's
first test starts; the port's side on 2 and 4 spawned gloo ranks, from the
reference's weights.

* ``Model.cache_axes()`` equals the reference's for every family, and the
  port's serve table gives the reference's ``MeshRules.spec`` for every
  parameter and cache leaf of every smoke config on (4, 1), (2, 2) and
  (1, 4) (a stand-in mesh object, as the train table's test uses).
* The launcher over 2 and 4 gloo ranks (``--want-model 1``, the
  reference's plan: (2, 1) and (4, 1)) gives the reference's token lists
  for the dense, MoE, hybrid, xLSTM, VLM and encoder-decoder families, at
  4 slots (a block of slots a rank) and at slots the data ranks do not
  divide (every rank serves every slot). Every rank holds every token.
* The split decode of qwen2.5 and granite smoke on (1, 4) and (2, 2), the
  cache split on its positions (max_len 32), on its KV heads (max_len 31 at
  (2, 2)) and whole (max_len 30 at (1, 4)): every decode step's logits
  within ``LOGIT_TOL`` of the largest |logit| of the reference's step, and
  the same token lists. The smallest top-2 margin of any slot at any step
  of the reference's runs is 4.6e-4 of the largest |logit|, 45 times the
  tolerance (asserted above twice the tolerance, so equal tokens are not
  luck).
  Every rank stores the reference device's shard of every parameter leaf
  (exactly) and of every cache leaf (the same index; the lines the
  reference holds written within ``LOGIT_TOL`` of the leaf's largest).
* The launcher at a world of one is the one-device server, bit for bit;
  the split decode's ranks as threads of one process
  (``models/tp_ranks.py::DecodeRanks``) give the unsplit step. The hybrid,
  xLSTM and encoder-decoder families' split steps are held in
  ``tests/test_torch_serve_ranks_families.py``.
"""

from __future__ import annotations

import concurrent.futures
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

import torch_serve_ranks_check as chk
import torch_train_dp_check as dp_chk
from repro.configs import get_smoke_config as ref_smoke_config
from repro.dist import sharding as ref_sharding
from repro.models.api import build_model as ref_build_model

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.dist.compress import tree_leaves
from repro_torch.dist.sharding import make_rules
from repro_torch.launch import serve
from repro_torch.models.api import build_model, param_axes, param_shapes
from repro_torch.models.tp_ranks import DecodeRanks
from repro_torch.runtime import plan_mesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the split step's logits against the reference's, of its largest |logit|
# (float32; the parts of a softmax, a product or a vocab part add in another
# order than one device's)
LOGIT_TOL = 1e-5
PLANS = [(4, 1), (2, 2), (1, 4)]  # (data, model) on 4 ranks


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "XLA_FLAGS"):
        env.pop(k, None)
    return env


@functools.lru_cache(maxsize=None)
def ref_weights() -> dict:
    """Each arch's weights as the reference's server draws them
    (``model.init(PRNGKey(0))``), numpy."""
    return {a: jax.tree.map(np.asarray, ref_build_model(ref_smoke_config(a)).init(
        jax.random.PRNGKey(chk.SEED))) for a in chk.ARCHS}


class Runs:
    """The reference's three parts (subprocesses) and the port's runs on 2
    and 4 gloo ranks (spawned from a thread), started with the module."""

    def __init__(self, tmp):
        self.paths = [str(tmp / f"part{i}.pkl") for i in range(3)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_serve_ranks_check.py"),
             "reference", str(i), self.paths[i]], env=_env(), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in range(3)]
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        weights = ref_weights()
        self.launch = {w: self.pool.submit(
            dp_chk.spawn, w, chk.case_launch, weights=weights,
            cases=[(a, s) for a, s, world in chk.LAUNCH_CASES if world == w]) for w in (2, 4)}
        self.split = self.pool.submit(dp_chk.spawn, chk.WORLD, chk.case_split, weights=weights)
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
    r = Runs(tmp_path_factory.mktemp("serve_ranks_reference"))
    yield r
    r.close()


# ---------------------------------------------------------------------------
# The cache's logical axes and the serve table
# ---------------------------------------------------------------------------


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _dict_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _dict_leaves(tree[k], prefix + (k,))]
    return [(prefix, tuple(tree))]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_equal_the_reference_cache_axes(arch):
    want = ref_build_model(ref_smoke_config(arch)).cache_axes()
    assert _tuples(build_model(get_smoke_config(arch), "cpu").cache_axes()) == _tuples(want)


def _ref_spec(ref, axes, shape) -> tuple:
    want = tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e)
                 for e in ref.spec(axes, shape))
    return want + ((),) * (len(shape) - len(want))


@pytest.mark.parametrize("data,model", PLANS)
def test_the_serve_table_gives_the_reference_specs(data, model):
    """Every parameter leaf, and every cache leaf at 4 and 3 slots and a
    max_len of 32 (the model axis divides it) and 30 (it does not at 4)."""
    plan = plan_mesh(data * model, global_batch=4, want_model=model)
    mesh = types.SimpleNamespace(axis_names=plan.axes, shape=dict(zip(plan.axes, plan.shape)))
    ref = ref_sharding.make_rules(mesh, "serve")
    rules = make_rules(plan, "serve")
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        for (path, axes), (_, shape) in zip(_dict_leaves(param_axes(cfg)),
                                            _dict_leaves(param_shapes(cfg))):
            assert rules.spec(axes, shape) == _ref_spec(ref, axes, shape), (arch, path)
        m = build_model(cfg, "cpu")
        for slots, max_len in ((4, 32), (3, 30)):
            cache = m.init_cache(slots, max_len)
            for (path, axes), x in zip(_dict_leaves(m.cache_axes()), tree_leaves(cache)):
                assert rules.spec(axes, x.shape) == _ref_spec(ref, axes, x.shape), (arch, path)


def test_the_serve_table_splits_the_kv_cache_positions_first():
    """A qwen2.5-14B cache leaf ``[8, 4096, 8, 128]`` at (1, 4): positions;
    at 4095 positions its 8 KV heads; with 6 KV heads and 4095 positions, whole."""
    rules = make_rules(plan_mesh(4, global_batch=8, want_model=4), "serve")
    axes = ("batch", "kvseq", "kv_heads", None)
    assert rules.spec(axes, (8, 4096, 8, 128)) == (("data",), ("model",), (), ())
    assert rules.spec(axes, (8, 4095, 8, 128)) == (("data",), (), ("model",), ())
    assert rules.spec(axes, (8, 4095, 6, 128)) == (("data",), (), (), ())
    assert make_rules(plan_mesh(4, global_batch=8, want_model=4), "train").table["kvseq"] == ()


# ---------------------------------------------------------------------------
# The launcher across gloo ranks against the reference's server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", chk.LAUNCH_CASES, ids=lambda c: f"{c[0]}-slots{c[1]}-P{c[2]}")
def test_the_launcher_across_gloo_ranks_gives_the_reference_tokens(case, runs):
    arch, slots, world = case
    want = runs.reference()[case]
    ranks = [r[(arch, slots)] for r in runs.launch[world].result()]
    for r, got in enumerate(ranks):  # every rank holds every request's tokens
        assert got["tokens"] == want["tokens"], r
        assert got["result"]["plan"] == want["mesh"] and got["result"]["world"] == world
        assert got["result"]["requests"] == chk.REQUESTS
    block = slots // world if slots % world == 0 else slots
    assert [(g["slot0"], g["local_slots"]) for g in ranks] == [
        ((r * block) % slots if block < slots else 0, block) for r in range(world)]


def test_the_launcher_at_a_world_of_one_is_the_one_device_server():
    """No group: the plan is (1, 1) and the launcher's server is the
    one-device ``BatchServer`` (no rules), token for token and bit for bit
    in its cache."""
    arch = chk.QWEN
    cfg = get_smoke_config(arch)
    params = lm_params_from_numpy(ref_weights()[arch], cfg, "cpu")
    result, launched = serve.serve(serve.parse_args(chk.launch_argv(arch, 2)), params)
    plain = serve.BatchServer(cfg, slots=2, max_len=chk.MAX_LEN, params=params, device="cpu")
    want = chk.drain(plain, chk.launch_stream(cfg.vocab, serve.Request))
    assert result["world"] == 1 and result["plan"] == {"data": 1, "model": 1}
    assert {r.rid: list(r.out) for r in launched.done} == want
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(launched.cache),
                                                 tree_leaves(plain.cache)))


# ---------------------------------------------------------------------------
# The split decode step against the reference's on (1, 4) and (2, 2)
# ---------------------------------------------------------------------------


def _split_ids(c):
    return f"{c[0]}-model{c[1]}-len{c[2]}"


def _global_logits(ranks) -> list:
    """Every step's logits of every slot: the data ranks' blocks in rank
    order (every model rank of a data rank holds the same)."""
    first = [r for r in ranks if r["model_rank"] == 0]
    return [np.concatenate([r["logits"][i] for r in first]) for i in
            range(len(first[0]["logits"]))]


@pytest.mark.parametrize("case", chk.SPLIT_CASES, ids=_split_ids)
def test_the_split_decode_step_tracks_the_reference(case, runs):
    want = runs.reference()[case]
    ranks = [r[case] for r in runs.split.result()]
    for r in ranks:
        assert r["tokens"] == want["tokens"]
    got = _global_logits(ranks)
    assert len(got) == len(want["logits"]) > 0
    for i, (g, w) in enumerate(zip(got, want["logits"])):
        top = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_TOL * top, err_msg=f"step {i}")
        two = np.sort(w, axis=-1)[:, -2:]
        assert (two[:, 1] - two[:, 0]).min() > 2 * LOGIT_TOL * top, f"step {i}"
    model_ranks = {}
    for r in ranks:  # the model ranks of a data rank return the same logits
        model_ranks.setdefault(r["slot0"], []).append(r["logits"])
    for logs in model_ranks.values():
        assert all(all(np.array_equal(a, b) for a, b in zip(logs[0], o)) for o in logs[1:])


@pytest.mark.parametrize("case", chk.SPLIT_CASES, ids=_split_ids)
def test_every_rank_stores_the_reference_devices_shard(case, runs):
    arch = case[0]
    want = runs.reference()[case]
    weights = jax.tree.leaves(ref_weights()[arch])
    for rank, r in enumerate(runs.split.result()):
        got = r[case]
        assert len(got["params"]) == len(want["param_index"]) == len(weights)
        for shard, index, full in zip(got["params"], want["param_index"], weights):
            sl = tuple(slice(a, b) for a, b in index[rank])
            assert np.array_equal(shard, full[sl]), (rank, index[rank])
        assert len(got["cache"]) == len(want["cache_index"])
        for shard, index, full in zip(got["cache"], want["cache_index"], want["cache"]):
            sl = tuple(slice(a, b) for a, b in index[rank])
            ref = full[sl]
            assert shard.shape == ref.shape, (rank, index[rank])
            # the reference zeroes a slot's lines at admission: compare the
            # lines it holds written
            written = np.abs(ref).max(axis=(2, 3)) > 0
            assert written.any(), (rank, index[rank])
            np.testing.assert_allclose(shard[written], ref[written], rtol=0,
                                       atol=LOGIT_TOL * float(np.abs(full).max()))


# ---------------------------------------------------------------------------
# The split step's ranks in one process, and the families without one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [chk.QWEN, chk.GRANITE, "h2o_danube_1_8b"])
@pytest.mark.parametrize("size,max_len,split", [(2, 32, 1), (4, 32, 1), (2, 31, 2),
                                                (4, 30, None)])
def test_the_in_process_ranks_give_the_unsplit_decode_step(arch, size, max_len, split):
    """``DecodeRanks``: 12 steps at three slots with their own positions
    (danube's sliding window included) against the unsplit step, logits
    within ``LOGIT_TOL`` of the largest |logit|, the caches put back whole."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, "cpu")
    params = model.init(0)
    ranks = DecodeRanks(model, params, 3, max_len, size)
    try:
        assert ranks.kv_split() == split
        cache = model.init_cache(3, max_len)
        gen = torch.Generator().manual_seed(1)
        for t in range(12):
            token = torch.randint(0, cfg.vocab, (3,), generator=gen)
            pos = torch.tensor([t, t + 3, max(t - 2, 0)])
            with torch.no_grad():
                want, cache = model.serve_step(params, {"token": token, "pos": pos,
                                                        "cache": cache})
            got = ranks.step(token, pos)
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=LOGIT_TOL * float(want.abs().max()))
        for i, leaf in enumerate(tree_leaves(cache)):
            parts = [tree_leaves(c)[i] for c in ranks.caches]
            whole = parts[0] if split is None else torch.cat(parts, dim=split)
            torch.testing.assert_close(whole, leaf, rtol=0,
                                       atol=LOGIT_TOL * float(leaf.abs().max()))
    finally:
        ranks.close()
