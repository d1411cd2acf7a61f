"""The split decode steps of the hybrid (zamba2), xLSTM and encoder-decoder
(whisper) families under the serve table (``mamba2.ssd_decode_tp``,
``zamba2.decode_step``, ``xlstm.mlstm_decode_tp``/``slstm_decode_tp``,
``whisper.decode_step`` with ``attention.cross_attention_decode_tp``,
``models/api.py::shard_cache``) against the reference's ``BatchServer``
under ``make_rules(mesh, "serve")`` on XLA host meshes.

The reference side runs in three subprocesses with 4 XLA host devices, one
an arch (``tests/torch_serve_ranks_families_check.py reference ARCH``),
started when the module's first test starts; the port's side on 4 spawned
gloo ranks, from the reference's weights.

* On (1, 4) and (2, 2), the KV caches split on their positions (max_len
  32), on their KV heads (31 at (2, 2), and 30 at (1, 4), where the model
  axis divides the 4 smoke KV heads), xLSTM's states on their heads at
  (2, 2) and whole at (1, 4): every decode step's logits within
  ``LOGIT_TOL`` of the largest |logit| of the reference's step (its
  smallest top-2 margin asserted above twice the tolerance, so equal
  tokens are not luck), the same token lists, every rank's parameter
  shards exactly the reference device's, every cache shard the
  reference's at the same index (the KV lines it holds written, the
  recurrent states whole; xLSTM's within ``STATE_TOL``), the leaves the table keeps whole over ``model``
  (zamba2's SSM state, xLSTM's at (1, 4)) bit for bit the same on every
  model rank of a slot block, and each rank's initial cache the reference's
  ``init_cache`` at its index, xLSTM's -30 stabilisers included.
* whisper from a non-zero cross cache (a seeded encoder output through
  ``whisper.fill_cross_cache``, then sharded) against the reference's
  ``serve_step`` under the same table, step by step.
* The launcher at ``--want-model`` 2 and 4 over 4 gloo ranks gives the
  reference's one-device tokens.
* ``models/tp_ranks.py::DecodeRanks`` (m ranks as threads) gives the
  unsplit step at m = 2 and 4 (and with 6 attention heads at m = 4, where
  every rank attends with every head), and no collective of a split step carries
  more than B × max(vocab, the widest projection output) elements: no
  matrix leaf is gathered whole.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_serve_ranks_families_check as chk
import torch_train_dp_check as dp_chk
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.api import build_model as ref_build_model

from repro_torch.configs import get_smoke_config
from repro_torch.dist.compress import tree_leaves
from repro_torch.models import mamba2, whisper, xlstm
from repro_torch.models.api import build_model
from repro_torch.models.tp_ranks import DecodeRanks

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the split step's logits against the reference's, of its largest |logit|
# (float32; the parts of a softmax, a product or a vocab part add in another
# order than one device's)
LOGIT_TOL = 1e-5
# xLSTM's states after the ragged stream, of a leaf's largest |value|: the
# port's one-device server already parts from the reference's one-device
# server by 3.3e-5 there (75 steps of exponential gating grow the rounding;
# the logits stay within LOGIT_TOL), so the split states are held to 1e-4
STATE_TOL = {"xlstm": 1e-4}


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "XLA_FLAGS"):
        env.pop(k, None)
    return env


@functools.lru_cache(maxsize=None)
def ref_weights() -> dict:
    """Each arch's weights as the reference's server draws them, numpy."""
    return {a: jax.tree.map(np.asarray, ref_build_model(ref_smoke_config(a)).init(
        jax.random.PRNGKey(0))) for a in chk.ARCHS}


class Runs:
    """The reference's three subprocesses and the port's 4 gloo ranks
    (spawned from a thread), started with the module."""

    def __init__(self, tmp):
        self.paths = {a: str(tmp / f"{a}.pkl") for a in chk.ARCHS}
        self.procs = {a: subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_serve_ranks_families_check.py"),
             "reference", a, self.paths[a]], env=_env(), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for a in chk.ARCHS}
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.port = self.pool.submit(dp_chk.spawn, chk.WORLD, chk.case_families,
                                     weights=ref_weights())
        self.merged = {}

    def reference(self) -> dict:
        if not self.merged:
            for a, proc in self.procs.items():
                _, err = proc.communicate(timeout=900)
                assert proc.returncode == 0, err[-3000:]
                with open(self.paths[a], "rb") as f:
                    self.merged.update(pickle.load(f))
        return self.merged

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        self.pool.shutdown(wait=True)


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    r = Runs(tmp_path_factory.mktemp("serve_ranks_families_reference"))
    yield r
    r.close()


def _ids(c):
    return f"{c[0]}-model{c[1]}-len{c[2]}"


def _global(ranks, key) -> list:
    """Every step's ``key`` logits of every slot: the data ranks' blocks in
    rank order (every model rank of a data rank holds the same)."""
    first = [r for r in ranks if r["model_rank"] == 0]
    return [np.concatenate([r[key][i] for r in first]) for i in range(len(first[0][key]))]


def _hold(got, want):
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        top = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_TOL * top, err_msg=f"step {i}")
        two = np.sort(w, axis=-1)[:, -2:]
        assert (two[:, 1] - two[:, 0]).min() > 2 * LOGIT_TOL * top, f"step {i}"


def _same_on_model_ranks(ranks, key):
    """The model ranks of a slot block return the same logits, bit for bit."""
    blocks = {}
    for r in ranks:
        blocks.setdefault(r["slot0"], []).append(r[key])
    for logs in blocks.values():
        assert all(all(np.array_equal(a, b) for a, b in zip(logs[0], o)) for o in logs[1:])


def _names(tree, name=None):
    if isinstance(tree, dict):
        return {k: _names(v, k) for k, v in tree.items()}
    return name


# ---------------------------------------------------------------------------
# The split decode step against the reference's on (1, 4) and (2, 2)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", chk.CASES, ids=_ids)
def test_the_split_decode_step_tracks_the_reference(case, runs):
    want = runs.reference()[case]
    ranks = [r[case] for r in runs.port.result()]
    for r in ranks:
        assert r["tokens"] == want["tokens"]
    _hold(_global(ranks, "logits"), want["logits"])
    _same_on_model_ranks(ranks, "logits")


@pytest.mark.parametrize("case", chk.CASES, ids=_ids)
def test_every_rank_stores_the_reference_devices_shard(case, runs):
    arch = case[0]
    want = runs.reference()[case]
    weights = jax.tree.leaves(ref_weights()[arch])
    names = tree_leaves(_names(build_model(get_smoke_config(arch), "cpu").cache_axes()))
    ranks = [r[case] for r in runs.port.result()]
    for rank, got in enumerate(ranks):
        assert len(got["params"]) == len(want["param_index"]) == len(weights)
        for shard, index, full in zip(got["params"], want["param_index"], weights):
            sl = tuple(slice(a, b) for a, b in index[rank])
            assert np.array_equal(shard, full[sl]), (rank, index[rank])
        assert len(got["cache"]) == len(want["cache_index"]) == len(names)
        for shard, index, full, name in zip(got["cache"], want["cache_index"], want["cache"],
                                            names):
            sl = tuple(slice(a, b) for a, b in index[rank])
            ref = full[sl]
            assert shard.shape == ref.shape, (rank, name, index[rank])
            atol = float(np.abs(full).max())
            if name in ("k", "v"):  # the reference zeroes a slot's lines at admission:
                written = np.abs(ref).max(axis=(2, 3)) > 0  # the lines it holds written
                assert written.any(), (rank, name, index[rank])
                np.testing.assert_allclose(shard[written], ref[written], rtol=0,
                                           atol=LOGIT_TOL * atol)
            else:  # a recurrent state, or whisper's cross K/V (zero as served)
                tol = STATE_TOL.get(get_smoke_config(arch).family, LOGIT_TOL)
                np.testing.assert_allclose(shard, ref, rtol=0, atol=tol * atol, err_msg=name)
    for i, index in enumerate(want["cache_index"]):  # a leaf kept whole over model
        for rank, other in enumerate(ranks):  # is the same on every rank that holds it
            first = index.index(index[rank])
            assert np.array_equal(other["cache"][i], ranks[first]["cache"][i]), (rank, i)


@pytest.mark.parametrize("case", chk.CASES, ids=_ids)
def test_every_rank_starts_from_the_reference_initial_cache(case, runs):
    """``shard_cache``: each rank's cache as the server makes it equals the
    reference's ``init_cache`` at the rank's index, bit for bit (zeros, and
    the -30 stabilisers of xLSTM's mLSTM and sLSTM states)."""
    arch, _, max_len = case
    init = jax.tree.leaves(ref_build_model(ref_smoke_config(arch)).init_cache(chk.SLOTS,
                                                                             max_len))
    want = runs.reference()[case]
    for rank, r in enumerate(runs.port.result()):
        got = r[case]["init_cache"]
        assert len(got) == len(init)
        for shard, index, full in zip(got, want["cache_index"], init):
            sl = tuple(slice(a, b) for a, b in index[rank])
            assert np.array_equal(shard, np.asarray(full)[sl]), (rank, index[rank])
    if arch == chk.XLSTM:
        assert any((np.asarray(x) == xlstm.M_INIT).all() for x in init)


@pytest.mark.parametrize("plan", chk.PLANS, ids=lambda p: f"model{p[0]}-len{p[1]}")
def test_whisper_split_step_from_a_cross_cache_tracks_the_reference(plan, runs):
    """A zero cross cache adds nothing, so the served tokens cannot show a
    fault in the split cross attention; here the cross K/V come from a
    seeded encoder output, on both sides."""
    case = (chk.WHISPER,) + plan
    want = runs.reference()[case]
    ranks = [r[case] for r in runs.port.result()]
    full = tree_leaves(want["cross_cache"])
    for rank, r in enumerate(ranks):  # each rank's shard of the filled cache
        for shard, index, leaf in zip(r["cross_cache"], want["cache_index"], full):
            ref = leaf[tuple(slice(a, b) for a, b in index[rank])]
            np.testing.assert_allclose(shard, ref, rtol=0,
                                       atol=LOGIT_TOL * float(np.abs(leaf).max()))
    assert float(np.abs(full[-1]).max()) > 0  # the cross V is not zero
    _hold(_global(ranks, "cross_logits"), want["cross_logits"])
    _same_on_model_ranks(ranks, "cross_logits")


@pytest.mark.parametrize("want_model", [2, 4])
@pytest.mark.parametrize("arch", chk.ARCHS)
def test_the_launcher_at_want_model_m_gives_the_reference_tokens(arch, want_model, runs):
    want = runs.reference()[(arch, "launch")]
    for r in runs.port.result():
        got = r[(arch, "launch", want_model)]
        assert got["plan"] == {"data": 4 // want_model, "model": want_model}
        assert got["tokens"] == want


# ---------------------------------------------------------------------------
# The split step's ranks in one process: the unsplit step, and its collectives
# ---------------------------------------------------------------------------


def _filled_cache(model, params, cfg, slots, max_len):
    """The family's initial cache; whisper's cross K/V from a seeded
    encoder output."""
    cache = model.init_cache(slots, max_len)
    if cfg.family == "encdec":
        gen = torch.Generator().manual_seed(5)
        enc = torch.randn(slots, cfg.enc_len, cfg.d_model, generator=gen)
        whisper.fill_cross_cache(params, cache, enc, cfg)
    return cache


@pytest.mark.parametrize("arch", chk.ARCHS)
@pytest.mark.parametrize("size,max_len,split", [(2, 32, 1), (4, 32, 1), (2, 31, 2),
                                                (4, 30, 2)])
def test_the_in_process_ranks_give_the_unsplit_decode_step(arch, size, max_len, split):
    """``DecodeRanks``: 12 steps at three slots with their own positions
    against the unsplit step, logits within ``LOGIT_TOL`` of the largest
    |logit|, the caches put back whole (xLSTM's states whole at m = 4: its
    2 smoke heads)."""
    cfg = get_smoke_config(arch)

    def check(ranks):
        if cfg.family == "xlstm":  # no KV cache: its states split on their 2 heads at m = 2
            assert ranks.rules.split_dim(("batch", "heads"), (3, cfg.n_heads)) == (
                1 if size == 2 else None)
        else:
            assert ranks.kv_split() == split

    _hold_unsplit(cfg, size, max_len, check)


@pytest.mark.parametrize("arch", [chk.ZAMBA2, chk.WHISPER])
def test_the_in_process_ranks_where_the_heads_do_not_split(arch):
    """6 attention heads of 16 at m = 4 and 30 positions: the table splits
    neither the heads, the KV heads nor the positions, so every rank
    attends with every head over a whole cache (whisper's cross K/V too),
    and ``wo``, stored split on its ``d_model`` columns, has its products
    gathered."""
    cfg = dataclasses.replace(get_smoke_config(arch), n_heads=6, n_kv_heads=6, head_dim=16)

    def check(ranks):
        assert ranks.kv_split() is None
        wo = ("heads", None, "attn_embed")
        assert ranks.rules.split_dim(wo, (6, 16, cfg.d_model)) == 2

    _hold_unsplit(cfg, 4, 30, check)


def _hold_unsplit(cfg, size: int, max_len: int, check):
    """``DecodeRanks`` of ``size`` ranks (``check(ranks)`` first) against
    the unsplit step: 12 steps at three slots with their own positions,
    logits within ``LOGIT_TOL`` of the largest |logit|, the caches put back
    whole."""
    model = build_model(cfg, "cpu")
    params = model.init(0)
    cache = _filled_cache(model, params, cfg, 3, max_len)
    ranks = DecodeRanks(model, params, 3, max_len, size, cache=cache)
    try:
        check(ranks)
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
        for i, (leaf, axes) in enumerate(zip(tree_leaves(cache), _axes(model))):
            parts = [tree_leaves(c)[i] for c in ranks.caches]
            dim = ranks.rules.split_dim(axes, tuple(leaf.shape))
            whole = parts[0] if dim is None else torch.cat(parts, dim=dim)
            torch.testing.assert_close(whole, leaf, rtol=0,
                                       atol=LOGIT_TOL * float(leaf.abs().max()))
    finally:
        ranks.close()


def _axes(model) -> list:
    """The logical axes of every cache leaf, in ``tree_leaves`` order."""
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [tuple(tree)]
    return leaves(model.cache_axes())


def _widest(cfg) -> int:
    """The widest output of a projection of the family's decode step."""
    if cfg.family == "hybrid":
        _, di, h, _, n = mamba2.dims(cfg)
        return max(2 * di + 2 * n + h, cfg.d_ff, cfg.n_heads * cfg.hd)
    if cfg.family == "xlstm":
        return max(xlstm.mlstm_dims(cfg)[1], xlstm._ffn_width(cfg.d_model))
    return max(cfg.d_ff, cfg.n_heads * cfg.hd)


#: the projection matrices of the three families' trees (and the embedding)
PROJECTIONS = {"embed", "in_proj", "out_proj", "wq", "wk", "wv", "wo", "wi", "wg", "up_x",
               "up_z", "down", "w_in", "r", "ffn_wi", "ffn_wg", "ffn_wo"}


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("arch", chk.ARCHS)
def test_no_collective_of_a_split_step_gathers_a_leaf_whole(arch, size):
    """Every gather and exchange of one split decode step at 4 slots,
    counted in elements over the group: none carries more than B ×
    max(vocab, the widest projection output), which every projection
    matrix of these smoke configs exceeds, so none is gathered whole."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, "cpu")
    params = model.init(0)
    slots = 4
    ranks = DecodeRanks(model, params, slots, 32, size,
                        cache=_filled_cache(model, params, cfg, slots, 32))
    carried = []

    def count(g, name, per):
        fn = getattr(g, name)

        def counted(x):
            if g.rank == 0:
                carried.append(int(x.numel()) * per)
            return fn(x)
        setattr(g, name, counted)

    for g in ranks.groups:
        count(g, "gather", g.size)  # every rank's part
        count(g, "exchange", 1)  # a chunk for every rank
    try:
        ranks.step(torch.arange(slots), torch.arange(slots) * 3)
    finally:
        ranks.close()
    bound = slots * max(cfg.vocab, _widest(cfg))
    sizes = [x.numel() for x, name in zip(tree_leaves(params), tree_leaves(_names(params)))
             if name in PROJECTIONS]
    assert carried and max(carried) <= bound < min(sizes), (max(carried), bound, min(sizes))
