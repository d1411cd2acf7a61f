"""Tensor-parallel compute of the hybrid, xLSTM, encoder-decoder and VLM
families (``mamba2.ssd_forward_tp``, ``xlstm.mlstm_forward_tp`` and
``slstm_forward_tp``, ``attention.cross_attend_tp``, whisper's blocks, the
VLM's backbone under ``--want-model``) against the reference's trainer on
(data, model) XLA host meshes.

The reference side runs in two subprocesses with 4 XLA host devices
(``tests/torch_train_tp_families_check.py reference``), started when the
module's first test starts; the port's side on 4 spawned gloo ranks. Both
start from the reference's weights.

* zamba2 and xLSTM smoke (2 heads, and 4 heads so that (1, 4) splits them)
  through the trainer, whisper and paligemma smoke through
  ``build_train_step`` with batch dicts made with numpy from a seed, at
  ``--want-model`` 2 (data 2, model 2) and 4 (data 1, model 4): per-step
  losses within rtol 1e-5 of the reference's; the final AdamW first moments
  (the running mean of every step's gradients) within 1e-3 of each leaf's
  largest |value| (``PARAM_TOL``, as in ``tests/test_torch_train_tp.py``);
  the final global parameters within the same, each leaf that is not
  constant at initialisation (:func:`_held_params`); every rank holds the
  same global state; every rank's stored shard is the reference device's.
* At model 4, each rank's products read only its part: the rows of
  ``out_proj``, ``down``, ``ffn_wo``, the MLPs' ``wo`` and attention's
  ``wo`` that reach a rank's product are a quarter of the leaf's, and
  Mamba2's ``in_proj`` product has the rank's columns (``torch.matmul``'s
  right operands recorded over one forward on each rank).
* Each new block's ranks in one process (``models/tp_ranks.py``) against
  the unsplit block at m = 2 and 4: forward and the gradients of Σy².
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_train_dp_check as dp_chk
import torch_train_tp_families_check as chk
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.api import build_model as ref_build_model

from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, tp_ranks, whisper, xlstm

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5  # tests/test_torch_train_tp.py's
PARAM_TOL = 1e-3  # of each leaf's largest |value|, tests/test_torch_train_tp.py's
# a block's ranks in one process against the unsplit block (float32): the
# forward to rtol 1e-5 and 1e-5 of its largest |y|, the gradients to 1e-5 of
# each leaf's largest |g| (tests/test_torch_train_tp.py's)
Y_RTOL, TOL = 1e-5, 1e-5
CASES = [c for part in chk.CASES for c in part]


def _ids(case):
    arch, want_model, heads = case
    return f"{arch}-model{want_model}" + ("" if heads is None else f"-{heads}heads")


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "XLA_FLAGS"):
        env.pop(k, None)
    return env


@functools.lru_cache(maxsize=None)
def ref_weights() -> dict:
    """The reference weights (``model.init(PRNGKey(0))``) of every case's
    config, numpy, by ``(arch, heads)``."""
    out = {}
    for arch, _, heads in CASES:
        if (arch, heads) not in out:
            cfg = chk.config(ref_smoke_config, arch, heads)
            out[(arch, heads)] = jax.tree.map(
                np.asarray, ref_build_model(cfg).init(jax.random.PRNGKey(0)))
    return out


class Runs:
    """The reference's two parts (subprocesses) and the port's runs on 4
    gloo ranks (spawned from a thread), started with the module."""

    def __init__(self, tmp):
        self.paths = [str(tmp / f"part{i}.pkl") for i in (0, 1)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_train_tp_families_check.py"),
             "reference", str(i), self.paths[i]], env=_env(), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in (0, 1)]
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.port = self.pool.submit(dp_chk.spawn, chk.WORLD, chk.case_train,
                                     weights=ref_weights())
        self.merged = {}

    def reference(self) -> dict:
        if not self.merged:
            for proc, path in zip(self.procs, self.paths):
                _, err = proc.communicate(timeout=900)
                assert proc.returncode == 0, err[-3000:]
                with open(path, "rb") as f:
                    self.merged.update(pickle.load(f))
        return self.merged

    def ranks(self, case) -> list:
        i = CASES.index(case)
        return [rank[i] for rank in self.port.result()]

    def close(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        self.pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = Runs(tmp_path_factory.mktemp("train_tp_families_reference"))
    yield r
    r.close()


# ---------------------------------------------------------------------------
# The trainer's step against the reference's
# ---------------------------------------------------------------------------


def _close(got, want, tol=PARAM_TOL) -> bool:
    return all(np.allclose(g, w, rtol=0, atol=tol * max(float(np.abs(w).max()), 1e-30))
               for g, w in zip(got, want))


def _leaf_names(case) -> list[str]:
    tree = ref_weights()[(case[0], case[2])]
    return [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _held_params(case) -> list[bool]:
    """Per leaf (tree order), whether its final parameters are held to
    ``PARAM_TOL``: every leaf that is not constant at initialisation. A
    constant leaf (zero biases, norm scales, sLSTM's ``b``) holds after 3
    steps only AdamW's normalised steps, each about ``lr`` whatever the
    gradient's size, so an element whose gradient is small turns rounding
    into a change of the order of its values: xLSTM smoke's ``layer_1.b``
    and ``layer_0.ln.scale`` part from the reference by 3.8e-3 and 8.4e-3
    of their largest |value| on one device with no tensor parallelism, and
    the reference's own (2, 2) and (1, 4) runs part by 5.1e-3. Such a leaf
    is held through its first moment, as every leaf is."""
    return [w.size == 1 or float(np.ptp(w)) > 0
            for w in jax.tree.leaves(ref_weights()[(case[0], case[2])])]


def _hold_state(got: dict, want: dict, case) -> None:
    """The first moments within ``PARAM_TOL`` of each leaf's largest |mu|
    (attention's ``bk``, whose gradient is 0 in exact arithmetic, of the
    model's largest), the parameters of :func:`_held_params`' leaves within
    ``PARAM_TOL`` of each leaf's largest |value|."""
    top = max(float(np.abs(w).max()) for w in want["mu"])
    for name, g, w, held, gp, wp in zip(_leaf_names(case), got["mu"], want["mu"],
                                        _held_params(case), got["params"], want["params"]):
        scale = top if name.endswith("['bk']") else float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_TOL * max(scale, 1e-30),
                                   err_msg=f"first moment of {name}")
        if held:
            assert _close([gp], [wp]), name


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_each_family_on_a_data_model_mesh_tracks_the_reference(case, runs):
    ranks = runs.ranks(case)
    want = runs.reference()[case]
    got = ranks[0]
    assert got["mesh"] == want["mesh"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    _hold_state(got, want, case)
    for other in ranks[1:]:  # every rank returns the same losses; rank 0 the global state
        assert other["losses"] == got["losses"]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_every_rank_stores_the_reference_devices_shard(case, runs):
    """Each rank's stored shard has the index of the reference device's
    shard, holds exactly that part of the port's final global leaf, and is
    within ``PARAM_TOL`` of the reference's where :func:`_held_params`
    holds the leaf."""
    want = runs.reference()[case]
    ranks = runs.ranks(case)
    for r, rank in enumerate(ranks):
        assert len(rank["shards"]) == len(want["index"])
        for shard, index, full, mine, held in zip(rank["shards"], want["index"], want["params"],
                                                  ranks[0]["params"], _held_params(case)):
            sl = tuple(slice(a, b) for a, b in index[r])
            assert shard.shape == full[sl].shape, (r, index[r])
            assert np.array_equal(shard, mine[sl])
            assert not held or _close([shard], [full[sl]])
        assert rank["stored"] == sum(s.nbytes + 8 * s.size for s in rank["shards"])


# ---------------------------------------------------------------------------
# No block computes the whole step
# ---------------------------------------------------------------------------


def _row_parallel(cfg) -> tuple[dict, dict]:
    """For a family's smoke config: the global row count of each leaf whose
    product is row-parallel (its output has ``d_model`` columns) by name,
    and the number of such products in one forward by name."""
    d, h, hd, n = cfg.d_model, cfg.n_heads, cfg.hd, cfg.n_layers
    if cfg.family == "hybrid":
        sites = n // cfg.attn_every
        return ({"out_proj": mamba2.dims(cfg)[1], "attention wo": h * hd, "mlp wo": cfg.d_ff},
                {"out_proj": n, "attention wo": sites, "mlp wo": sites})
    if cfg.family == "xlstm":
        return ({"down": xlstm.mlstm_dims(cfg)[1], "ffn_wo": xlstm._ffn_width(d)},
                {"down": n // 2, "ffn_wo": n // 2})
    if cfg.family == "encdec":
        layers = cfg.enc_layers + cfg.n_layers
        return ({"attention wo": h * hd, "mlp wo": cfg.d_ff},
                {"attention wo": layers + cfg.n_layers, "mlp wo": layers})
    return {"attention wo": h * hd, "mlp wo": cfg.d_ff}, {"attention wo": n, "mlp wo": n}


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == 4 and c[:1] + c[2:] != (
    chk.XLSTM, None)], ids=_ids)
def test_at_model_4_each_rank_multiplies_only_its_part(case, runs):
    """No product into ``d_model`` reads a row-parallel leaf's whole rows,
    and each row-parallel product shows up with a quarter of them as often
    as the forward has it; Mamba2's ``in_proj`` product has the rank's
    ``z``, ``x``, ``dt`` columns and all of ``B`` and ``C``."""
    cfg = chk.config(get_smoke_config, case[0], case[2])
    d = cfg.d_model
    rows, count = _row_parallel(cfg)
    for rank in runs.ranks(case):
        shapes = rank["shapes"]
        into_d = [s[0] for s in shapes if len(s) == 2 and s[1] == d]
        assert not set(into_d) & set(rows.values()), (sorted(set(into_d)), rows)
        for name, k in rows.items():
            same = [j for j, c in rows.items() if c // 4 == k // 4]
            assert into_d.count(k // 4) >= sum(count[j] for j in same), name
        if cfg.family == "hybrid":
            _, di, hh, _, ns = mamba2.dims(cfg)
            assert shapes.count((d, 2 * di // 4 + 2 * ns + hh // 4)) == cfg.n_layers


# ---------------------------------------------------------------------------
# Each block's ranks in one process against the unsplit block
# ---------------------------------------------------------------------------


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def _hold(split, whole, inputs, p, zero_grad=()):
    """``split()`` against ``whole()``: the forward, and the gradients of
    Σy² for ``inputs`` and every leaf of ``p``. A leaf named in
    ``zero_grad`` has a gradient that is 0 in exact arithmetic (attention's
    ``bk`` shifts every score of a row alike): its rounding is held to 1e-5
    of the block's largest gradient."""
    named = [(f"input{i}", x) for i, x in enumerate(inputs)] + _named(p)
    leaves = [x for _, x in named]

    def run(fn):
        y = fn()
        return y.detach(), torch.autograd.grad((y.float() ** 2).sum(), leaves)

    y, g = run(split)
    y0, g0 = run(whole)
    torch.testing.assert_close(y, y0, rtol=Y_RTOL, atol=TOL * float(y0.abs().max()))
    top = max(float(b.abs().max()) for b in g0)
    for (name, _), a, b in zip(named, g, g0):
        scale = top if name.split("/")[-1] in zero_grad else float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=TOL * scale, msg=name)


def _leaves(tree, gen):
    """``tree``'s leaves as float32 leaves that need gradients; the ones
    ``init`` makes constant (norm scales, biases, ``dt_bias``) get small
    random values, so every path of the block carries a gradient."""
    if isinstance(tree, dict):
        return {k: _leaves(v, gen) for k, v in tree.items()}
    x = tree.detach().float().clone()
    if x.numel() > 1 and float(x.std()) == 0.0:
        x = x + 0.1 * torch.randn(x.shape, generator=gen)
    return x.requires_grad_(True)


@functools.lru_cache(maxsize=None)
def _inputs(d: int):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 16, d), generator=gen).requires_grad_(True)
    return gen, x


def _xlstm4():
    return chk.config(get_smoke_config, chk.XLSTM, 4)


@pytest.mark.parametrize("size", [2, 4])
def test_the_mamba2_blocks_ranks_give_the_unsplit_block(size):
    """8 smoke heads over two chunks of 8 positions."""
    cfg = get_smoke_config(chk.ZAMBA2)
    gen, x = _inputs(cfg.d_model)
    p = _leaves(mamba2.init_mamba2(gen, cfg, torch.float32, "cpu"), gen)
    _hold(lambda: tp_ranks.mamba2_block(p, x, cfg, size, chunk=8),
          lambda: mamba2.ssd_forward(p, x, cfg, chunk=8), [x], p)


@pytest.mark.parametrize("size", [2, 4])
def test_the_mlstm_blocks_ranks_give_the_unsplit_block(size):
    """4 heads over two chunks of 8 positions."""
    cfg = _xlstm4()
    gen, x = _inputs(cfg.d_model)
    p = _leaves(xlstm.init_mlstm(gen, cfg, torch.float32, "cpu"), gen)
    _hold(lambda: tp_ranks.mlstm_block(p, x, cfg, size, chunk=8),
          lambda: xlstm.mlstm_forward(p, x, cfg, chunk=8), [x], p)


@pytest.mark.parametrize("size", [2, 4])
def test_the_slstm_blocks_ranks_give_the_unsplit_block(size):
    cfg = _xlstm4()
    gen, x = _inputs(cfg.d_model)
    p = _leaves(xlstm.init_slstm(gen, cfg, torch.float32, "cpu"), gen)
    _hold(lambda: tp_ranks.slstm_block(p, x, cfg, size),
          lambda: xlstm.slstm_forward(p, x, cfg), [x], p)


def _whisper():
    cfg = get_smoke_config(chk.WHISPER)
    gen, x = _inputs(cfg.d_model)
    enc = torch.randn((2, cfg.enc_len, cfg.d_model), generator=gen).requires_grad_(True)
    return cfg, gen, x, enc


@pytest.mark.parametrize("size", [2, 4])
def test_the_cross_attentions_ranks_give_the_unsplit_cross_attention(size):
    cfg, gen, x, enc = _whisper()
    p = _leaves(attn.init_attention(gen, cfg, dtype=torch.float32, bias=True, device="cpu"),
                gen)
    _hold(lambda: tp_ranks.cross_attention(p, x, enc, cfg, size),
          lambda: attn.cross_attend(p, x, enc), [x, enc], p, zero_grad=("bk",))


@pytest.mark.parametrize("size", [2, 4])
def test_the_plain_mlps_ranks_give_the_unsplit_mlp(size):
    cfg, gen, x, _ = _whisper()
    p = _leaves(whisper.init_plain_mlp(gen, cfg.d_model, cfg.d_ff, torch.float32, "cpu"), gen)
    _hold(lambda: tp_ranks.plain_mlp(p, x, size), lambda: whisper.apply_plain_mlp(p, x), [x], p)


@pytest.mark.parametrize("size", [2, 4])
def test_whispers_encoder_blocks_ranks_give_the_unsplit_block(size):
    cfg, gen, x, _ = _whisper()
    p = _leaves(whisper.init_enc_block(gen, cfg, torch.float32, "cpu"), gen)
    layers = whisper.block_layers(cfg, None, causal=False)
    _hold(lambda: tp_ranks.whisper_encoder_block(p, x, cfg, size),
          lambda: whisper.enc_block(p, x, layers[0], layers[2]), [x], p, zero_grad=("bk",))


@pytest.mark.parametrize("size", [2, 4])
def test_whispers_decoder_blocks_ranks_give_the_unsplit_block(size):
    cfg, gen, x, enc = _whisper()
    p = _leaves(whisper.init_dec_block(gen, cfg, torch.float32, "cpu"), gen)
    _hold(lambda: tp_ranks.whisper_decoder_block(p, x, enc, cfg, size),
          lambda: whisper.dec_block(p, x, enc, *whisper.block_layers(cfg, None, causal=True)),
          [x, enc], p, zero_grad=("bk",))


def test_a_run_that_keeps_no_global_state_is_the_same_run():
    """``train(..., keep_state=False)`` (the launcher's ``main``) gathers no
    final global state: the same losses and stored shards, and no
    ``params``/``opt`` (zamba2-7b's 66 GB of parameters and moments do not
    fit one card whole)."""
    from repro_torch.dist.compress import tree_leaves
    from repro_torch.launch import train

    argv = ["--arch", chk.ZAMBA2, "--smoke", "--steps", "2", "--batch", "4", "--seq", "16",
            "--device", "cpu", "--log-every", "100"]
    kept = train.train(train.parse_args(argv))
    lean = train.train(train.parse_args(argv), keep_state=False)
    assert lean.params is None and lean.opt is None and kept.params is not None
    assert lean.losses == kept.losses
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(lean.shards),
                                                 tree_leaves(kept.shards)))
