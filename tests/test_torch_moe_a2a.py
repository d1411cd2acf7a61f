"""The port's expert-parallel MoE block (``repro_torch.models.moe.apply_moe_a2a``,
reached through the ``apply_moe`` selector with ``moe.impl = "a2a"``)
against the reference's ``apply_moe_a2a`` on XLA host meshes, in
``tests/moe_check.py``'s setup (granite smoke, experts padded to 8, float32).

The reference runs in a subprocess with 8 host devices
(``tests/torch_moe_a2a_check.py reference``), started when the module
starts: on its ``(2, 4)`` mesh, on a ``(2, 2)`` mesh, and on a ``(1, 4)``
mesh for each half of the batch. The port runs on 4 gloo ranks (one expert
group taking the ``(2, 4)`` mesh's two halves in turn, and the ``(2, 2)``
layout with a data-parallel group across its two expert groups), and with
the 4 expert ranks in one process (a stacked exchange). Each rank takes
the reference's shard and its experts. At capacity factor 8 (nothing drops)
and 1 (records drop at both stages): every shard's ``y`` within rtol 1e-5 and an atol of 1e-5 of the largest
``|y|``;
``moe_aux`` (the mean of the ranks' terms) within 1e-6 of the reference's
for the same tokens; the drop fractions equal; the gradients of ``Σy²``
as close to ``jax.grad``'s (summed over the ranks and halves that hold a
copy). Also: ``_dispatch_to_buckets`` against the reference's, and the
selector's choice of path.
"""

from __future__ import annotations

import concurrent.futures
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_moe_a2a_check as chk
import torch_train_dp_check as spawner
from repro.models import moe as ref_moe

from repro_torch.core.query_engine import RankSet
from repro_torch.models import moe

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 on both sides, the expert products' terms added in other orders
# (XLA's dot, torch's bmm): held to rtol 1e-5 and an atol of 1e-5 of the
# largest magnitude of the compared array (|y| reaches ~60 here, and an
# entry near 0 is the difference of terms that large)
TOL = 1e-5
AUX_TOL = 1e-6


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * float(np.abs(want).max()))
CFS = chk.CAPACITY_FACTORS


class Runs:
    """The reference subprocess and the port's 4 gloo ranks (spawned from a
    thread), started together once the reference has written its inputs."""

    def __init__(self, tmp):
        path = str(tmp / "reference.pkl")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
                   JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "tests",
                                                            "torch_moe_a2a_check.py"),
                               "reference", path], env=env, cwd=ROOT, capture_output=True,
                              text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(path, "rb") as f:
            self.ref = pickle.load(f)
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.gloo = self.pool.submit(spawner.spawn, 4, chk.case_a2a,
                                     params=self.ref["params"], x=self.ref["x"])
        self._hosted = None

    def hosted(self) -> dict:
        if self._hosted is None:
            self._hosted = chk.case_a2a(0, 1, self.ref["params"], self.ref["x"], hosted=True)
        return self._hosted


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = Runs(tmp_path_factory.mktemp("moe_a2a"))
    yield r
    r.pool.shutdown(wait=True)


def _rows(runs, how: str, cf: float) -> list:
    """``[row][rank]`` results: row ``i`` is the expert group's run on half
    ``i`` of the batch."""
    if how == "hosted":
        return [runs.hosted()[(cf, f"row{i}")] for i in (0, 1)]
    ranks = runs.gloo.result()
    return [[r[(cf, f"row{i}")] for r in ranks] for i in (0, 1)]


def _unpack(rows, how):
    """Per row, per rank: (y, aux, drop, grads)."""
    out = []
    for row in rows:
        if how == "hosted":
            out.append([(row["y"][j], row["moe_aux"][j], row["moe_drop_frac"][j],
                         row["grads"][j]) for j in range(4)])
        else:
            out.append([(r["y"][0], r["moe_aux"][0], r["moe_drop_frac"][0], r["grads"][0])
                        for r in row])
    return out


@pytest.mark.parametrize("how", ["gloo", "hosted"])
@pytest.mark.parametrize("cf", CFS)
def test_a2a_on_an_expert_group_of_four_gives_the_reference(cf, how, runs):
    ref = runs.ref
    want = ref[(cf, "2x4")]
    rows = _unpack(_rows(runs, how, cf), how)
    for i, row in enumerate(rows):
        half = ref[(cf, f"row{i}")]
        for j, (y, aux, drop, _) in enumerate(row):
            close(y, chk.shard(want["y"], 2, 4, i, j))
            assert drop == half["moe_drop_frac"]
        np.testing.assert_allclose(np.mean([r[1] for r in row]), half["moe_aux"],
                                   rtol=AUX_TOL, atol=AUX_TOL)
    # the (2, 4) mesh's pmean over both groups; its aux is the whole batch's
    assert (rows[0][0][2] + rows[1][0][2]) / 2 == want["moe_drop_frac"]
    if cf == 8.0:
        assert want["moe_drop_frac"] == 0.0
    else:
        assert want["moe_drop_frac"] > 0 and ref[(cf, "row0")]["moe_drop_frac"] > 0
    # gradients of Σy² over the whole batch: the router's summed over every
    # rank and half; each rank's experts' over both halves
    e_local = ref["params"]["wi"].shape[0] // 4
    router = sum(r[3]["router"] for row in rows for r in row)
    close(router, want["grads"]["router"])
    for j in range(4):
        for k in ("wi", "wg", "wo"):
            got = rows[0][j][3][k] + rows[1][j][3][k]
            close(got, want["grads"][k][j * e_local:(j + 1) * e_local])


@pytest.mark.parametrize("cf", CFS)
def test_a2a_with_a_data_parallel_group_gives_the_reference_2x2_mesh(cf, runs):
    """Two expert groups of 2 gloo ranks with a data-parallel group across
    them: the global load-balance loss and drop fraction."""
    want = runs.ref[(cf, "2x2")]
    ranks = [r[(cf, "2x2")] for r in runs.gloo.result()]
    for rank, r in enumerate(ranks):
        i, j = divmod(rank, 2)
        close(r["y"][0], chk.shard(want["y"], 2, 2, i, j))
        assert r["moe_drop_frac"][0] == want["moe_drop_frac"]
    np.testing.assert_allclose(np.mean([r["moe_aux"][0] for r in ranks]), want["moe_aux"],
                               rtol=AUX_TOL, atol=AUX_TOL)
    e_local = runs.ref["params"]["wi"].shape[0] // 2
    close(sum(r["grads"][0]["router"] for r in ranks), want["grads"]["router"])
    for j in range(2):
        for k in ("wi", "wg", "wo"):
            got = ranks[j]["grads"][0][k] + ranks[2 + j]["grads"][0][k]
            close(got, want["grads"][k][j * e_local:(j + 1) * e_local])


def test_hosted_and_gloo_ranks_agree_bit_for_bit(runs):
    """The stacked exchange and ``all_to_all_single`` move the same rows."""
    for cf in CFS:
        gloo = _unpack(_rows(runs, "gloo", cf), "gloo")
        hosted = _unpack(_rows(runs, "hosted", cf), "hosted")
        for g_row, h_row in zip(gloo, hosted):
            for g, h in zip(g_row, h_row):
                assert np.array_equal(g[0], h[0]) and g[2] == h[2]


@pytest.mark.parametrize("n,n_buckets,cap", [(40, 4, 6), (40, 4, 20), (7, 3, 1)])
def test_dispatch_to_buckets_equals_the_reference(n, n_buckets, cap):
    rng = np.random.default_rng(n + cap)
    keys = rng.integers(0, n_buckets + 1, n).astype(np.int32)  # n_buckets: dropped
    vals = rng.standard_normal((n, 3)).astype(np.float32)
    rb, ro, rf, rok = ref_moe._dispatch_to_buckets(jnp.asarray(vals), jnp.asarray(keys),
                                                   n_buckets, cap)
    pb, po, pf, pok = moe._dispatch_to_buckets(torch.as_tensor(vals),
                                               torch.as_tensor(keys).long(), n_buckets, cap)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(po.numpy(), np.asarray(ro))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(rok))


def test_the_selector_takes_the_a2a_path_only_when_it_can(monkeypatch):
    """``impl="a2a"`` with an expert group that divides the sequence: the
    a2a path; a decode step (S = 1), no group, or ``impl="gspmd"``: GSPMD."""
    taken = []
    monkeypatch.setattr(moe, "apply_moe_a2a", lambda *a, **k: taken.append("a2a"))
    monkeypatch.setattr(moe, "apply_moe_gspmd", lambda *a, **k: taken.append("gspmd"))
    cfg = chk._config(8.0)
    ep = RankSet(torch.device("cpu"), ranks=4)
    x8, x1 = torch.zeros(2, 8, 4), torch.zeros(2, 1, 4)
    moe.apply_moe({}, x8, cfg, ep=ep)
    moe.apply_moe({}, x1, cfg, ep=ep)
    moe.apply_moe({}, x8, cfg)
    import dataclasses
    gspmd = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="gspmd"))
    moe.apply_moe({}, x8, gspmd, ep=ep)
    assert taken == ["a2a", "gspmd", "gspmd", "gspmd"]
