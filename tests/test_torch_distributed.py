"""The port's edge-sharded backend against the JAX reference's, on the CPU.

The reference (``repro.core.distributed``) runs on a 4-device host mesh in a
subprocess (``tests/torch_dist_check.py reference``); the port
(``repro_torch.core.distributed``) runs on 4 gloo ranks with the
reference's permutations injected. Both take ego-facebook at scale 0.05 and
``SummaryConfig(T=5, k_frac=0.3)``. The port is held against the reference's
per-round ``step`` (its while-loop ``chunk`` parts from ``step`` by one ulp
of fusion on this jax, so it is not a reference here).

What must match, for both groupings (and the compact one without the lean
sort) over 5 rounds: ``node2super``, ``size``
and the integer stats exactly, no bucket overflow, ``size_bits`` and ``re1``
within ``rtol=1e-5``. The θ = ∞ round equals the single-device
``summary_metrics``; the distributed sparsification's drop mask equals the
single-device ``further_sparsify``'s, pair for pair. Smaller pieces (the
ownership hash, the shard layout, the exchange of large ids, the radix
selection) are held against the reference in this process.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_check as tdc
from repro.core import distributed as rdist
from repro.core import sparsify as rsparsify
from repro.dist.sharding import MeshRules, owner_hash_np
from repro.graphs import feed as rfeed

from repro_torch.core import costs, sparsify
from repro_torch.core import distributed as pdist
from repro_torch.core.convert import ReplayRoundPermutations, state_from_numpy
from repro_torch.core.types import init_state
from repro_torch.dist import owner_hash
from repro_torch.graphs import feed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
INT_KEYS = ("nmerges", "num_supernodes", "num_superedges", "overflow")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's record (``tests/torch_dist_check.py reference``)."""
    tmp = tmp_path_factory.mktemp("torch_dist_ref")
    out = tmp / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "torch_dist_check.py"),
                           "reference", str(out), str(tmp / "g.txt")],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    rec = dict(np.load(out))
    for g in tdc.GROUPINGS:
        keys = [str(k) for k in rec[f"{g}_keys"]]
        rec[f"{g}_rounds"] = [dict(zip(keys, row)) for row in rec[f"{g}_stats"]]
    return rec


@pytest.fixture(scope="module")
def port(ref):
    """The port on 4 gloo ranks (``case_parity``), one result a rank."""
    return tdc.spawn(tdc.N_DEV, "case_parity", ref_npz=_npz_path(ref),
                     cache_dir=str(ref["cache_dir"]))


def _npz_path(ref) -> str:
    path = os.path.join(os.path.dirname(str(ref["cache_dir"])), "ref.npz")
    assert os.path.exists(path)
    return path


def _check_rounds(got: dict, ref: dict, grouping: str, label: str) -> None:
    for t in range(tdc.ROUNDS):
        want = ref[f"{grouping}_rounds"][t]
        st = got["stats"][t]
        np.testing.assert_array_equal(got["node2super"][t], ref[f"{grouping}_node2super"][t],
                                      err_msg=f"{label} round {t + 1} node2super")
        np.testing.assert_array_equal(got["size"][t], ref[f"{grouping}_size"][t],
                                      err_msg=f"{label} round {t + 1} size")
        for k in INT_KEYS:
            assert st[k] == want[k], (label, t + 1, k, st[k], want[k])
        assert st["overflow"] == 0, (label, t + 1)
        for k in ("size_bits", "re1"):
            np.testing.assert_allclose(st[k], want[k], rtol=RTOL, atol=1e-12,
                                       err_msg=f"{label} round {t + 1} {k}")


@pytest.mark.parametrize("grouping", list(tdc.GROUPINGS))
def test_rounds_match_the_reference(port, ref, grouping):
    """Five rounds of ``step`` on 4 ranks: the reference's partition and
    integer stats exactly, the float stats within rtol; every rank holds
    the same state."""
    _check_rounds(port[0][grouping], ref, grouping, f"{grouping} rank 0")
    assert sum(port[0][grouping]["stats"][t]["nmerges"] for t in range(tdc.ROUNDS)) > 0
    for r in range(1, tdc.N_DEV):
        for t in range(tdc.ROUNDS):
            np.testing.assert_array_equal(port[r][grouping]["node2super"][t],
                                          port[0][grouping]["node2super"][t])
            assert port[r][grouping]["stats"][t] == port[0][grouping]["stats"][t]


def test_compact_without_a_group_matches_the_reference(ref):
    """The compact grouping's groups are the same on every rank, so one
    process with no process group (a world of one) takes the reference's
    4-device partition too."""
    be = tdc._backend(1, 0, "compact", ReplayRoundPermutations(ref["compact_h"]))
    assert be.group.size == 1 and not be.group.active
    _check_rounds(tdc._rounds(be), ref, "compact", "world of one")


def test_external_groups_step_equals_the_fused_step():
    """``make_grouping_fn`` and a step built with ``external_groups=True``
    give the fused compact step's round (a world of one, no group)."""
    from repro_torch.core.types import SummaryConfig

    src, dst, v = tdc.graph()
    cfg = SummaryConfig(T=tdc.ROUNDS, k_frac=0.3)
    shard = feed.shard_edges(src, dst, 0, 1, device="cpu")
    kw = dict(capacity_factor=tdc.CAP_COMPACT, device="cpu")
    fused = pdist.make_distributed_step_compact(cfg, v, len(src), lean_sort=True, **kw)
    ext = pdist.make_distributed_step_compact(cfg, v, len(src), lean_sort=True,
                                              external_groups=True, **kw)
    grouping = pdist.make_grouping_fn(cfg, v, lean_sort=True, device="cpu")
    state = init_state(v, "cpu")
    for theta in (1e9, 0.2):
        s1, st1 = fused(shard.src, shard.dst, state, theta, 1)
        s2, st2 = ext(shard.src, shard.dst, state, theta, 1,
                      grouping(shard.src, shard.dst, state))
        assert torch.equal(s1.node2super, s2.node2super)
        assert {k: float(x) for k, x in st1.items()} == {k: float(x) for k, x in st2.items()}
    assert float(st2["nmerges"]) > 0
    with pytest.raises(ValueError, match="external_groups"):
        fused(shard.src, shard.dst, state, 0.2, 1, grouping(shard.src, shard.dst, state))


@pytest.mark.parametrize("grouping", ["compact", "hash"])
def test_theta_infinity_equals_single_device_metrics(port, ref, grouping):
    """With no merge possible the round's metrics are the single-device
    ``summary_metrics`` of the whole graph."""
    src, dst, v = tdc.graph()
    state = init_state(v, "cpu")
    pt = costs.build_pair_table(torch.as_tensor(src), torch.as_tensor(dst), state)
    m = costs.summary_metrics(pt, state, v, len(src))
    got = port[0][grouping]["inf"]
    np.testing.assert_allclose(got["size_bits"], float(m["size_bits"]), rtol=RTOL)
    np.testing.assert_allclose(got["re1"], float(m["re1"]), rtol=RTOL, atol=1e-9)
    assert got["num_superedges"] == float(m["num_superedges"])
    assert got["nmerges"] == 0 and got["overflow"] == 0
    assert got["num_superedges"] == ref[f"{grouping}_inf_num_superedges"]


@pytest.mark.parametrize("case", ["k=0.9 size", "xi=0", "drop-all", "error_p=2"])
def test_sparsify_drop_mask_matches_single_device(port, case):
    """The distributed drop mask, gathered from the 4 ranks as a
    ``{(lo, hi): dropped}`` map, is the single-device ``further_sparsify``'s;
    no pair is owned twice; ``size_bits`` is equal."""
    src, dst, v = tdc.graph()
    n2s, size = port[0]["hash"]["state"]
    state = state_from_numpy(n2s, size, tdc.ROUNDS + 1, "cpu")
    k_bits, stats, _ = port[0]["sparsify"][case]
    error_p = 2 if case == "error_p=2" else 1
    pt = costs.build_pair_table(torch.as_tensor(src), torch.as_tensor(dst), state)
    drop, after = sparsify.further_sparsify(pt, state, v, len(src), k_bits, error_p=error_p)
    valid = (pt.valid & (after["keep"] | drop)).numpy()
    want = {(int(a), int(b)): bool(d) for a, b, d in zip(
        pt.lo.numpy()[valid], pt.hi.numpy()[valid], drop.numpy()[valid])}
    got = {}
    for r in range(tdc.N_DEV):
        _, st_r, pairs = port[r]["sparsify"][case]
        assert st_r == stats, (case, "stats differ between ranks")
        mine = pairs["mine"] & (pairs["keep"] | pairs["drop"])
        for a, b, d in zip(pairs["lo"][mine], pairs["hi"][mine], pairs["drop"][mine]):
            assert (int(a), int(b)) not in got, (case, "pair owned twice", a, b)
            got[(int(a), int(b))] = bool(d)
    assert got == want, (case, sum(got.get(k) != want.get(k) for k in want))
    assert stats["size_bits"] == float(after["size_bits"]), case
    for k in ("re1", "re2", "num_superedges"):
        np.testing.assert_allclose(stats[k], float(after[k]), rtol=1e-6, atol=1e-12,
                                   err_msg=f"{case} {k}")
    assert stats["overflow"] == 0
    if case == "xi=0":
        assert stats["dropped"] == 0
    else:
        assert stats["dropped"] > 0


@pytest.mark.parametrize("path", ["memory", "cache"])
def test_shards_match_the_reference(port, ref, path):
    """Rank r's shard is the reference's shard r (the device whose
    ``axis_index`` is r), and the feed stages one shard of host memory."""
    for r in range(tdc.N_DEV):
        src_l, dst_l, stats = port[r][f"{path}_shard"]
        np.testing.assert_array_equal(src_l, ref[f"{path}_src"][r])
        np.testing.assert_array_equal(dst_l, ref[f"{path}_dst"][r])
        assert stats["peak_staging_bytes"] == stats["shard_bytes"] == 4 * len(src_l)
        for k in ("num_edges", "padded_edges", "n_devices", "shard_rows", "shard_bytes",
                  "peak_staging_bytes"):
            assert stats[k] == int(ref[f"{path}_stat_{k}"]), (path, k)
        assert stats["bytes_copied"] == 2 * stats["shard_bytes"]
        assert stats["path"] == ("cache-mmap" if path == "cache" else "memory")


@pytest.mark.parametrize("n_ranks", [1, 2, 4, 8])
def test_owner_hash_matches_the_reference(n_ranks):
    rng = np.random.default_rng(n_ranks)
    ids = np.concatenate([np.arange(1000), rng.integers(0, 2**31 - 1, 4000),
                          [2**24, 2**24 + 1, 2**31 - 1]]).astype(np.int64)
    rules = MeshRules(mesh=SimpleNamespace(size=n_ranks), mode="summarize", table={})
    for salt in (0, 1, 7, 2**31 + 5, 2**32 - 1):
        got = owner_hash(torch.as_tensor(ids), salt, n_ranks).numpy()
        np.testing.assert_array_equal(got, owner_hash_np(ids, salt, n_ranks))
        want = rules.owner(jnp.asarray(ids.astype(np.int32)), jnp.uint32(salt))
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("num_edges,n_ranks", [(3585, 4), (10, 3), (2, 8), (12, 4),
                                                (1, 1)])
def test_shard_layout_matches_the_reference(num_edges, n_ranks, tmp_path):
    assert feed.shard_layout(num_edges, n_ranks) == rfeed.shard_layout(num_edges, n_ranks)
    rows, padded = feed.shard_layout(num_edges, n_ranks)
    src = np.arange(num_edges, dtype=np.int32)
    dst = src + 1
    full = np.full(padded, -1, np.int32)
    full[:num_edges] = src
    for r in range(n_ranks):
        sh = feed.shard_edges(src, dst, r, n_ranks, device="cpu")
        np.testing.assert_array_equal(sh.src.numpy(), full[r * rows:(r + 1) * rows])
        assert sh.stats.peak_staging_bytes == rows * 4


def test_exchange_keeps_ids_above_2_24_exact():
    """The port's int32 records carry supernode ids near 2²⁵ through route
    and aggregate exactly (the buckets are moved between 4 ranks here by
    hand, as ``all_to_all_single`` moves them); the reference's float32
    records round them."""
    v = 2**25 + 100  # only the sentinel is V-sized
    base = 2**25 - 7
    n_ranks, cap = 4, 16
    shards = []
    for r in range(n_ranks):
        lo = torch.tensor([base, base + 1, base + 3, 5, base + 1, base + 3]) + r % 2
        hi = lo + torch.tensor([0, 2, 9, 2**24 + 3, 2, 0])
        cnt = torch.tensor([1, 2, 3, 4, 5, 6], dtype=torch.int64)
        valid = torch.tensor([True, True, True, True, True, False])
        shards.append((lo, hi, cnt, valid))
    bucks = []
    for lo, hi, cnt, valid in shards:
        b, of = pdist._route(lo, hi, cnt, valid, owner_hash(lo, 3, n_ranks), n_ranks, cap)
        assert int(of) == 0
        bucks.append(b)
    want: dict = {}
    for lo, hi, cnt, valid in shards:
        for a, b, c, ok in zip(lo.tolist(), hi.tolist(), cnt.tolist(), valid.tolist()):
            if ok:
                want[(a, b)] = want.get((a, b), 0) + c
    got = {}
    for d in range(n_ranks):
        recv = torch.stack([bucks[s][d] for s in range(n_ranks)])  # all_to_all
        glo, ghi, gcnt, gvalid = pdist._aggregate(recv.reshape(-1, 3), v)
        for a, b, c in zip(glo[gvalid].tolist(), ghi[gvalid].tolist(), gcnt[gvalid].tolist()):
            assert (a, b) not in got
            got[(a, b)] = int(c)
    assert got == want
    assert max(b for _, b in got) > 2**25
    # the reference's float32 bucket rounds these ids
    lo, hi, cnt, valid = shards[0]
    rb, _ = rdist._route(jnp.asarray(lo.numpy(), jnp.int32), jnp.asarray(hi.numpy(), jnp.int32),
                         jnp.asarray(cnt.numpy(), jnp.float32), jnp.asarray(valid.numpy()),
                         jnp.zeros(6, jnp.int32), 1, cap)
    ids = np.asarray(rb).reshape(-1, 3)[:5, :2].astype(np.int64)
    assert not np.array_equal(np.sort(ids.ravel()),
                              np.sort(np.stack([lo[:5].numpy(), hi[:5].numpy()], 1).ravel()))


def test_radix_select_equals_a_sort_at_every_k():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 100, 300), rng.integers(-3, 4, 200),
                        [0.0, -0.0, 1e-40, -1e-40, np.inf, -np.inf]]).astype(np.float32)
    valid = rng.random(x.size) < 0.8
    keys = sparsify.ordered_key_from_f32(torch.as_tensor(x))
    order = np.sort(keys.numpy()[valid])
    rkeys = rsparsify.ordered_key_from_f32(jnp.asarray(x))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(rkeys).astype(np.int64))
    vt = torch.as_tensor(valid)
    for k in range(order.size):
        got = sparsify.radix_select_kth(keys, vt, torch.tensor(k))
        assert int(got) == int(order[k]), k
        if k % 37 == 0:
            want = rsparsify.radix_select_kth(rkeys, jnp.asarray(valid), jnp.int32(k))
            assert int(got) == int(want), k
    # split over 3 "ranks" in threads; each pass's histograms are summed
    # as all_reduce(SUM) sums them
    parts = np.array_split(np.arange(x.size), 3)
    for k in (0, 17, order.size - 1):
        barrier = threading.Barrier(3)
        deposit: dict = {}
        out = [None] * 3

        def run(i, k=k, barrier=barrier, deposit=deposit, out=out):
            def reduce_hist(h):
                deposit[i] = h
                barrier.wait()
                total = sum(deposit[j] for j in range(3))
                barrier.wait()
                return total

            idx = torch.as_tensor(parts[i])
            out[i] = int(sparsify.radix_select_kth(keys[idx], vt[idx], torch.tensor(k),
                                                   reduce_hist))

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert out == [int(order[k])] * 3, k
    assert sparsify.select_delta_xi(torch.as_tensor(x), vt, torch.tensor(5)).item() == \
        np.sort(x[valid])[4]


def test_ordered_keys_round_trip_and_keep_the_order():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(0, 1e6, 500).astype(np.float32),
                        np.array([0.0, -0.0, 1e-45, -1e-45, 3.4e38, -3.4e38, np.inf, -np.inf],
                                 np.float32)])
    keys = sparsify.ordered_key_from_f32(torch.as_tensor(x))
    back = sparsify.f32_from_ordered_key(keys).numpy()
    np.testing.assert_array_equal(back.view(np.int32), x.view(np.int32))
    np.testing.assert_array_equal(
        np.asarray(rsparsify.f32_from_ordered_key(jnp.asarray(keys.numpy().astype(np.uint32)))),
        back)
    k = keys.numpy()
    assert np.unique(k).size == k.size  # injective, -0.0 below +0.0
    assert (np.diff(x[np.argsort(k)].astype(np.float64)) >= 0).all()  # monotone
    assert (k >= 0).all() and (k < 2**32).all()


def test_reference_record_is_sound(ref):
    """The reference itself: no overflow, progress, a shrinking size."""
    for g in tdc.GROUPINGS:
        rounds = ref[f"{g}_rounds"]
        assert all(r["overflow"] == 0 for r in rounds)
        assert sum(r["nmerges"] for r in rounds) > 0
        sizes = [r["size_bits"] for r in rounds]
        assert sizes == sorted(sizes, reverse=True)
