"""``repro_torch.core.shingles`` and ``tables`` against the reference on the
states of live reference runs: shingles, candidate groups (given the
reference's permutations), the top-D neighbor tables and the union-space
group tables. ``max_neighbors`` below the max degree exercises the top-D cut
and its ties, which the stable sort has to break as the reference does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import (
    CPU,
    FIXTURES,
    RTOL,
    configs,
    np_,
    port_state,
    ref_group_tables,
    ref_metrics,
    ref_neighbor_tables,
    ref_pair_table,
    ref_state,
    reference_rounds,
    replay,
)

from repro_torch.core import costs as pcosts
from repro_torch.core import shingles as pshingles
from repro_torch.core import tables as ptables
from repro_torch.core.convert import ReplayPermutations, group_tables_from_numpy
from repro_torch.core.types import PairTable
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as pref
from repro_torch.kernels.group_tables import group_tables_cuda, smem_bytes

INT_FIELDS = ("n", "s", "m", "n_u", "cidx", "w", "members")


def _rows(name):
    rg, pg, v, rows = reference_rounds(name)
    return rg, pg, v, [rows[0], rows[len(rows) // 2], rows[-1]]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_shingles_and_groups(name):
    rg, pg, v, rows = _rows(name)
    _, pcfg = configs(name)
    for row in rows:
        h, tie = (jnp.asarray(x) for x in row["perms"])
        rs, ps = ref_state(row), port_state(row)
        th, ttie = (torch.as_tensor(x.astype(np.int64)) for x in row["perms"])
        # the reference's shingle passes, fed the same h
        want_f = h.at[rg.src].min(h[rg.dst]).at[rg.dst].min(h[rg.src])
        np.testing.assert_array_equal(np_(pshingles.node_shingles(pg.src, pg.dst, th)),
                                      np_(want_f))
        want_sh = jnp.full((v,), v, jnp.int32).at[rs.node2super].min(want_f)
        got_sh = pshingles.supernode_shingles(pg.src, pg.dst, ps, th)
        np.testing.assert_array_equal(np_(got_sh), np_(want_sh))
        # the reference's 3-key sort, fed the same tie permutation
        dead = (rs.size <= 0).astype(jnp.int32)
        ids = jnp.arange(v, dtype=jnp.int32)
        _, _, _, order = jax.lax.sort((dead, want_sh, tie, ids), num_keys=3)
        for c in (pcfg.group_size, 7):
            want = np.concatenate([np_(order), -np.ones((-v) % c, np.int32)]).reshape(-1, c)
            np.testing.assert_array_equal(
                np_(pshingles.chunk_groups(got_sh, ps.size, ttie, c)), want)
        groups = pshingles.build_groups(pg.src, pg.dst, ps, replay(row), pcfg.group_size)
        c = pcfg.group_size
        np.testing.assert_array_equal(
            np_(groups),
            np.concatenate([np_(order), -np.ones((-v) % c, np.int32)]).reshape(-1, c))


def test_torch_permutations_are_seeded_and_fresh():
    a = pshingles.TorchPermutations(5, "cpu")
    b = pshingles.TorchPermutations(5, "cpu")
    h1, t1 = a.draw(100, CPU)
    h2, t2 = b.draw(100, CPU)
    assert torch.equal(h1, h2) and torch.equal(t1, t2)
    assert sorted(h1.tolist()) == list(range(100))
    h3, _ = a.draw(100, CPU)
    assert not torch.equal(h1, h3)
    r = ReplayPermutations([(np.arange(4), np.arange(4)[::-1])])
    h, t = r.draw(4, CPU)
    assert h.tolist() == [0, 1, 2, 3] and t.tolist() == [3, 2, 1, 0]
    with pytest.raises(IndexError):
        r.draw(4, CPU)


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("max_neighbors", [64, 4])
def test_neighbor_tables(name, max_neighbors):
    rg, pg, v, rows = _rows(name)
    for row in rows:
        rs, ps = ref_state(row), port_state(row)
        rpt = ref_pair_table(rg.src, rg.dst, rs)
        ppt = pcosts.build_pair_table(pg.src, pg.dst, ps)
        deg = np.bincount(np_(rpt.lo)[np_(rpt.valid) & (np_(rpt.lo) != np_(rpt.hi))],
                          minlength=v)
        if max_neighbors == 4:
            assert deg.max() > max_neighbors  # the cut binds
        want = ref_neighbor_tables(rpt, v, max_neighbors)
        got = ptables.build_neighbor_tables(ppt, v, max_neighbors)
        for g, w, f in zip(got, want, ("nbr_id", "nbr_cnt", "self_cnt")):
            np.testing.assert_array_equal(np_(g), np_(w), err_msg=f)


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("max_neighbors,union_size", [(64, 128), (4, 16)])
def test_group_tables(name, max_neighbors, union_size):
    rg, pg, v, rows = _rows(name)
    rcfg, pcfg = configs(name)
    for row in rows:
        rs, ps = ref_state(row), port_state(row)
        rpt = ref_pair_table(rg.src, rg.dst, rs)
        ppt = pcosts.build_pair_table(pg.src, pg.dst, ps)
        rm = ref_metrics(rpt, rs, v, rg.num_edges)
        pm = pcosts.summary_metrics(ppt, ps, v, pg.num_edges)
        groups = pshingles.build_groups(pg.src, pg.dst, ps, replay(row), pcfg.group_size)
        want = ref_group_tables(rpt, rs, jnp.asarray(np_(groups).astype(np.int32)),
                                          max_neighbors, union_size, rm["cbar"], v)
        scal = torch.stack([pm["cbar"], pcosts.log2_f32(v, CPU)])
        got = ptables.build_group_tables(ppt, ps, groups, max_neighbors, union_size,
                                         scal, v)
        for f in INT_FIELDS:
            np.testing.assert_array_equal(np_(getattr(got, f)), np_(getattr(want, f)),
                                          err_msg=f)
        np.testing.assert_allclose(np_(got.t), np_(want.t), rtol=RTOL)
        assert got.cidx.dtype == torch.int32 and got.m.is_contiguous()
        # the reference's tables carried over give the same operands
        back = group_tables_from_numpy(*(np_(getattr(want, f)) for f in
                                         ("m", "n", "s", "t", "n_u", "cidx", "w",
                                          "members")), device=CPU)
        for f in INT_FIELDS:
            assert torch.equal(getattr(back, f).to(getattr(got, f).dtype),
                               getattr(got, f)), f


# ---------------------------------------------------------------------------
# the group-table kernel (kernels/csrc/group_tables.cu): a numpy model of its
# algorithm, step for step, against the plain version bit for bit
# ---------------------------------------------------------------------------

THREADS, PER_THREAD = 256, 8  # kThreads, kPerThread of the CUDA source
PAD = np.uint32(0xFFFFFFFF)


def _lower_bound(a, n, keys):
    """The kernel's binary search, for many keys at once: the first p in
    [0, n) with a[p] >= key."""
    lo = np.zeros(len(keys), np.int64)
    hi = np.full(len(keys), n, np.int64)
    while np.any(lo < hi):
        act = lo < hi
        mid = (lo + hi) >> 1
        less = np.zeros(len(keys), bool)
        less[act] = a[mid[act]] < keys[act]
        lo = np.where(act & less, mid + 1, lo)
        hi = np.where(act & ~less, mid, hi)
    return lo


def _bitonic(keys):
    """The kernel's bitonic network over a power-of-two array, in place:
    pair p compares a = 2j·(p // j) + p % j with a + j, ascending where
    a & k == 0."""
    n = len(keys)
    k = 2
    while k <= n:
        j = k >> 1
        while j > 0:
            p = np.arange(n // 2)
            a = 2 * j * (p // j) + (p & (j - 1))
            x, y = keys[a].copy(), keys[a + j].copy()
            swap = (x > y) == ((a & k) == 0)
            keys[a[swap]], keys[a[swap] + j] = y[swap], x[swap]
            j >>= 1
        k <<= 1


def _exclusive(x):
    return np.concatenate([[0], np.cumsum(x)[:-1]]), int(np.sum(x))


def kernel_model(nbr_id, nbr_cnt, rows, midx, alive, sizes, u, v):
    """What ``group_tables_kernel`` computes, block by block."""
    nbr_id, nbr_cnt, rows, midx, alive, sizes = (
        np_(x) for x in (nbr_id, nbr_cnt, rows, midx, alive, sizes))
    g_cnt, c = rows.shape
    d = nbr_id.shape[1]
    assert c * d <= THREADS * PER_THREAD and v < 2**31
    m = np.zeros((g_cnt, c, u), np.float32)
    n_u = np.zeros((g_cnt, u), np.float32)
    cidx = np.full((g_cnt, c), u, np.int32)
    w = np.zeros((g_cnt, c, c), np.float32)
    # entry e = t + r·THREADS of thread t: slot e % D of member e // D
    e = np.arange(THREADS)[:, None] + THREADS * np.arange(PER_THREAD)[None, :]
    inb = e < c * d
    i_of = np.where(inb, e // d, 0)
    for g in range(g_cnt):
        ok = inb & alive[g][i_of]
        at = rows[g][i_of] * d + e % d
        ids = np.where(ok, nbr_id.reshape(-1)[np.where(ok, at, 0)], v)
        live = ids < v
        cnt = np.where(live, nbr_cnt.reshape(-1)[np.where(live, at, 0)], 0).astype(np.float32)
        pos, n = _exclusive(live.sum(1))
        if n == 0:
            continue  # zeros and sentinels, as allocated above
        keys = np.full(1 << max(n - 1, 0).bit_length(), PAD, np.uint32)
        for t in range(THREADS):  # each thread packs its live entries in r order
            row = ids[t][live[t]]
            keys[pos[t]:pos[t] + len(row)] = row
        _bitonic(keys)
        assert (keys[:n] < v).all() and (keys[n:] == PAD).all()
        per = -(-n // THREADS)
        pidx = np.arange(n)
        head = np.ones(n, bool)
        head[1:] = keys[1:n] != keys[:n - 1]
        heads = np.bincount(pidx // per, weights=head, minlength=THREADS).astype(np.int64)
        start, nd = _exclusive(heads)
        rank = start[pidx // per] + np.cumsum(head) - 1 - (np.cumsum(head) - head)[
            np.minimum(pidx // per * per, n - 1)]
        nu = min(nd, u)
        uid = np.full(u, v, np.int64)
        keep = head & (rank < u)
        uid[rank[keep]] = keys[:n][keep]
        lid = ids[live]
        col = _lower_bound(uid, nu, lid)
        into = col < nu
        assert (uid[col[into]] == lid[into]).all()
        np.add.at(m[g], (i_of[live][into], col[into]), cnt[live][into])
        n_u[g, :nu] = sizes[uid[:nu]].astype(np.float32)
        for i in range(c):
            if alive[g, i]:
                p = _lower_bound(uid, nu, np.array([midx[g, i]]))[0]
                if p < nu and uid[p] == midx[g, i]:
                    cidx[g, i] = p
        ci = cidx[g]
        w1 = np.where(ci[None, :] < u, m[g][:, np.minimum(ci, u - 1)], 0).astype(np.float32)
        w[g] = np.maximum(w1, w1.T)
    return m, n_u, cidx, w


def _assert_model_equals_plain(args):
    want = pref.group_tables_ref(*args)
    got = kernel_model(*args)
    for name, x, y in zip(("m", "n_u", "cidx", "w"), got, want):
        assert x.dtype == np_(y).dtype, name
        np.testing.assert_array_equal(x.view(np.uint32) if x.dtype == np.float32 else x,
                                      np_(y).view(np.uint32) if x.dtype == np.float32
                                      else np_(y), err_msg=name)


def _seam_args(monkeypatch, build):
    """The arguments ``core/tables.py`` hands ``ops.assemble_tables``."""
    seen = []
    real = kops.assemble_tables

    def spy(*args, **kwargs):
        seen.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(kops, "assemble_tables", spy)
    gt = build()
    assert len(seen) == 1
    return gt, seen[0]


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("max_neighbors,union_size", [(64, 128), (4, 16)])
def test_group_table_kernel_model_matches_plain(monkeypatch, name, max_neighbors,
                                                union_size):
    rg, pg, v, rows = _rows(name)
    _, pcfg = configs(name)
    cut = False
    for row in rows:
        ps = port_state(row)
        ppt = pcosts.build_pair_table(pg.src, pg.dst, ps)
        pm = pcosts.summary_metrics(ppt, ps, v, pg.num_edges)
        groups = pshingles.build_groups(pg.src, pg.dst, ps, replay(row), pcfg.group_size)
        scal = torch.stack([pm["cbar"], pcosts.log2_f32(v, CPU)])
        gt, args = _seam_args(monkeypatch, lambda: ptables.build_group_tables(
            ppt, ps, groups, max_neighbors, union_size, scal, v))
        _assert_model_equals_plain(args)
        cut |= bool((gt.n_u > 0).all(-1).any())
    if union_size == 16:
        assert cut  # some group fills all U columns


def _synthetic(seed, v=240, e=900, c=8, d=6, dead_frac=0.2):
    """A pair table of distinct pairs (counts 1-5, some self pairs), sizes
    with dead supernodes, and groups of ``c`` with padding."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, v, 3 * e), rng.integers(0, v, 3 * e)
    key = np.unique(np.minimum(a, b) * v + np.maximum(a, b))[:e]
    lo, hi = key // v, key % v
    cnt = rng.integers(1, 6, len(lo)).astype(np.float32)
    pt = PairTable(lo=torch.as_tensor(lo), hi=torch.as_tensor(hi),
                   cnt=torch.as_tensor(cnt), valid=torch.ones(len(lo), dtype=torch.bool))
    sizes = rng.integers(1, 4, v)
    sizes[rng.random(v) < dead_frac] = 0
    order = np.concatenate([rng.permutation(v), -np.ones((-v) % c, np.int64)])
    return pt, torch.as_tensor(sizes), torch.as_tensor(order.reshape(-1, c)), rng


def _plain_assembly(pt, sizes, groups, v, d, u, **kw):
    nbr = ptables.build_neighbor_tables(pt, v, d)
    t_all = torch.arange(v, dtype=torch.float32)
    return ptables.assemble_group_tables(*nbr, t_all, sizes, groups, u, v, **kw)


@pytest.mark.parametrize("case", ["all_dead", "empty_rows", "shared_neighbors", "u_cut",
                                  "compact"])
def test_group_table_kernel_model_cases(monkeypatch, case):
    v, c, d, u = 240, 8, 6, 32
    pt, sizes, groups, rng = _synthetic(7)
    if case == "all_dead":  # a group of dead members, a group of padding
        sizes[groups[0]] = 0
        groups[1] = -1
    elif case == "empty_rows":  # live members whose rows hold no neighbor
        keep = ~torch.isin(pt.lo, groups[2]) & ~torch.isin(pt.hi, groups[2])
        pt = PairTable(lo=pt.lo[keep], hi=pt.hi[keep], cnt=pt.cnt[keep], valid=pt.valid[keep])
        sizes[groups[2]] = 1
    elif case == "shared_neighbors":  # members adjacent to each other and to one hub set
        mem, hub = groups[0], torch.arange(200, 206)
        sizes[mem] = 2
        sizes[hub] = 1
        lo = torch.cat([mem.repeat_interleave(len(hub)), mem[:-1]])
        hi = torch.cat([hub.repeat(len(mem)), mem[1:]])
        ok = lo != hi
        lo, hi = torch.minimum(lo, hi)[ok], torch.maximum(lo, hi)[ok]
        key = torch.unique(torch.cat([pt.lo * v + pt.hi, lo * v + hi]))
        pt = PairTable(lo=key // v, hi=key % v, cnt=(key % 5 + 1).to(torch.float32),
                       valid=torch.ones(len(key), dtype=torch.bool))
    elif case == "u_cut":  # more distinct neighbors in a group than U columns
        u, d = 12, 16
    if case == "compact":  # a rank's rows; some live members have none (-1)
        p = 3
        my_groups = groups.reshape(-1, c)[::p]
        flat = my_groups.reshape(-1)
        slot_of = torch.full((v + 1,), -1, dtype=torch.int64).scatter_(
            0, torch.where(flat >= 0, flat, v), torch.arange(flat.numel()))[:-1]
        slot_of[my_groups[1, :3]] = -1
        sizes[my_groups[1, :3]] = 1
        n_rows = flat.numel()
        nbr = ptables.build_neighbor_tables_compact(pt.lo, pt.hi, pt.cnt, pt.valid,
                                                    slot_of, n_rows, v, d)
        t_all = torch.arange(n_rows, dtype=torch.float32)
        gt, args = _seam_args(monkeypatch, lambda: ptables.assemble_group_tables(
            *nbr, t_all, sizes, my_groups, u, v, row_of_member=slot_of))
        assert not bool(args[4][1, :3].any()) and bool(sizes[my_groups[1, :3]].gt(0).all())
    else:
        gt, args = _seam_args(monkeypatch, lambda: _plain_assembly(pt, sizes, groups, v, d, u))
    _assert_model_equals_plain(args)
    live_rows = (args[0][args[2]] < v) & args[4][..., None]
    if case == "all_dead":
        assert not bool(live_rows[0].any()) and not bool(live_rows[1].any())
        assert bool((gt.cidx[:2] == u).all()) and not bool(gt.m[:2].any())
    if case == "empty_rows":
        assert bool(args[4][2].all()) and not bool(live_rows[2].any())
    if case == "shared_neighbors":
        assert bool((gt.w[0] > 0).any()) and int((gt.cidx[0] < u).sum()) >= 2
    if case == "u_cut":
        assert bool((gt.n_u > 0).all(-1).any())  # some group fills all U columns


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_no_neighbor_row_holds_an_id_twice(name):
    """The kernel's premise: each (member, column) cell gets one count,
    because the tables come from pair tables of distinct pairs."""
    rg, pg, v, rows = _rows(name)
    for row in rows:
        ps = port_state(row)
        ppt = pcosts.build_pair_table(pg.src, pg.dst, ps)
        for d in (64, 4):
            nbr_id = np_(ptables.build_neighbor_tables(ppt, v, d)[0])
            srt = np.sort(nbr_id, axis=1)
            assert not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] < v)).any()
        slot_of = torch.where(torch.arange(v) % 2 == 0, torch.arange(v) // 2, -1)
        nbr_id = np_(ptables.build_neighbor_tables_compact(
            ppt.lo, ppt.hi, ppt.cnt, ppt.valid, slot_of, (v + 1) // 2, v, 64)[0])
        srt = np.sort(nbr_id, axis=1)
        assert not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] < v)).any()


def test_group_table_seam_rules(monkeypatch):
    """CPU tensors take the plain version, with or without ``backend="ref"``;
    ``backend="kernel"`` on the CPU raises; the launcher refuses CPU tensors,
    ``V >= 2**31`` and ``C·D`` over a block's entries."""
    v, d, u = 240, 6, 32
    pt, sizes, groups, _ = _synthetic(3)
    _, args = _seam_args(monkeypatch, lambda: _plain_assembly(pt, sizes, groups, v, d, u))
    monkeypatch.undo()
    before = kops.launch_counts()
    want = pref.group_tables_ref(*args)
    for backend in (None, "ref"):
        for x, y in zip(kops.assemble_tables(*args, backend=backend), want):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="CUDA"):
        kops.assemble_tables(*args, backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        group_tables_cuda(*args)
    with pytest.raises(ValueError, match="32-bit"):
        group_tables_cuda(*args[:-1], 2**31)
    big = torch.zeros((4, 2049 // 8 + 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="entries"):
        group_tables_cuda(big, big.float(), args[2], args[3], args[4], args[5], u, v)
    assert kops.launch_counts() == before and before["group_tables"] == 0
    gt = _plain_assembly(pt, sizes, groups, v, d, u, backend="ref")
    assert gt.cidx.dtype == torch.int32 and gt.m.is_contiguous() and gt.w.is_contiguous()


def test_group_table_module_imports_without_nvcc_and_its_shared_memory():
    assert "group_tables" in build.sources()
    assert build.library_path("group_tables").name.startswith("libgroup_tables-")
    # m tile 32·128, keys 2,048, uid 128, cidx and alive 32 each, rows and ids
    # 2·32 each, 8 warp sums and the total (12 words)
    assert smem_bytes(32, 64, 128) == 4 * (4096 + 2048 + 128 + 32 + 32 + 64 + 64 + 12)
    assert smem_bytes(7, 5, 9) == 4 * (64 + 64 + 12 + 8 + 8 + 16 + 16 + 12)
