"""The port's kernel seam on the CPU: the plain merge-gain and pair-cost
versions against the reference's jnp oracles and its Pallas kernels (run in
interpret mode), on the reference's own cases (tests/test_kernels.py), and
the rules that keep the hand kernels off the CPU.

The CUDA and Triton kernels themselves run only on the card; chip_smoke.py
holds them against these plain versions there. What the merge-gain kernel's
design rests on is checked here: a sum over only the nonzero weighted terms,
ascending within 32-column words and then word by word, equals the plain
version's row sum bit for bit, and a numpy model of the kernel's algorithm
(bitmaps, sums over the set bits of each 32-column word, the word partials
added in order, one epilogue per unordered pair) reproduces
``merge_gain_ref`` exactly.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import RTOL, ATOL_REL, assert_gain_close

from repro.kernels import ref as rref
from repro.kernels.entropy_bits import pair_cost_pallas
from repro.kernels.merge_gain import merge_gain_pallas

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.entropy_bits import pair_cost_triton
from repro_torch.kernels.merge_gain import merge_gain_cuda, smem_bytes
from repro_torch.utils import f32math

GAIN_SHAPES = [(1, 4, 8), (3, 8, 16), (2, 16, 32), (5, 32, 64)]

# the oracles and the Pallas kernels (interpret mode), jitted as the
# reference's dispatch runs them
ref_gain = jax.jit(rref.merge_gain_ref)
ref_cost = jax.jit(rref.pair_cost_ref)
pallas_gain = jax.jit(functools.partial(merge_gain_pallas, interpret=True))
pallas_cost = jax.jit(functools.partial(pair_cost_pallas, interpret=True))


def operands(g, c, u, seed=0, dense=False):
    """The reference's merge-gain operands (tests/test_kernels.py::_operands)."""
    rng = np.random.default_rng(seed)
    lam = 2.0 if dense else 0.4
    m = rng.poisson(lam, size=(g, c, u)).astype(np.float32)
    n = rng.integers(1, 40, size=(g, c)).astype(np.float32)
    n[rng.random((g, c)) < 0.2] = 0.0  # padding members
    s = rng.poisson(0.3, size=(g, c)).astype(np.float32)
    n_u = rng.integers(1, 40, size=(g, u)).astype(np.float32)
    cidx = rng.integers(0, u + 1, size=(g, c)).astype(np.int32)  # u = absent
    w = rng.poisson(0.2, size=(g, c, c)).astype(np.float32)
    w = np.maximum(w, np.swapaxes(w, 1, 2))
    np.einsum("gcc->gc", w)[...] = 0.0
    pi_row = n[..., None] * n_u[:, None, :]
    t = np.asarray(rref.pair_cost_ref(jnp.asarray(m), jnp.asarray(pi_row),
                                      jnp.float32(60.0), jnp.float32(20.0))).sum(-1) + 5.0
    return [m, n, s, t.astype(np.float32), n_u, cidx, w]


def port_gain(args, cbar=60.0, log2v=20.0):
    scal = torch.tensor([cbar, log2v], dtype=torch.float32)
    return ops.merge_gain(*[torch.as_tensor(a) for a in args], scal)


@pytest.mark.parametrize("g,c,u", GAIN_SHAPES)
@pytest.mark.parametrize("dense", [False, True])
def test_merge_gain_plain_matches_reference_and_pallas(g, c, u, dense):
    args = operands(g, c, u, seed=g * 100 + u, dense=dense)
    rel, red = port_gain(args)
    jargs = [jnp.asarray(a) for a in args]
    cbar, log2v = jnp.float32(60.0), jnp.float32(20.0)
    assert_gain_close(rel, red, *ref_gain(*jargs, cbar, log2v))
    assert_gain_close(rel, red, *pallas_gain(*jargs, cbar, log2v))


def test_merge_gain_symmetry():
    """Reduction(A,B) equals Reduction(B,A) (unordered merges)."""
    _, red = port_gain(operands(2, 8, 16, seed=7))
    red = red.numpy()
    np.testing.assert_allclose(red, np.swapaxes(red, 1, 2), rtol=1e-5, atol=1e-3)


def test_merge_gain_diagonal_and_padding_are_invalid():
    args = operands(1, 6, 8, seed=3)
    rel, red = port_gain(args)
    rel, red = rel.numpy(), red.numpy()
    assert np.all(np.isneginf(np.einsum("gcc->gc", rel)))
    pad = args[1] <= 0
    assert pad.any()
    assert np.all(np.isneginf(rel[pad[:, :, None].repeat(6, 2)]))
    assert np.all(red[pad[:, :, None].repeat(6, 2)] == 0.0)


@pytest.mark.parametrize("e", [7, 128, 1024, 1025, 5000])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_pair_cost_plain_matches_reference_and_pallas(e, dtype):
    rng = np.random.default_rng(e)
    cnt = rng.poisson(1.0, size=e).astype(np.float32)
    pi = (cnt + rng.integers(0, 30, size=e)).astype(np.float32)
    cnt, pi = cnt.astype(dtype), pi.astype(dtype)
    got = ops.pair_cost(torch.as_tensor(cnt), torch.as_tensor(pi),
                        torch.tensor([45.0, 14.0])).numpy()
    cbar, log2v = jnp.float32(45.0), jnp.float32(14.0)
    want = np.asarray(ref_cost(jnp.asarray(cnt), jnp.asarray(pi), cbar, log2v))
    pallas = np.asarray(pallas_cost(jnp.asarray(cnt), jnp.asarray(pi), cbar, log2v))
    assert got.dtype == np.float32 and got.shape == (e,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_REL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL_REL)


def test_kernel_modules_import_without_triton_or_nvcc():
    """Importing the kernel modules builds nothing and imports no triton."""
    assert "triton" not in sys.modules
    assert callable(pair_cost_triton) and callable(merge_gain_cuda)
    assert build.library_path("merge_gain").name.startswith("libmerge_gain-")
    assert "merge_gain" in build.sources()


def test_kernel_launchers_refuse_cpu_tensors():
    args = [torch.as_tensor(a) for a in operands(1, 4, 8)]
    scal = torch.tensor([60.0, 20.0])
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        merge_gain_cuda(*args, scal)
    with pytest.raises(ValueError, match="CUDA"):
        pair_cost_triton(torch.ones(4), torch.ones(4), scal)
    with pytest.raises(ValueError, match="CUDA"):
        ops.merge_gain(*args, scal, backend="kernel")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.pair_cost(torch.ones(4), torch.ones(4), scal, backend="triton")
    assert ops.launch_counts() == before


def test_shared_memory_formula():
    # regions rounded to 16 B: max(m tile, rel + red), n_u, padded w,
    # n/s/t/tail/cidx, the occupancy bitmaps, the pairs' member ids, then per
    # (item, word) unit a key or partial sum and a 16-bit order, and a 64-bin
    # histogram; an item reserves a power of two of words
    assert smem_bytes(32, 128) == (4096 + 128 + 1056 + 5 * 32 + 128 + 496 + 2112
                                   + 1056 + 64) * 4
    # rel and red ([C, C + 1] each) outgrow a narrow m tile and take its place
    assert smem_bytes(4, 8) == (40 + 8 + 20 + 5 * 4 + 4 + 8 + 12 + 8 + 64) * 4
    # U = 45: two words an item; C = 13, U = 100: four
    assert smem_bytes(7, 45) == (316 + 48 + 56 + 5 * 8 + 16 + 24 + 56 + 28 + 64) * 4
    assert smem_bytes(13, 100) == (1300 + 100 + 184 + 5 * 16 + 52 + 80 + 364 + 184
                                   + 64) * 4
    assert smem_bytes(32, 128) < 48 * 1024 < smem_bytes(64, 256) < 232_448
    assert smem_bytes(64, 256) == (16384 + 256 + 4160 + 5 * 64 + 512 + 2016 + 16640
                                   + 8320 + 64) * 4


def f32_sum_set_bits(terms, keep):
    """What the kernel adds for one row: the terms where ``keep`` is set,
    ascending within each 32-column word, then the word partials in order,
    each addition rounded to float32."""
    acc = np.float32(0.0)
    for lo in range(0, len(terms), 32):
        part = np.float32(0.0)
        for col in range(lo, min(lo + 32, len(terms))):
            if keep[col]:
                part = np.float32(part + terms[col])
        acc = np.float32(acc + part)
    return acc


def own_column_keep(union, ci, cj):
    """The kernel's set bits of a pair: the union, less each own column whose
    weight 1 - [u == ci] - [u == cj] is 0 (kept, at -1, where ci == cj)."""
    keep = union.copy()
    if ci != cj:
        for col in (ci, cj):
            if col < len(keep):
                keep[col] = False
    return keep


@pytest.mark.parametrize("u", [8, 16, 64, 128])
@pytest.mark.parametrize("kind", ["pair", "row"])
def test_set_bit_sum_equals_plain_row_sum_bit_for_bit(u, kind):
    rng = np.random.default_rng(u + (1000 if kind == "pair" else 0))
    rows = 256
    lam = np.where(rng.random((rows, 1)) < 0.1, 3.0, 0.3)  # a few hub rows
    mi = rng.poisson(lam, size=(rows, u)).astype(np.float32)
    mj = rng.poisson(lam, size=(rows, u)).astype(np.float32)
    if u >= 32:
        mi[0, :32] = 1.0  # a full bitmap word
    if kind == "row":
        cnt, union = mi, mi != 0
        weight = np.ones((rows, u), np.float32)
        ci = cj = np.full(rows, u)
    else:
        cnt, union = mi + mj, (mi != 0) | (mj != 0)
        ci = rng.integers(0, u + 1, size=rows)  # u = absent
        cj = np.where(rng.random(rows) < 0.3, ci, rng.integers(0, u + 1, size=rows))
        cols = np.arange(u)
        weight = (1.0 - (cols == ci[:, None]) - (cols == cj[:, None])).astype(np.float32)
    assert kind == "row" or ((ci == cj) & (ci < u)).any()
    pi = (rng.integers(1, 40, size=(rows, 1)) * rng.integers(1, 40, size=(1, u))).astype(
        np.float32)
    f = ref.pair_cost_ref(torch.as_tensor(cnt), torch.as_tensor(pi), torch.tensor(60.0),
                          torch.tensor(20.0)).numpy()
    terms = f * weight
    want = f32math.sum_last(torch.as_tensor(terms)).numpy()
    keep = np.stack([own_column_keep(union[r], ci[r], cj[r]) for r in range(rows)])
    assert np.all(terms[~keep] == 0.0)  # what the kernel skips is an exact zero
    got = np.array([f32_sum_set_bits(terms[r], keep[r]) for r in range(rows)],
                   dtype=np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def kernel_model(args, cbar=60.0, log2v=20.0):
    """The merge-gain kernel's algorithm (csrc/merge_gain.cu) in numpy float32:
    occupancy bitmaps, each member's row cost and each unordered live pair's
    cross sum over its set bits only, word by word (``f32_sum_set_bits``), and
    one epilogue finishing both ordered entries. The entropy terms come from the plain ``pair_cost_ref``, so the
    model differs from ``merge_gain_ref`` only in which terms it adds and in
    what order."""
    m, n, s, t, n_u, cidx, w = args
    g_cnt, c, u = m.shape
    cb, lv = torch.tensor(cbar), torch.tensor(log2v)

    def f(cnt, pi):
        return ref.pair_cost_ref(torch.as_tensor(cnt), torch.as_tensor(pi), cb, lv).numpy()

    npair = n[:, :, None] + n[:, None, :]
    f_row = f(m, n[..., None] * n_u[:, None, :])
    f_pair = f(m[:, :, None, :] + m[:, None, :, :], npair[..., None] * n_u[:, None, None, :])
    nz = m != 0
    tail = np.zeros((g_cnt, c), np.float32)
    cross = np.zeros((g_cnt, c, c), np.float32)
    cols = np.arange(u)
    for g in range(g_cnt):
        for i in range(c):
            if n[g, i] > 0:
                row = f32_sum_set_bits(f_row[g, i], nz[g, i])
                self_cost = f(s[g, i:i + 1], n[g, i:i + 1] * (n[g, i:i + 1] - 1.0) * 0.5)[0]
                tail[g, i] = max(np.float32(np.float32(t[g, i] - row) - self_cost), 0.0)
        for i in range(c):
            for j in range(i + 1, c):
                if not (n[g, i] > 0 and n[g, j] > 0):
                    continue
                ci, cj = cidx[g, i], cidx[g, j]
                weight = (1.0 - (cols == ci) - (cols == cj)).astype(np.float32)
                keep = own_column_keep(nz[g, i] | nz[g, j], ci, cj)
                cross[g, i, j] = cross[g, j, i] = f32_sum_set_bits(f_pair[g, i, j] * weight,
                                                                   keep)
    s_m = s[:, :, None] + s[:, None, :] + w
    merged = cross + f(s_m, npair * (npair - 1.0) * 0.5) + tail[:, :, None] + tail[:, None, :]
    denom = t[:, :, None] + t[:, None, :] - f(w, n[:, :, None] * n[:, None, :])
    live = n > 0
    valid = live[:, :, None] & live[:, None, :] & ~np.eye(c, dtype=bool) & (denom > 1e-6)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(valid, 1.0 - merged / np.maximum(denom, np.float32(1e-6)), -np.inf)
    red = np.where(valid, denom - merged, 0.0)
    return rel.astype(np.float32), red.astype(np.float32)


@pytest.mark.parametrize("g,c,u", GAIN_SHAPES + [(2, 13, 100)])
@pytest.mark.parametrize("dense", [False, True])
def test_kernel_model_matches_plain_bit_for_bit(g, c, u, dense):
    args = operands(g, c, u, seed=g * 100 + u, dense=dense)
    want = ref.merge_gain_ref(*[torch.as_tensor(a) for a in args], torch.tensor(60.0),
                              torch.tensor(20.0))
    for got, exp in zip(kernel_model(args), want):
        np.testing.assert_array_equal(got.view(np.uint32), exp.numpy().view(np.uint32))


def test_ref_backend_equals_default_on_cpu():
    args = operands(3, 8, 16, seed=11)
    scal = torch.tensor([60.0, 20.0])
    targs = [torch.as_tensor(a) for a in args]
    a = ops.merge_gain(*targs, scal)
    b = ops.merge_gain(*targs, scal, backend="ref")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = ref.pair_cost_ref(targs[0].flatten(), targs[0].flatten() + 3, scal[0], scal[1])
    assert torch.equal(c, ops.pair_cost(targs[0].flatten(), targs[0].flatten() + 3, scal))
