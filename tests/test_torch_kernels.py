"""The port's kernel seam on the CPU: the plain merge-gain and pair-cost
versions against the reference's jnp oracles and its Pallas kernels (run in
interpret mode), on the reference's own cases (tests/test_kernels.py), and
the rules that keep the hand kernels off the CPU.

The CUDA and Triton kernels themselves run only on the card; chip_smoke.py
holds them against these plain versions there.
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
    # the C entry and the launcher agree: m tile, n_u, n/s/t/tail, cidx
    assert smem_bytes(32, 128) == (32 * 128 + 128 + 4 * 32) * 4 + 32 * 4
    assert smem_bytes(32, 128) < 48 * 1024 < smem_bytes(64, 256)


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
