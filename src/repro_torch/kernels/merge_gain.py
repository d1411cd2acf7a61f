"""Merge-gain kernel (CUDA C++ for sm_90a) and its launcher.

Replaces ``repro/kernels/merge_gain.py::merge_gain_pallas`` (Pallas body
``_merge_gain_kernel``): for every candidate group, ``rel`` (Eq. 20) and
``red`` (Eq. 17) of every member pair. The source is
``csrc/merge_gain.cu``. One thread block takes one group: it stages the
group's tables in shared memory and builds an occupancy bitmap of each
member's row. Its work units are the 32-column words of each member row and
of each unordered pair ``i < j`` (the union of the two rows' bitmaps); it
sorts the units by their set bits, and a thread sums the entropy terms of
one unit's set bits only, ascending, before the word partials are added in
order: the reference's order of additions, which the plain version takes
on every device (``f32math.sum_last``). The
source's header says what bounds the function on the card and what the
design does about it. It is built by
:mod:`repro_torch.kernels.build` and bound with ctypes. The plain version is
:func:`repro_torch.kernels.ref.merge_gain_ref`; callers go through
:func:`repro_torch.kernels.ops.merge_gain`.

``merge_gain_cuda.launches`` counts the kernel's launches, and nothing else
changes it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_SMEM_BYTES = 232_448  # what one block may opt in to on Hopper

_vp, _int = ctypes.c_void_p, ctypes.c_int


def _bind() -> ctypes.CDLL:
    lib = build.load("merge_gain")
    lib.merge_gain_launch.argtypes = [_vp] * 10 + [_int, _int, _int, _vp]
    lib.merge_gain_launch.restype = _int
    lib.merge_gain_smem_bytes.argtypes = [_int, _int]
    lib.merge_gain_smem_bytes.restype = ctypes.c_size_t
    return lib


def _round4(x: int) -> int:
    return (x + 3) & ~3


def smem_bytes(c: int, u: int) -> int:
    """Shared memory of one block; mirrors ``Layout`` in the CUDA source,
    whose ``merge_gain_smem_bytes`` the launcher uses.

    Regions of 4-byte words, each rounded up to 16 bytes: the m tile
    ``[C, U]`` (rel and red, ``2 × [C, C + 1]``, take its place after the
    sums, so it is the larger of the two), ``n_u [U]``, ``w [C, C + 1]``,
    ``n``, ``s``, ``t``, ``tail`` and ``cidx [C]``, the bitmaps
    ``[C, W]`` (``W = ceil(U / 32)``), the ``C(C-1)/2`` pairs' member ids,
    and for the sort of the work units (an item, that is a row or a pair,
    and one of its words; ``Wp``, ``W`` rounded up to a power of two, per
    item) their keys and partial sums, their order in 16 bits, and a 64-bin
    histogram.
    """
    words = (u + 31) // 32
    wp = 1
    while wp < words:
        wp *= 2
    pairs = c * (c - 1) // 2
    units = (c + pairs) * wp
    total = (max(_round4(c * u), 2 * _round4(c * (c + 1))) + _round4(u)
             + _round4(c * (c + 1)) + 5 * _round4(c) + _round4(c * words)
             + _round4(pairs) + _round4(units) + _round4((units + 1) // 2) + 64)
    return total * 4


def merge_gain_cuda(m, n, s, t, n_u, cidx, w, scal):
    """Launch the kernel on PyTorch's current stream; returns ``(rel, red)``.

    ``scal`` is a device tensor ``f32[2] = (cbar, log2v)``, so no host sync
    is needed to pass the scalars. Raises on a tensor the kernel does not
    take, and when the launch is refused.
    """
    g, c, u = m.shape
    dev = m.device
    if dev.type != "cuda":
        raise ValueError(f"merge_gain_cuda needs CUDA tensors, got {dev}")
    want = {"m": (m, (g, c, u), torch.float32), "n": (n, (g, c), torch.float32),
            "s": (s, (g, c), torch.float32), "t": (t, (g, c), torch.float32),
            "n_u": (n_u, (g, u), torch.float32), "cidx": (cidx, (g, c), torch.int32),
            "w": (w, (g, c, c), torch.float32), "scal": (scal, (2,), torch.float32)}
    for name, (x, shape, dtype) in want.items():
        if x.device != dev or tuple(x.shape) != shape or x.dtype != dtype \
                or not x.is_contiguous():
            raise ValueError(
                f"merge_gain_cuda: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {dev}; got {x.dtype} {tuple(x.shape)} on "
                f"{x.device} (contiguous={x.is_contiguous()})")
    if smem_bytes(c, u) > MAX_SMEM_BYTES:
        raise ValueError(f"merge_gain_cuda: a (C={c}, U={u}) group needs "
                         f"{smem_bytes(c, u)} B of shared memory, over "
                         f"{MAX_SMEM_BYTES} B")
    rel = torch.empty((g, c, c), dtype=torch.float32, device=dev)
    red = torch.empty((g, c, c), dtype=torch.float32, device=dev)
    if g == 0:
        return rel, red
    lib = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.merge_gain_launch(
            m.data_ptr(), n.data_ptr(), s.data_ptr(), t.data_ptr(),
            n_u.data_ptr(), cidx.data_ptr(), w.data_ptr(), scal.data_ptr(),
            rel.data_ptr(), red.data_ptr(), g, c, u, stream)
    if err != 0:
        raise RuntimeError(f"merge_gain kernel launch failed: CUDA error {err} "
                           f"(G={g}, C={c}, U={u})")
    merge_gain_cuda.launches += 1
    return rel, red


merge_gain_cuda.launches = 0
