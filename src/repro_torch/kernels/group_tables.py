"""Union-space group-table kernel (CUDA C++ for sm_90a) and its launcher.

Replaces no TPU kernel: the reference assembles the tables with XLA ops
(``repro/core/tables.py::assemble_group_tables``, a sort and an ``.at[]``
scatter chain), which :func:`repro_torch.kernels.ref.group_tables_ref` keeps
as the plain version. The source is ``csrc/group_tables.cu``. One thread
block takes one group: it reads its members' top-``D`` neighbor rows once,
sorts the live ids as 32-bit keys in shared memory, keeps the ``U`` smallest
distinct ones as the group's columns and builds ``m``, ``n_u``, ``cidx`` and
``w`` from a ``[C, U]`` tile in shared memory. The outputs equal the plain
version's bit for bit. The source's header says what bounds the function on
the card and what the design does about it. It is built by
:mod:`repro_torch.kernels.build` and bound with ctypes; callers go through
:func:`repro_torch.kernels.ops.assemble_tables`.

``group_tables_cuda.launches`` counts the kernel's launches, and nothing
else changes it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_SMEM_BYTES = 232_448  # what one block may opt in to on Hopper
MAX_ENTRIES = 2048  # C·D a block holds: 256 threads × 8 (kThreads·kPerThread)
WARPS = 8

_vp, _int = ctypes.c_void_p, ctypes.c_int


def _bind() -> ctypes.CDLL:
    lib = build.load("group_tables")
    lib.group_tables_launch.argtypes = [_vp] * 10 + [_int] * 5 + [_vp]
    lib.group_tables_launch.restype = _int
    lib.group_tables_smem_bytes.argtypes = [_int, _int, _int]
    lib.group_tables_smem_bytes.restype = ctypes.c_size_t
    lib.group_tables_max_entries.argtypes = []
    lib.group_tables_max_entries.restype = _int
    return lib


def _round4(x: int) -> int:
    return (x + 3) & ~3


def smem_bytes(c: int, d: int, u: int) -> int:
    """Shared memory of one block; mirrors ``Layout`` in the CUDA source,
    whose ``group_tables_smem_bytes`` the launcher uses.

    Regions of 4-byte words, each rounded up to 16 bytes: the m tile
    ``[C, U]``, the sort's keys (``C·D`` rounded up to a power of two),
    ``uid [U]``, ``cidx`` and the members' liveness ``[C]``, their table
    rows and ids ``[C]`` as int64, and the block scan's per-warp sums.
    """
    keys = 1
    while keys < c * d:
        keys *= 2
    words = (_round4(c * u) + _round4(keys) + _round4(u) + 2 * _round4(c)
             + 2 * _round4(2 * c) + _round4(WARPS + 1))
    return words * 4


def group_tables_cuda(nbr_id, nbr_cnt, rows, midx, alive, sizes, union_size: int,
                      num_nodes: int):
    """Launch the kernel on PyTorch's current stream; returns ``(m, n_u,
    cidx, w)``.

    ``nbr_id int64[R, D]`` and ``nbr_cnt float32[R, D]`` are the top-``D``
    neighbor tables (``V`` marks an empty slot); ``rows int64[G, C]`` each
    member's table row, ``midx int64[G, C]`` its supernode id, ``alive
    bool[G, C]`` whether it counts (a dead member's row is not read);
    ``sizes int64[V]`` the supernode sizes. Raises on a tensor or a shape
    the kernel does not take, and when the launch is refused.
    """
    g, c = rows.shape
    d = nbr_id.shape[-1]
    u, v = int(union_size), int(num_nodes)
    if not 0 < v < 2**31:
        raise ValueError(f"group_tables_cuda: ids are 32-bit keys; V = {v} is not in "
                         "[1, 2**31)")
    if c * d > MAX_ENTRIES or u < 1:
        raise ValueError(f"group_tables_cuda: a (C={c}, D={d}, U={u}) group has C·D = "
                         f"{c * d} entries; a block takes 1 to {MAX_ENTRIES} and U >= 1")
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"group_tables_cuda needs CUDA tensors, got {dev}")
    want = {"nbr_id": (nbr_id, (nbr_id.shape[0], d), torch.int64),
            "nbr_cnt": (nbr_cnt, (nbr_id.shape[0], d), torch.float32),
            "rows": (rows, (g, c), torch.int64), "midx": (midx, (g, c), torch.int64),
            "alive": (alive, (g, c), torch.bool), "sizes": (sizes, (v,), torch.int64)}
    for name, (x, shape, dtype) in want.items():
        if x.device != dev or tuple(x.shape) != shape or x.dtype != dtype \
                or not x.is_contiguous():
            raise ValueError(
                f"group_tables_cuda: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {dev}; got {x.dtype} {tuple(x.shape)} on "
                f"{x.device} (contiguous={x.is_contiguous()})")
    if smem_bytes(c, d, u) > MAX_SMEM_BYTES:
        raise ValueError(f"group_tables_cuda: a (C={c}, D={d}, U={u}) group needs "
                         f"{smem_bytes(c, d, u)} B of shared memory, over "
                         f"{MAX_SMEM_BYTES} B")
    m = torch.empty((g, c, u), dtype=torch.float32, device=dev)
    n_u = torch.empty((g, u), dtype=torch.float32, device=dev)
    cidx = torch.empty((g, c), dtype=torch.int32, device=dev)
    w = torch.empty((g, c, c), dtype=torch.float32, device=dev)
    if g == 0:
        return m, n_u, cidx, w
    lib = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.group_tables_launch(
            nbr_id.data_ptr(), nbr_cnt.data_ptr(), rows.data_ptr(), midx.data_ptr(),
            alive.data_ptr(), sizes.data_ptr(), m.data_ptr(), n_u.data_ptr(),
            cidx.data_ptr(), w.data_ptr(), g, c, d, u, v, stream)
    if err != 0:
        raise RuntimeError(f"group_tables kernel launch failed: CUDA error {err} "
                           f"(G={g}, C={c}, D={d}, U={u}, V={v})")
    group_tables_cuda.launches += 1
    return m, n_u, cidx, w


group_tables_cuda.launches = 0
