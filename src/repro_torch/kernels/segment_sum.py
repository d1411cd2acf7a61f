"""Fixed-order sum kernels (CUDA C++ for sm_90a) and their launchers.

Not TPU kernels. They compute the query engine's float64 sums, each in one
fixed order of addition, so an answer has the same bits on every run, in
any batch, and on the CPU:

* :func:`segment_sum_cuda` — row sums over the block CSR,
  ``out[r] = Σ vals[indptr[r]:indptr[r+1]]`` added left to right from zero,
  which the reference writes as ``np.add.at`` on the host
  (``repro/core/queries.py:142,197``) and as padded-row sums on the TPU
  (``repro/core/queries_jax.py:181``). Rows of up to :data:`LONG_ROW` values
  are added by one thread each; longer rows (listed by :func:`long_rows`)
  are loaded by a warp each, in the first blocks of the grid, and added by
  one lane. Plain version: :func:`repro_torch.kernels.ref.segment_sum_ref`.
* :func:`ordered_sum_cuda` — row sums of a dense ``[k, n]`` array: each row's
  1024-value segments added left to right from zero, then those partial
  sums left to right from zero, both folds in one launch. Plain version:
  :func:`repro_torch.kernels.ref.ordered_sum_ref`.

The source is ``csrc/segment_sum.cu``; it is built by
:mod:`repro_torch.kernels.build` and bound with ctypes. Callers go through
:func:`repro_torch.kernels.ops.segment_sum` and
:func:`repro_torch.kernels.ops.ordered_sum`.

``segment_sum_cuda.launches`` and ``ordered_sum_cuda.launches`` count the
kernels' launches, and nothing else changes them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_vp = ctypes.c_void_p
_ll = ctypes.c_longlong

LONG_ROW = 32  # a CSR row of more values than this is loaded by a whole warp
SEGMENT = 1024  # the only segment length ordered_sum_cuda takes

# Per (device, stream): ordered_sum_cuda's int32 row counters, zero between
# launches (the kernel zeroes each counter it completes).
_COUNTS: dict[tuple[int, int], torch.Tensor] = {}


@functools.cache
def _bind() -> ctypes.CDLL:
    lib = build.load("segment_sum")
    lib.segment_sum_launch.argtypes = [_vp, _vp, _vp, _ll, _vp, _ll, _ll, _vp]
    lib.segment_sum_launch.restype = ctypes.c_int
    lib.ordered_sum_launch.argtypes = [_vp, _vp, _vp, _vp, _ll, _ll, _ll, _vp]
    lib.ordered_sum_launch.restype = ctypes.c_int
    return lib


def long_rows(indptr: torch.Tensor) -> torch.Tensor:
    """The rows of a CSR offset array with more than :data:`LONG_ROW` values,
    ascending, int64, on ``indptr``'s device. Plain PyTorch; the block
    summary computes it once, since its CSR does not change."""
    return torch.nonzero(indptr[1:] - indptr[:-1] > LONG_ROW).reshape(-1)


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, dim: int, dev) -> None:
    if x.dtype != dtype or x.dim() != dim or not x.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dim}-D {dtype} tensor; got {x.dtype} "
            f"{tuple(x.shape)} (contiguous={x.is_contiguous()})")
    if x.device != dev:
        raise ValueError(f"{name} must be on {dev}, like the other operands; got {x.device}")


def segment_sum_cuda(indptr: torch.Tensor, vals: torch.Tensor,
                     long: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CSR kernel on PyTorch's current stream; returns
    float64[len(indptr) - 1].

    ``indptr`` is a contiguous int64 offset array (non-decreasing, from 0 to at
    most ``len(vals)``), ``vals`` a contiguous float64 tensor, and ``long``
    :func:`long_rows` of ``indptr`` (computed here when it is None, at the
    cost of a host sync), all on the same card. Raises on a tensor the kernel
    does not take, and when the launch is refused.
    """
    dev = vals.device
    if dev.type != "cuda":
        raise ValueError(f"segment_sum_cuda needs CUDA tensors, got {dev}")
    _check("segment_sum_cuda: indptr", indptr, torch.int64, 1, dev)
    _check("segment_sum_cuda: vals", vals, torch.float64, 1, dev)
    if indptr.numel() == 0:
        raise ValueError("segment_sum_cuda: indptr needs at least one offset")
    if long is None:
        long = long_rows(indptr)
    _check("segment_sum_cuda: long", long, torch.int64, 1, dev)
    n_seg = indptr.numel() - 1
    out = torch.empty(n_seg, dtype=torch.float64, device=dev)
    if n_seg == 0:
        return out
    lib = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.segment_sum_launch(indptr.data_ptr(), vals.data_ptr(), out.data_ptr(),
                                     n_seg, long.data_ptr(), long.numel(), LONG_ROW, stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error {err} "
                           f"({n_seg} segments, {vals.numel()} values)")
    segment_sum_cuda.launches += 1
    return out


segment_sum_cuda.launches = 0


def _counts(dev: torch.device, stream: int, k: int) -> torch.Tensor:
    """At least ``k`` zeroed int32 row counters for ``stream`` on ``dev``."""
    key = (dev.index, stream)
    cnt = _COUNTS.get(key)
    if cnt is None or cnt.numel() < k:
        cnt = torch.zeros(max(k, 64), dtype=torch.int32, device=dev)
        _COUNTS[key] = cnt
    return cnt


def ordered_sum_cuda(x: torch.Tensor, segment: int = SEGMENT) -> torch.Tensor:
    """Launch the dense-row kernel on PyTorch's current stream: the row sums
    of ``x`` (contiguous float64 ``[k, n]`` on a card) → float64[k], each
    row's ``segment``-value segments folded in order, then their sums.
    ``segment`` must be :data:`SEGMENT`. One launch; none when ``k`` or ``n``
    is 0 (the sums of empty rows are 0). Raises on a tensor the kernel does
    not take, and when the launch is refused.
    """
    dev = x.device
    _check("ordered_sum_cuda: x", x, torch.float64, 2, dev)
    if dev.type != "cuda":
        raise ValueError(f"ordered_sum_cuda needs CUDA tensors, got {dev}")
    if segment != SEGMENT:
        raise ValueError(f"ordered_sum_cuda adds segments of {SEGMENT} values, not {segment}")
    k, n = x.shape
    if k == 0 or n == 0:
        return torch.zeros(k, dtype=torch.float64, device=dev)
    m = -(-n // segment)
    out = torch.empty(k, dtype=torch.float64, device=dev)
    part = torch.empty(k * m, dtype=torch.float64, device=dev) if m > 1 else None
    lib = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        counts = _counts(dev, stream, k)
        err = lib.ordered_sum_launch(x.data_ptr(), out.data_ptr(),
                                     None if part is None else part.data_ptr(),
                                     counts.data_ptr(), k, n, segment, stream)
    if err != 0:
        raise RuntimeError(f"ordered_sum kernel launch failed: CUDA error {err} "
                           f"([{k}, {n}] values)")
    ordered_sum_cuda.launches += 1
    return out


ordered_sum_cuda.launches = 0
