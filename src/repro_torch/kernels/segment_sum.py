"""Segment-sum kernel (CUDA C++ for sm_90a) and its launcher.

Not a TPU kernel. It computes the query engine's row reductions over the
block CSR — ``out[r] = Σ vals[indptr[r]:indptr[r+1]]`` added left to right
from zero — which the reference writes as ``np.add.at`` on the host
(``repro/core/queries.py:142,197``) and as padded-row sums on the TPU
(``repro/core/queries_jax.py:181``). One thread per segment adds in storage
order: numpy's order, the same bits on every run (float atomics would not
give either), and the same bits as the plain version
:func:`repro_torch.kernels.ref.segment_sum_ref` on a CPU tensor. The source
is ``csrc/segment_sum.cu``; it is built by :mod:`repro_torch.kernels.build`
and bound with ctypes. Callers go through
:func:`repro_torch.kernels.ops.segment_sum`.

``segment_sum_cuda.launches`` counts the kernel's launches, and nothing else
changes it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_vp = ctypes.c_void_p


def _bind() -> ctypes.CDLL:
    lib = build.load("segment_sum")
    lib.segment_sum_launch.argtypes = [_vp, _vp, _vp, ctypes.c_longlong, _vp]
    lib.segment_sum_launch.restype = ctypes.c_int
    return lib


def segment_sum_cuda(indptr: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream; returns float64[len(indptr) - 1].

    ``indptr`` is a contiguous int64 offset array (non-decreasing, from 0 to at
    most ``len(vals)``) and ``vals`` a contiguous float64 tensor, both on the
    same card. Raises on a tensor the kernel does not take, and when the
    launch is refused.
    """
    dev = vals.device
    if dev.type != "cuda":
        raise ValueError(f"segment_sum_cuda needs CUDA tensors, got {dev}")
    for name, x, dtype in (("indptr", indptr, torch.int64), ("vals", vals, torch.float64)):
        if x.device != dev or x.dtype != dtype or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(
                f"segment_sum_cuda: {name} must be a contiguous 1-D {dtype} tensor on "
                f"{dev}; got {x.dtype} {tuple(x.shape)} on {x.device} "
                f"(contiguous={x.is_contiguous()})")
    if indptr.numel() == 0:
        raise ValueError("segment_sum_cuda: indptr needs at least one offset")
    n_seg = indptr.numel() - 1
    out = torch.empty(n_seg, dtype=torch.float64, device=dev)
    if n_seg == 0:
        return out
    lib = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.segment_sum_launch(indptr.data_ptr(), vals.data_ptr(), out.data_ptr(),
                                     n_seg, stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error {err} "
                           f"({n_seg} segments, {vals.numel()} values)")
    segment_sum_cuda.launches += 1
    return out


segment_sum_cuda.launches = 0
