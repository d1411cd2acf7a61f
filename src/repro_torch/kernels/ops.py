"""The one seam for every hand-kernel call of the port.

Port of ``repro/kernels/ops.py``. The implementation follows the tensors'
device and ``SummaryConfig.kernel_backend``:

  * ``None``     — the hand kernel for CUDA tensors
    (:func:`~repro_torch.kernels.merge_gain.merge_gain_cuda`,
    :func:`~repro_torch.kernels.entropy_bits.pair_cost_triton`,
    :func:`~repro_torch.kernels.segment_sum.segment_sum_cuda`,
    :func:`~repro_torch.kernels.segment_sum.ordered_sum_cuda`), the plain
    version (:mod:`repro_torch.kernels.ref`) for CPU tensors;
  * ``"ref"``    — the plain version on either device;
  * ``"kernel"`` — the hand kernel; CPU tensors raise.

For CUDA tensors the kernel launches or raises: there is no fallback to the
plain version, and no environment switch. While a step's work is counted
(``launch/costs.py::WorkCounter``, installed as :data:`COUNTER`), a call
that takes the plain version goes through the counter, which counts the
hand kernel's own work in its place; the kernel branch is the same.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.entropy_bits import pair_cost_triton
from repro_torch.kernels.merge_gain import merge_gain_cuda
from repro_torch.kernels.segment_sum import ordered_sum_cuda, segment_sum_cuda


#: the ``WorkCounter`` counting this process's step, if any
COUNTER = None


def _plain(name: str, fn, *args):
    """The plain version ``fn(*args)`` of hand kernel ``name``; counted as
    the kernel's own work while :data:`COUNTER` is installed."""
    if COUNTER is None:
        return fn(*args)
    return COUNTER.kernel(name, fn, args)


def trips(n: int, *tensors):
    """``range(n)`` for a loop over ``tensors`` whose trips run the same ops
    on the same shapes and only carry state from one to the next. While
    :data:`COUNTER` traces ``meta`` tensors that record no gradient, trip 0
    alone, its count taken for all ``n`` (``WorkCounter.fold``)."""
    if COUNTER is None or not COUNTER.can_fold(tensors):
        return range(n)
    return COUNTER.fold(n)


def _use_kernel(x: torch.Tensor, backend: str | None) -> bool:
    if backend == "ref":
        return False
    if backend not in (None, "kernel"):
        raise ValueError(f"unknown kernel backend {backend!r}; valid: "
                         "None, 'ref', 'kernel'")
    if x.device.type == "cuda":
        return True
    if backend == "kernel":
        raise ValueError("kernel_backend='kernel' needs CUDA tensors; got "
                         f"{x.device}")
    return False


def merge_gain(m, n, s, t, n_u, cidx, w, scal, *, backend: str | None = None):
    """(rel, red) gain matrices [G, C, C], Eq. (20)/(17), per candidate pair.

    ``scal`` is ``f32[2] = (cbar, log2v)`` on the tensors' device.
    """
    if _use_kernel(m, backend):
        return merge_gain_cuda(m, n, s, t, n_u, cidx, w, scal)
    return _plain("merge_gain", lambda *a: ref.merge_gain_ref(*a, scal[0], scal[1]),
                  m, n, s, t, n_u, cidx, w)


def pair_cost(cnt, pi, scal, *, backend: str | None = None):
    """Optimal per-pair description cost min(C̄+Cost₍₁₎, Cost₍₂₎), f32[E]."""
    if _use_kernel(cnt, backend):
        return pair_cost_triton(cnt, pi, scal)
    return _plain("pair_cost", lambda *a: ref.pair_cost_ref(*a, scal[0], scal[1]), cnt, pi)


def segment_sum(indptr, vals, long=None, *, backend: str | None = None):
    """Per-segment sums in storage order, float64[len(indptr) - 1]: the query
    engine's row reduction over the block CSR. ``long`` is
    :func:`~repro_torch.kernels.segment_sum.long_rows` of ``indptr``, where
    the caller keeps it; the plain version does not need it."""
    if _use_kernel(vals, backend):
        return segment_sum_cuda(indptr, vals, long)
    return _plain("segment_sum", lambda i, v, _: ref.segment_sum_ref(i, v), indptr, vals, long)


def ordered_sum(x, segment: int, *, backend: str | None = None):
    """Row sums of a float64 ``[k, n]`` tensor in a fixed order: each row's
    ``segment``-value segments left to right, then their sums left to
    right."""
    if _use_kernel(x, backend):
        return ordered_sum_cuda(x, segment)
    return _plain("ordered_sum", lambda a: ref.ordered_sum_ref(a, segment), x)


_KERNELS = {"merge_gain": merge_gain_cuda, "pair_cost": pair_cost_triton,
            "segment_sum": segment_sum_cuda, "ordered_sum": ordered_sum_cuda}


def launch_counts() -> dict[str, int]:
    """How often each hand kernel has launched in this process."""
    return {name: fn.launches for name, fn in _KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0
