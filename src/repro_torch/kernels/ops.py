"""The one seam for every merge-gain and pair-cost call of the port.

Port of ``repro/kernels/ops.py``. The implementation follows the tensors'
device and ``SummaryConfig.kernel_backend``:

  * ``None``     — the hand kernel for CUDA tensors
    (:func:`~repro_torch.kernels.merge_gain.merge_gain_cuda`,
    :func:`~repro_torch.kernels.entropy_bits.pair_cost_triton`), the plain
    version (:mod:`repro_torch.kernels.ref`) for CPU tensors;
  * ``"ref"``    — the plain version on either device;
  * ``"kernel"`` — the hand kernel; CPU tensors raise.

For CUDA tensors the kernel launches or raises: there is no fallback to the
plain version, and no environment switch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.entropy_bits import pair_cost_triton
from repro_torch.kernels.merge_gain import merge_gain_cuda


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
    return ref.merge_gain_ref(m, n, s, t, n_u, cidx, w, scal[0], scal[1])


def pair_cost(cnt, pi, scal, *, backend: str | None = None):
    """Optimal per-pair description cost min(C̄+Cost₍₁₎, Cost₍₂₎), f32[E]."""
    if _use_kernel(cnt, backend):
        return pair_cost_triton(cnt, pi, scal)
    return ref.pair_cost_ref(cnt, pi, scal[0], scal[1])


def launch_counts() -> dict[str, int]:
    """How often each hand kernel has launched in this process."""
    return {"merge_gain": merge_gain_cuda.launches,
            "pair_cost": pair_cost_triton.launches}


def reset_launch_counts() -> None:
    merge_gain_cuda.launches = 0
    pair_cost_triton.launches = 0
