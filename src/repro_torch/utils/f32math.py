"""Float32 ``log2`` and row sums, rounded on the CPU as the reference rounds them.

SSumM's decisions hinge on float comparisons between gains that are often
equal in exact arithmetic (two members with the same neighbor multiset):
which one wins is decided by the last bit. The reference runs on XLA:CPU,
whose ``jnp.log2`` and row reductions round differently from PyTorch's
``torch.log2`` and ``torch.sum`` in about one case in ten. So the port's
plain code takes ``log2`` and the gain row sums from here, and on a CPU
tensor its decisions come out as the reference's:

  * XLA:CPU computes a float32 ``log`` with a Cephes polynomial after an
    exponent/mantissa split, fusing its multiply-adds;
  * ``jnp.log2(x)`` is ``log(x) / log(2)``, which XLA rewrites as a multiply
    by the float32 reciprocal of ``log(2)``;
  * denormal inputs count as zero (``log`` gives -inf);
  * a float32 sum over a minor axis adds 32 elements at a time in order, then
    adds those partial sums in order.

On a card's tensor, ``log2`` is ``torch.log2``: the emulation's float64
multiply-adds would cost the card several passes over the E-row pair table
each round, and the hand kernels use ``log2f`` and are held to the
reference's tolerances, not to its last bit. ``sum_last`` adds in XLA:CPU's
order on every device: ``torch.sum`` on the card adds in a tree, and over
the merge gain's U = 256 columns its results drifted past the kernel's
``red`` tolerance from the order alone.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


def _c(x: float) -> float:
    """A constant rounded to float32 (and held exactly as a Python float)."""
    return float(np.float32(x))


_MIN_NORM = _c(1.17549435e-38)
_SQRTHF = _c(0.707106781186547524)
_P = [_c(p) for p in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                      -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                      2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)]
_Q1 = _c(-2.12194440e-4)
_Q2 = _c(0.693359375)
_INV_LN2 = _c(np.float32(1.0) / np.float32(np.log(2.0)))
INV_LN2 = _INV_LN2

SUM_CHUNK = 32


def fma(a, b, c) -> torch.Tensor:
    """float32 fused multiply-add, through float64 (a·b is exact there)."""
    a = a.double() if isinstance(a, torch.Tensor) else a
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a * b + c).to(F32)


def log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of a float32 tensor, as XLA:CPU computes it."""
    x = x.to(F32)
    v = torch.clamp(x, min=_MIN_NORM)
    bits = v.view(torch.int32)
    exponent = (bits >> 23) - 0x7F
    frac = ((bits & ~0x7F800000) | 0x3F000000).view(F32)  # mantissa in [0.5, 1)
    e = 1.0 + exponent.to(F32)
    low = frac < _SQRTHF
    zero = torch.zeros((), dtype=F32, device=x.device)
    t = frac - 1.0
    e = e - torch.where(low, 1.0, zero)
    t = t + torch.where(low, frac, zero)
    t2 = t * t
    t3 = t2 * t
    y = fma(t, _P[0], _P[1])
    y1 = fma(t, _P[3], _P[4])
    y2 = fma(t, _P[6], _P[7])
    y = fma(y, t, _P[2])
    y1 = fma(y1, t, _P[5])
    y2 = fma(y2, t, _P[8])
    y = fma(y, t3, y1)
    y = fma(y, t3, y2)
    y = fma(y, t3, e * _Q1)
    t = t - 0.5 * t2
    t = t + y
    out = fma(e, _Q2, t)
    # XLA:CPU flushes denormals to zero: log of a denormal is -inf
    out = torch.where((x >= 0.0) & (x < _MIN_NORM), float("-inf"), out)
    out = torch.where(x == float("inf"), float("inf"), out)
    return torch.where(x < 0.0, float("nan"), out)


def log2_xla(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2`` of a float32 tensor as XLA:CPU computes it, on any device."""
    return log(x) * _INV_LN2


def log2(x: torch.Tensor) -> torch.Tensor:
    """``log2`` of a float32 tensor: XLA:CPU's rounding on a CPU tensor,
    ``torch.log2`` on a card's."""
    if x.device.type == "cpu":
        return log2_xla(x)
    return torch.log2(x.to(F32))


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA:CPU's order, on any device: in order
    within chunks of 32 elements, then the chunk sums in order."""
    total = None
    for start in range(0, x.shape[-1], SUM_CHUNK):
        chunk = x[..., start:start + SUM_CHUNK]
        acc = chunk[..., 0]
        for k in range(1, chunk.shape[-1]):
            acc = acc + chunk[..., k]
        total = acc if total is None else total + acc
    if total is None:
        return x.sum(dim=-1)
    return total
