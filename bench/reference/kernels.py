"""Plain versions of the two hand kernels, frozen here as the yardstick.

Copies of the port's plain versions (the pair cost, Eq. 11/12, and the dense
merge gain, Eq. 17/20), in plain PyTorch on the CPU and in any float dtype:
float64 for the reference, bfloat16 for the control. Sums are plain
``torch.sum``; no order of addition is copied, since the reference is held
to the program by a tolerance, not bit for bit.
"""

from __future__ import annotations

import torch


def entropy_bits(cnt: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """``-|Π|(σlog₂σ + (1-σ)log₂(1-σ))`` with 0·log0 := 0 (Eq. 9 without C̄)."""
    zero = torch.zeros((), dtype=cnt.dtype)
    tiny = torch.full((), 1e-38, dtype=cnt.dtype)
    sigma = torch.clamp(cnt / torch.clamp(pi, min=1.0), 0.0, 1.0)
    xlogx = torch.where(sigma > 0, sigma * torch.log2(torch.maximum(sigma, tiny)), zero)
    one_m = 1.0 - sigma
    ylogy = torch.where(sigma < 1, one_m * torch.log2(torch.maximum(one_m, tiny)), zero)
    return torch.where((pi > 0) & (cnt > 0) & (cnt < pi), -pi * (xlogx + ylogy), zero)


def pair_cost(cnt: torch.Tensor, pi: torch.Tensor, cbar, log2v) -> torch.Tensor:
    """min(C̄ + Cost₍₁₎, Cost₍₂₎) per pair; 0 where cnt == 0 (Eq. 11/12)."""
    c1 = cbar + entropy_bits(cnt, pi)
    c2 = 2.0 * cnt * log2v
    return torch.where(cnt > 0, torch.minimum(c1, c2), torch.zeros((), dtype=cnt.dtype))


def merge_gain(m, n, s, t, n_u, cidx, w, cbar, log2v):
    """Relative_Reduction (Eq. 20) and Reduction (Eq. 17) of every pair of
    members of every group, and the denominator, from the group tables:
    ``m`` [G,C,U], ``n``, ``s``, ``t`` [G,C], ``n_u`` [G,U], ``cidx`` [G,C]
    (a member's own column, U = absent), ``w`` [G,C,C]. All float tensors
    share one dtype. Returns ``(rel, red, denom)``; ``rel`` is -inf and
    ``red`` 0 on invalid entries (a padding member, the diagonal, or
    ``denom <= 1e-6``)."""
    g, c, u = m.shape
    dt = m.dtype

    def f(cnt, pi):
        return pair_cost(cnt, pi, cbar, log2v)

    # the member's cost outside the union columns and its self pair
    row_cost = f(m, n[..., None] * n_u[:, None, :]).sum(-1)
    self_cost = f(s, n * (n - 1.0) * 0.5)
    tail = torch.clamp(t - row_cost - self_cost, min=0.0)

    cols = torch.arange(u)
    onehot = (cols[None, None, :] == cidx[..., None].long()).to(dt)  # [G,C,U]
    merged_cnt = m[:, :, None, :] + m[:, None, :, :]  # [G,C,C,U]
    npair = n[:, :, None] + n[:, None, :]
    fv = f(merged_cnt, npair[..., None] * n_u[:, None, None, :])
    mask = 1.0 - onehot[:, :, None, :] - onehot[:, None, :, :]
    cross = (fv * mask).sum(-1)
    s_m = s[:, :, None] + s[:, None, :] + w
    merged = cross + f(s_m, npair * (npair - 1.0) * 0.5) + tail[:, :, None] + tail[:, None, :]
    denom = t[:, :, None] + t[:, None, :] - f(w, n[:, :, None] * n[:, None, :])
    eye = torch.eye(c, dtype=torch.bool)[None]
    valid = (n[:, :, None] > 0) & (n[:, None, :] > 0) & ~eye & (denom > 1e-6)
    rel = torch.where(valid, 1.0 - merged / torch.clamp(denom, min=1e-6),
                      torch.full((), float("-inf"), dtype=dt))
    red = torch.where(valid, denom - merged, torch.zeros((), dtype=dt))
    return rel, red, denom
