"""Plain PyTorch versions of the hand kernels.

Port of ``repro/kernels/ref.py`` (``entropy_bits_ref``, ``pair_cost_ref``,
``merge_gain_ref``), operation for operation in the reference's order, and
``segment_sum_ref`` and ``ordered_sum_ref``, the query engine's fixed-order
sums. They are what a CPU tensor runs (:mod:`repro_torch.kernels.ops`) and
what the CUDA and Triton kernels are held against on the card.

On a CPU tensor, ``log2`` and the sums over U are taken as the reference's
XLA:CPU takes them (:mod:`repro_torch.utils.f32math`), so the gains agree
with the reference's to the last bit and its near-ties break the same way;
on a card's tensor they are ``torch.log2`` and ``torch.sum``.

``merge_gain_ref`` materialises a ``[G, C, C, U]`` tensor: at skitter size
(G = 65,536, C = 32, U = 128) that is about 34 GB, so on the card it is only
ever run on a slice of the groups.
"""

from __future__ import annotations

import torch

from repro_torch.utils import f32math


def entropy_bits_ref(cnt: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """``-|Π|(σlog₂σ+(1-σ)log₂(1-σ))`` with 0·log0 := 0 (Eq. 9 sans C̄)."""
    pi = pi.to(torch.float32)
    cnt = cnt.to(torch.float32)
    sigma = torch.clamp(cnt / torch.clamp(pi, min=1.0), 0.0, 1.0)
    zero = torch.zeros((), dtype=torch.float32, device=cnt.device)
    xlogx = torch.where(sigma > 0.0,
                        sigma * f32math.log2(torch.clamp(sigma, min=1e-38)), zero)
    one_m = 1.0 - sigma
    ylogy = torch.where(sigma < 1.0,
                        one_m * f32math.log2(torch.clamp(one_m, min=1e-38)), zero)
    return torch.where((pi > 0.0) & (cnt > 0.0) & (cnt < pi),
                       -pi * (xlogx + ylogy), zero)


def pair_cost_ref(cnt: torch.Tensor, pi: torch.Tensor, cbar: torch.Tensor,
                  log2v: torch.Tensor) -> torch.Tensor:
    """min(C̄ + Cost₍₁₎, Cost₍₂₎) per pair (Eq. 11/12); 0 where cnt == 0."""
    cnt_f = cnt.to(torch.float32)
    c1 = cbar + entropy_bits_ref(cnt_f, pi)
    c2 = 2.0 * cnt_f * log2v
    return torch.where(cnt_f > 0.0, torch.minimum(c1, c2),
                       torch.zeros((), dtype=torch.float32, device=cnt.device))


def merge_gain_ref(
    m: torch.Tensor,  # f32[G, C, U]
    n: torch.Tensor,  # f32[G, C]
    s: torch.Tensor,  # f32[G, C]
    t: torch.Tensor,  # f32[G, C]
    n_u: torch.Tensor,  # f32[G, U]
    cidx: torch.Tensor,  # i32[G, C]
    w: torch.Tensor,  # f32[G, C, C]
    cbar: torch.Tensor,  # f32 scalar
    log2v: torch.Tensor,  # f32 scalar
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense (G,C,C,U) evaluation of Relative_Reduction (Eq. 20) and
    Reduction (Eq. 17). Returns ``(rel, red)``: -inf and 0 on invalid
    entries (padding member, diagonal, or ``denom <= 1e-6``)."""
    g, c, u = m.shape

    def f(cnt, pi):
        # pair_cost_ref where cnt > 0 and 0 elsewhere, as pair_cost_ref gives:
        # the same values, with the log2 taken only on the nonzero entries of
        # the sparse [G,C,C,U] rows
        out = torch.zeros(cnt.shape, dtype=torch.float32, device=cnt.device)
        nz = cnt > 0.0
        out[nz] = pair_cost_ref(cnt[nz], pi[nz], cbar, log2v)
        return out

    # per-member exact-tail bookkeeping
    pi_row = n[..., None] * n_u[:, None, :]  # [G,C,U]
    row_cost = f32math.sum_last(f(m, pi_row))  # [G,C]
    self_cost = f(s, n * (n - 1.0) * 0.5)
    tail = torch.clamp(t - row_cost - self_cost, min=0.0)

    cols = torch.arange(u, dtype=torch.int64, device=m.device)
    onehot = (cols[None, None, :] == cidx[..., None].to(torch.int64)).to(
        torch.float32)  # [G,C,U]

    merged_cnt = m[:, :, None, :] + m[:, None, :, :]  # [G,C,C,U]
    npair = n[:, :, None] + n[:, None, :]  # [G,C,C]
    pi_m = npair[..., None] * n_u[:, None, None, :]
    fv = f(merged_cnt, pi_m)
    mask = 1.0 - onehot[:, :, None, :] - onehot[:, None, :, :]
    cross = f32math.sum_last(fv * mask)  # [G,C,C]

    s_m = s[:, :, None] + s[:, None, :] + w
    self_m = f(s_m, npair * (npair - 1.0) * 0.5)
    merged = cross + self_m + tail[:, :, None] + tail[:, None, :]

    denom = t[:, :, None] + t[:, None, :] - f(w, n[:, :, None] * n[:, None, :])
    red = denom - merged

    eye = torch.eye(c, dtype=torch.bool, device=m.device)[None]
    valid = (n[:, :, None] > 0) & (n[:, None, :] > 0) & ~eye & (denom > 1e-6)
    rel = torch.where(valid, 1.0 - merged / torch.clamp(denom, min=1e-6),
                      torch.full((), float("-inf"), device=m.device))
    red = torch.where(valid, red, torch.zeros((), device=m.device))
    return rel, red


def segment_sum_ref(indptr: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``out[r] = Σ vals[indptr[r]:indptr[r+1]]``, float64, added in storage
    order from zero on a CPU tensor (``index_add_`` there walks its indices in
    order, as ``np.add.at`` does); on a card's tensor ``index_add_`` adds with
    atomics, in no fixed order."""
    n_seg = indptr.numel() - 1
    lengths = indptr[1:] - indptr[:-1]
    seg = torch.repeat_interleave(torch.arange(n_seg, device=vals.device), lengths)
    out = torch.zeros(n_seg, dtype=torch.float64, device=vals.device)
    return out.index_add_(0, seg, vals[:seg.numel()].to(torch.float64))


def ordered_sum_ref(x: torch.Tensor, segment: int = 1024) -> torch.Tensor:
    """Row sums of ``x`` ([k, n] → float64[k]) in a fixed order: each row's
    ``segment``-value segments added left to right from zero, then those
    partial sums left to right from zero — two :func:`segment_sum_ref` passes
    with explicit offsets."""
    k, n = x.shape
    if k == 0 or n == 0:
        return torch.zeros(k, dtype=torch.float64, device=x.device)
    m = -(-n // segment)
    starts = (torch.arange(k, device=x.device)[:, None] * n
              + torch.arange(m, device=x.device)[None, :] * segment).reshape(-1)
    indptr = torch.cat([starts, starts.new_full((1,), k * n)])
    part = segment_sum_ref(indptr, x.reshape(-1).to(torch.float64))
    return segment_sum_ref(torch.arange(0, k * m + 1, m, device=x.device), part)
