"""Plain PyTorch versions of the hand kernels.

Port of ``repro/kernels/ref.py`` (``entropy_bits_ref``, ``pair_cost_ref``,
``merge_gain_ref``), operation for operation in the reference's order;
``group_tables_ref``, the union-space chain of
``repro/core/tables.py::assemble_group_tables``; and ``segment_sum_ref`` and
``ordered_sum_ref``, the query engine's fixed-order sums. They are what a CPU tensor runs (:mod:`repro_torch.kernels.ops`) and
what the CUDA and Triton kernels are held against on the card.

The sums over U are added in the reference's XLA:CPU order on every
device, and on a CPU tensor ``log2`` is taken as XLA:CPU takes it
(:mod:`repro_torch.utils.f32math`), so there the gains agree with the
reference's to the last bit and its near-ties break the same way; on a
card's tensor ``log2`` is ``torch.log2``.

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


def group_tables_ref(nbr_id: torch.Tensor, nbr_cnt: torch.Tensor, rows: torch.Tensor,
                     midx: torch.Tensor, alive: torch.Tensor, sizes: torch.Tensor,
                     union_size: int, num_nodes: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Union-space tables of every group: ``(m float32[G, C, U], n_u
    float32[G, U], cidx int32[G, C], w float32[G, C, C])``.

    ``rows`` is each member's row of ``nbr_id``/``nbr_cnt``, ``midx`` its
    supernode id, ``alive`` whether it counts. The reference's
    ``.at[...].set/min/add(mode="drop")`` scatters become ``scatter_reduce_``
    (``amin``, ``include_self=True``) and ``scatter_add_`` onto a tensor with
    one sentinel column that is then sliced off.
    """
    v = num_nodes
    g_cnt, c = rows.shape
    u = union_size
    d = nbr_id.shape[-1]
    dev = rows.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    tab_id = torch.where(alive[..., None], nbr_id[rows], v)  # [G, C, D]
    tab_cnt = torch.where(alive[..., None], nbr_cnt[rows], zero)

    # ---- union space: batched sort along the last axis ------------------
    flat_id = tab_id.reshape(g_cnt, c * d)
    flat_cnt = tab_cnt.reshape(g_cnt, c * d)
    # Sorted by id alone: a stable sort keeps the member (row) order inside
    # equal ids, as the reference's sort does.
    ids_s, perm = torch.sort(flat_id, dim=1, stable=True)
    row_s = perm // d
    cnt_s = torch.gather(flat_cnt, 1, perm)
    first = torch.ones_like(ids_s, dtype=torch.bool)
    first[:, 1:] = ids_s[:, 1:] != ids_s[:, :-1]
    col = torch.cumsum(first.to(torch.int64), dim=1) - 1  # [G, C*D]
    entry_ok = (ids_s < v) & (col < u)

    col_safe = torch.where(entry_ok, col, u)  # sentinel column u
    uid = torch.full((g_cnt, u + 1), v, dtype=torch.int64, device=dev)
    uid = uid.scatter_reduce_(1, col_safe, torch.where(entry_ok, ids_s, v),
                              reduce="amin", include_self=True)[:, :u]
    m = torch.zeros(g_cnt, c * (u + 1), dtype=torch.float32, device=dev)
    m.scatter_add_(1, row_s * (u + 1) + col_safe, torch.where(entry_ok, cnt_s, zero))
    m = m.reshape(g_cnt, c, u + 1)[:, :, :u].contiguous()

    n_u = torch.where(uid < v, sizes[torch.clamp(uid, max=v - 1)], 0).to(torch.float32)

    # member's own column in union space (U = absent); argmax takes the first
    eq = (uid[:, None, :] == midx[:, :, None]) & alive[:, :, None]  # [G,C,U]
    found = eq.any(dim=-1)
    cidx = torch.where(found, torch.argmax(eq.to(torch.uint8), dim=-1), u)
    cidx = cidx.to(torch.int32)

    # within-group pair counts from either row's table (max recovers entries
    # truncated out of one of the two rows)
    cj = torch.clamp(cidx, max=u - 1).to(torch.int64)[:, None, :].expand(g_cnt, c, c)
    w1 = torch.gather(m, 2, cj)
    w1 = torch.where((cidx < u)[:, None, :], w1, zero)
    w = torch.maximum(w1, w1.transpose(1, 2)).contiguous()
    return m, n_u, cidx, w


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
