"""MDL cost function of SSumM (Sect. 3.1, Eq. 5–16) in closed, vectorized form.

Port of ``repro/core/costs.py``: ``entropy_bits``, ``explicit_bits``,
``pair_cost_star``, ``keep_superedge``, ``build_pair_table``, ``pair_pi``,
``input_size_bits``, ``cbar_value``, ``summary_metrics`` and
``supernode_total_costs``. Given a partition, every cost, size and error
quantity is closed-form per supernode pair {A,B} from ``cnt = |E_AB|`` and
``pi = |Π_AB|``, so the evaluation is one sort plus a segment-sum over the
edge list.

Counts (|S|, |P|, the pair counts) are summed as integers and cast to
float32: exact and independent of the summation order, as the reference's
float32 sums of ones are while they stay below 2²⁴.
"""

from __future__ import annotations

import torch

from repro_torch.core.types import PairTable, SummaryState
from repro_torch.kernels import ops, ref
from repro_torch.utils import boundaries_from_keys, f32math, segment_ids_from_boundaries

F32 = torch.float32


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=F32, device=x.device)


# ---------------------------------------------------------------------------
# Entropy encodings (Eq. 9, Eq. 10)
# ---------------------------------------------------------------------------


# The entropy term and the optimal per-pair cost are the plain versions of
# the pair-cost kernel, defined once in kernels/ref.py. The round's hot call
# goes to ``ops.pair_cost``.
entropy_bits = ref.entropy_bits_ref
pair_cost_star = ref.pair_cost_ref


def explicit_bits(cnt: torch.Tensor, log2v: torch.Tensor) -> torch.Tensor:
    """Cost₍₂₎: ``2|E_AB|log₂|V|``, Eq. (10)."""
    return 2.0 * cnt.to(F32) * log2v


def keep_superedge(cnt, pi, cbar, log2v, re_guard: int) -> torch.Tensor:
    """Eq. (11): keep {A,B} ∈ P iff the entropy encoding is cheaper.

    ``re_guard == 1`` (footnote 3) keeps only superedges whose dropping would
    not shrink RE₁ (σ ≥ 1/2); ``re_guard == 2`` never binds.
    """
    mdl_keep = (cbar + entropy_bits(cnt, pi)) < explicit_bits(cnt, log2v)
    keep = mdl_keep & (cnt > 0.0)
    if re_guard == 1:
        sigma = cnt / torch.clamp(pi, min=1.0)
        keep = keep & (2.0 * sigma - 1.0 >= 0.0)
    return keep


# ---------------------------------------------------------------------------
# Pair table: partition → {(A,B) : |E_AB| > 0} via sort + segment reduce
# ---------------------------------------------------------------------------


def build_pair_table(src: torch.Tensor, dst: torch.Tensor,
                     state: SummaryState) -> PairTable:
    """Aggregate the edge list into per-supernode-pair subedge counts.

    The reference sorts two int32 keys (``lo``, ``hi``); here one int64 key
    ``lo·V + hi`` gives the same order. Equal keys are equal rows, so the
    sort needs no stability.
    """
    e = src.shape[0]
    v = state.node2super.shape[0]
    su = state.node2super[src]
    sv = state.node2super[dst]
    lo = torch.minimum(su, sv)
    hi = torch.maximum(su, sv)
    key_s = torch.sort(lo * v + hi).values
    lo_s, hi_s = key_s // v, key_s % v
    pid = segment_ids_from_boundaries(boundaries_from_keys(key_s))
    npairs = pid[-1] + 1
    cnt = torch.zeros(e, dtype=torch.int64, device=src.device).index_add_(
        0, pid, torch.ones_like(pid))
    # reference: .at[pid].max(lo_s) — every row of a segment has the same lo
    plo = torch.zeros(e, dtype=torch.int64, device=src.device).scatter_(0, pid, lo_s)
    phi = torch.zeros(e, dtype=torch.int64, device=src.device).scatter_(0, pid, hi_s)
    valid = torch.arange(e, device=src.device) < npairs
    return PairTable(lo=plo, hi=phi, cnt=cnt.to(F32), valid=valid)


def pair_pi(pt: PairTable, size: torch.Tensor) -> torch.Tensor:
    """|Π_AB| per pair: n_A·n_B for A≠B, n_A(n_A-1)/2 for the self pair."""
    na = size[pt.lo].to(F32)
    nb = size[pt.hi].to(F32)
    pi = torch.where(pt.lo == pt.hi, na * (na - 1.0) * 0.5, na * nb)
    return torch.where(pt.valid, pi, _zero(pi))


# ---------------------------------------------------------------------------
# Global quantities: Eq. (3), Eq. (4), Eq. (14), RE_p (Eq. 2 closed form)
# ---------------------------------------------------------------------------


def f32_scalar(x: float, device) -> torch.Tensor:
    """A host number as a 0-d float32 tensor on ``device``. ``torch.full``
    fills it on the device; ``torch.tensor`` would copy it from the host and
    wait for the card's queue to drain, in the middle of a round."""
    return torch.full((), float(x), dtype=F32, device=device)


def log2_f32(x: float, device) -> torch.Tensor:
    """log₂ of a host number, taken in float32 as the reference takes it."""
    return f32math.log2(f32_scalar(x, device))


def input_size_bits(num_nodes: int, num_edges: int) -> float:
    """Size(G) = 2|E|log₂|V|, Eq. (3)."""
    return 2.0 * num_edges * float(log2_f32(num_nodes, "cpu"))


def cbar_value(mode: str, num_nodes: int, num_edges: int,
               num_supernodes: torch.Tensor, omega_max: torch.Tensor) -> torch.Tensor:
    """C̄ — per-superedge model cost. Paper: Eq. (6); tight: footnote 3."""
    dev = num_supernodes.device
    if mode == "paper":
        v = f32_scalar(num_nodes, dev)
        e = f32_scalar(num_edges, dev)
        return 2.0 * f32math.log2(v) + f32math.log2(torch.clamp(e, min=2.0))
    s = torch.clamp(num_supernodes.to(F32), min=2.0)
    w = torch.clamp(omega_max.to(F32), min=2.0)
    return 2.0 * f32math.log2(s) + f32math.log2(w)


def summary_metrics(pt: PairTable, state: SummaryState, num_nodes: int,
                    num_edges: int, cbar_mode: str = "tight", re_guard: int = 1,
                    drop_mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """All evaluation quantities for the current partition, in one pass.

    Paper P semantics (Alg. 1 lines 2 & 7): superedges are re-decided
    (Eq. 11 + RE guard) only when adjacent to a merged supernode, i.e. when
    ``size[A] > 1 or size[B] > 1``; untouched singleton pairs stay in P.
    ``drop_mask`` marks superedges removed by further sparsification.
    Returns 0-d float32 tensors (and the bool ``keep`` mask) on the device.
    """
    dev = pt.cnt.device
    v = f32_scalar(num_nodes, dev)
    log2v = f32math.log2(v)
    s_count = (state.size > 0).sum().to(F32)
    pi = pair_pi(pt, state.size)
    zero = _zero(pt.cnt)
    omega_max_all = torch.max(torch.where(pt.valid, pt.cnt, zero))
    cbar = cbar_value(cbar_mode, num_nodes, num_edges, s_count, omega_max_all)
    touched = (state.size[pt.lo] > 1) | (state.size[pt.hi] > 1)
    decided = keep_superedge(pt.cnt, pi, cbar, log2v, re_guard)
    keep = torch.where(touched, decided, pt.cnt > 0.0) & pt.valid
    if drop_mask is not None:
        keep = keep & ~drop_mask

    cntk = torch.where(keep, pt.cnt, zero)
    sigma = torch.where(keep, pt.cnt / torch.clamp(pi, min=1.0), zero)

    # --- Eq. (4): realized summary size --------------------------------
    p_count = keep.sum().to(F32)
    omega_max = torch.max(cntk)
    log2s = f32math.log2(torch.clamp(s_count, min=2.0))
    log2w = f32math.log2(torch.clamp(omega_max, min=2.0))
    size_bits = p_count * (2.0 * log2s + log2w) + v * log2s

    # --- Eq. (14): MDL description cost (upper-bound C̄ per the paper) ---
    log2e = f32math.log2(torch.clamp(
        f32_scalar(num_edges, dev), min=2.0))
    cbar_paper = 2.0 * log2v + log2e
    kept_bits = cbar_paper + entropy_bits(pt.cnt, pi)
    drop_bits = explicit_bits(pt.cnt, log2v)
    per_pair = torch.where(keep, kept_bits, torch.where(pt.valid, drop_bits, zero))
    mdl_cost = v * log2v + torch.sum(per_pair)

    # --- Eq. (2) closed forms (unordered; ×2 for the full matrix) -------
    re1_kept = 2.0 * cntk * (1.0 - sigma)
    re2_kept = cntk * (1.0 - sigma)
    dropped_cnt = torch.where(pt.valid & ~keep, pt.cnt, zero)
    re1_sum = torch.sum(re1_kept) + torch.sum(dropped_cnt)
    re2_sq = torch.sum(re2_kept) + torch.sum(dropped_cnt)
    denom = v * (v - 1.0)
    re1 = 2.0 * re1_sum / denom
    re2 = torch.sqrt(2.0 * re2_sq) / denom

    return {
        "size_bits": size_bits,
        "mdl_cost": mdl_cost,
        "re1": re1,
        "re2": re2,
        "num_supernodes": s_count,
        "num_superedges": p_count,
        "omega_max": omega_max,
        "keep": keep,
        "cbar": cbar,
        "membership_bits": v * log2s,
    }


def supernode_total_costs(pt: PairTable, pi: torch.Tensor, scal: torch.Tensor,
                          num_nodes: int, backend: str | None = None) -> torch.Tensor:
    """``Cost*_A(S)`` per supernode id (Eq. 16): each pair's optimal cost,
    added to both endpoints (self pairs once).

    The per-pair cost is the pair-cost kernel (``ops.pair_cost``), where the
    reference computes ``pair_cost_star`` with jnp (``costs.py:239``).
    ``index_add_`` of float costs sums in a run-dependent order on CUDA
    (atomics), so card runs are not bit-reproducible here; on the CPU the
    order is the reference's (all ``lo`` adds, then all ``hi`` adds).
    """
    cost = torch.where(pt.valid, ops.pair_cost(pt.cnt, pi, scal, backend=backend),
                       _zero(pi))
    out = torch.zeros(num_nodes, dtype=F32, device=pi.device)
    out.index_add_(0, pt.lo, cost)
    out.index_add_(0, pt.hi, torch.where(pt.lo != pt.hi, cost, _zero(cost)))
    return out
