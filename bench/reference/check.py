"""Whether what the timed path returned is right: the numbers compared.

Two kinds of evidence are judged against :mod:`bench.reference.summary`,
which works everything out again from the input edge list:

* each summary a run returned (``judge_summary``): its partition, every
  superedge and weight, the kept set against the keep rule and the final
  sparsification's threshold, Size, RE₁ and RE₂, and the budget;
* one merge round, captured on the timed path (``judge_capture``): the
  pair table's sampled rows and the sampled groups' tables (every count of
  the union-space table ``m``, the column sizes ``n_u``, the members' own
  columns ``cidx``, the pair counts ``w``, the sizes, self counts and
  Cost*_A totals) against the reference's at the round's partition, each
  member's neighbours cut to its ``D`` heaviest and each group's union to
  ``U`` columns by the rule stated in :func:`summary.group_tables`; the
  pair-cost and merge-gain kernels' outputs against the frozen plain
  versions on the same operands; and the round's new partition against the
  matching the kernel's gains imply (mutual best above θ).

The groups themselves (which supernodes are candidates together) are the
program's draw: the reference judges the tables, gains and merges of the
groups it drew.

Counts of faults are exact (limit 0); the gaps are relative and get limits
from readings (``bench/limits/<cell>.json``): ``metric_gap`` (Size, RE₁,
RE₂), ``cost_gap`` (the pair-cost kernel's rows, the Cost*_A totals, C̄ and
log₂V) and ``gain_gap`` (the merge gain).
"""

from __future__ import annotations

import dataclasses
import math
import random

import numpy as np
import torch

from bench.reference import kernels, summary

F64 = torch.float64

#: numbers whose limit is 0
EXACT = ("partition_faults", "weight_faults", "keep_faults", "over_budget",
         "table_faults", "round_faults")
GAPS = ("metric_gap", "cost_gap", "gain_gap")
NUMBERS = EXACT + GAPS

#: a keep decision, or a drop threshold, within this share of its bits of a
#: tie is float32's to decide: the program computes both sides in float32
TIE_SHARE = 1e-5
#: Size may pass k by float32's rounding of the two sides: 2**-20 is 8 ulps
BUDGET_SLACK = 2.0 ** -20
#: groups and pair-table rows sampled from the captured round
GROUPS = 64
PAIR_ROWS = 65536


def capture_round(seed: int, rounds: int) -> int:
    """The round of a run that the check captures, drawn from the seed over
    all the run's ``rounds`` (runs of one seed take the same rounds)."""
    return random.Random(seed).randint(1, max(int(rounds), 1))


@dataclasses.dataclass
class Summary:
    """What one run returned, as the judge reads it (host arrays)."""

    node2super: np.ndarray
    super_size: np.ndarray
    edge_lo: np.ndarray
    edge_hi: np.ndarray
    edge_w: np.ndarray
    num_supernodes: int
    num_superedges: int
    size_bits: float
    re1: float
    re2: float
    nmerges: float  # Σ over the rounds' reported merges

    @classmethod
    def of(cls, res) -> "Summary":
        return cls(node2super=res.node2super, super_size=res.super_size,
                   edge_lo=res.edge_lo, edge_hi=res.edge_hi, edge_w=res.edge_w,
                   num_supernodes=res.num_supernodes, num_superedges=res.num_superedges,
                   size_bits=res.size_bits, re1=res.re1, re2=res.re2,
                   nmerges=float(sum(row["nmerges"] for row in res.history)))

    def digest(self) -> tuple:
        return (self.node2super.tobytes(), self.edge_lo.tobytes(), self.edge_hi.tobytes(),
                self.edge_w.tobytes(), self.size_bits, self.re1, self.re2)


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x))


def _gap(got, want) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-300)


def judge_summary(src, dst, num_nodes: int, k_bits: float, out: Summary) -> dict:
    """The summary numbers of one returned summary."""
    v = num_nodes
    n2s = _t(out.node2super).long()
    partition = int(((n2s < 0) | (n2s >= v)).sum())
    n2s = n2s.clamp(0, v - 1)
    size = summary.sizes(n2s, v)
    partition += int((size != _t(out.super_size).long()).sum())
    s_count = int((size > 0).sum())
    partition += int(out.num_supernodes != s_count)
    # every merge joins two live supernodes: V − |S| merges in all
    partition += abs(int(round(out.nmerges)) - (v - s_count))

    lo, hi, cnt = summary.pair_table(src, dst, n2s, v)
    key = lo * v + hi
    elo, ehi = _t(out.edge_lo).long(), _t(out.edge_hi).long()
    ew = _t(out.edge_w).long()
    ekey = elo.clamp(0, v - 1) * v + ehi.clamp(0, v - 1)
    pos = torch.searchsorted(key, ekey).clamp(max=max(key.numel() - 1, 0))
    found = (key[pos] == ekey) & (elo <= ehi) & (elo >= 0) & (ehi < v)
    weight = int((~found).sum()) + int((ew[found] != cnt[pos[found]]).sum())
    weight += ekey.numel() - int(torch.unique(ekey).numel())
    weight += int(out.num_superedges != ekey.numel())
    kept = torch.zeros(key.numel(), dtype=torch.bool)
    kept[pos[found]] = True

    pi = summary.pair_pi(lo, hi, size)
    cbar = summary.cbar_tight(s_count, cnt.max(), F64)
    log2v = torch.log2(torch.tensor(float(v), dtype=F64))
    keep0, margin = summary.mdl_keep(cnt, pi, size, lo, hi, cbar, log2v)
    sure = margin > TIE_SHARE
    keep_faults = int((kept & ~keep0 & sure).sum())
    # the final sparsification drops every kept superedge whose ΔRE₁ is at
    # most a threshold: no dropped one may lie above a kept one
    dropped = keep0 & ~kept & sure
    kept_sure = kept & keep0 & sure
    if bool(dropped.any()) and bool(kept_sure.any()):
        delta = summary.drop_increase(cnt, pi)
        floor = delta[kept_sure].min()
        keep_faults += int((delta[dropped] > floor + TIE_SHARE * floor.abs().clamp(min=1.0)).sum())

    ref = summary.summary_metrics(v, s_count, cnt[kept], pi[kept], cnt[~kept], F64)
    metric_gap = max(_gap(out.size_bits, ref["size_bits"]), _gap(out.re1, ref["re1"]),
                     _gap(out.re2, ref["re2"]))
    over = int(float(ref["size_bits"]) > k_bits * (1.0 + BUDGET_SLACK))
    return {"partition_faults": partition, "weight_faults": weight,
            "keep_faults": keep_faults, "over_budget": over, "metric_gap": metric_gap,
            "re1": float(ref["re1"])}


@dataclasses.dataclass
class Capture:
    """One merge round of one run, as captured on the timed path (host
    arrays): the partition and sizes before and after the round, the pair
    table's sampled rows with the pair-cost kernel's output, and the sampled
    groups' members, operands and merge-gain output."""

    round: int
    theta: float
    nmerges: float
    n2s_before: np.ndarray
    size_before: np.ndarray
    n2s_after: np.ndarray
    size_after: np.ndarray
    rows: np.ndarray
    pc_cnt: np.ndarray
    pc_pi: np.ndarray
    pc_out: np.ndarray
    members: np.ndarray
    m: np.ndarray
    n: np.ndarray
    s: np.ndarray
    t: np.ndarray
    n_u: np.ndarray
    cidx: np.ndarray
    w: np.ndarray
    scal: np.ndarray
    rel: np.ndarray
    red: np.ndarray


@dataclasses.dataclass
class RoundReference:
    """The reference's tables at a captured round's partition."""

    size: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    cnt: torch.Tensor
    pi: torch.Tensor
    cbar: torch.Tensor
    log2v: torch.Tensor
    self_cnt: torch.Tensor
    totals: torch.Tensor


def round_reference(src, dst, num_nodes: int, n2s_before: np.ndarray, dtype=F64
                    ) -> RoundReference:
    v = num_nodes
    n2s = _t(n2s_before).long().clamp(0, v - 1)
    size = summary.sizes(n2s, v)
    lo, hi, cnt = summary.pair_table(src, dst, n2s, v)
    pi = summary.pair_pi(lo, hi, size)
    cbar = summary.cbar_tight(int((size > 0).sum()), cnt.max(), dtype)
    log2v = torch.log2(torch.tensor(float(v), dtype=dtype))
    self_cnt = torch.zeros(v, dtype=torch.int64)
    own = lo == hi
    self_cnt[lo[own]] = cnt[own]
    totals = summary.total_costs(lo, hi, cnt, pi, cbar, log2v, v, dtype)
    return RoundReference(size=size, lo=lo, hi=hi, cnt=cnt, pi=pi, cbar=cbar,
                          log2v=log2v, self_cnt=self_cnt, totals=totals)


def _rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.numel() == 0:
        return 0.0
    return float(((got.double() - want.double()).abs()
                  / want.double().abs().clamp(min=1.0)).max())


def judge_capture(src, dst, num_nodes: int, cap: Capture, max_neighbors: int,
                  ref: RoundReference | None = None) -> dict:
    """The round numbers of one captured round, whose tables kept
    ``max_neighbors`` neighbours of each member."""
    v = num_nodes
    if ref is None:
        ref = round_reference(src, dst, v, cap.n2s_before)
    size = ref.size
    table = int((size != _t(cap.size_before).long()).sum())

    # the pair table's sampled rows, in the program's (ascending key) order
    rows = _t(cap.rows).long()
    inside = rows < ref.cnt.numel()
    r_in = rows[inside]
    cnt_p, pi_p = _t(cap.pc_cnt).double(), _t(cap.pc_pi).double()
    table += int((cnt_p[inside] != ref.cnt[r_in].double()).sum())
    # |Π| in float32 is the exact product rounded once
    table += int((pi_p[inside] != ref.pi[r_in].to(torch.float32).double()).sum())
    table += int((cnt_p[~inside] != 0).sum())
    want_pc = torch.zeros(rows.numel(), dtype=F64)
    want_pc[inside] = kernels.pair_cost(ref.cnt[r_in].double(), ref.pi[r_in].double(),
                                        ref.cbar, ref.log2v)
    pair_cost_gap = _rel_gap(_t(cap.pc_out), want_pc)

    # the group tables' exact parts: sizes, self counts, Cost*_A totals
    members = _t(cap.members).long()
    real = members >= 0
    mid = members.clamp(0, v - 1)
    want_n = torch.where(real, size[mid], 0)
    table += int((_t(cap.n).double() != want_n.double()).sum())
    live = real & (want_n > 0)
    want_s = torch.where(live, ref.self_cnt[mid], 0)
    table += int((_t(cap.s).double() != want_s.double()).sum())
    # the union-space tables, every entry exact
    want = summary.group_tables(ref.lo, ref.hi, ref.cnt, size, members, max_neighbors,
                                cap.m.shape[-1], v)
    for got, exact in zip((cap.m, cap.n_u, cap.cidx, cap.w), want):
        table += int((_t(got).double() != exact.double()).sum())
    want_t = torch.where(live, ref.totals[mid], torch.zeros((), dtype=ref.totals.dtype))
    # one number for the costs: the pair-cost kernel's rows alone need not
    # separate from a lower precision (in the first rounds most rows take the
    # explicit cost 2|E|log₂V, an exact integer), their totals always do
    cost_gap = max(pair_cost_gap, _rel_gap(_t(cap.t)[live], want_t[live]),
                   _rel_gap(_t(cap.scal[:1]), ref.cbar.reshape(1)),
                   _rel_gap(_t(cap.scal[1:]), ref.log2v.reshape(1)))

    # the merge gain on the captured operands
    ops = [_t(x).double() for x in (cap.m, cap.n, cap.s, cap.t, cap.n_u)]
    scal = _t(cap.scal).double()
    rel_r, red_r, denom = kernels.merge_gain(*ops, _t(cap.cidx), _t(cap.w).double(),
                                             scal[0], scal[1])
    rel_p, red_p = _t(cap.rel).double(), _t(cap.red).double()
    valid_r, valid_p = rel_r > -math.inf, rel_p > -math.inf
    scale = denom.abs().clamp(min=1.0)
    both = valid_r & valid_p
    gap = torch.zeros_like(rel_r)
    gap[both] = torch.maximum((rel_p - rel_r)[both].abs() * denom.abs()[both] / scale[both],
                              (red_p - red_r)[both].abs() / scale[both])
    gap[valid_r != valid_p] = 1.0
    gain_gap = float(gap.max()) if gap.numel() else 0.0

    # the round: mutual best partners above θ merge, as the gains say
    round_faults = abs(int(round(cap.nmerges))
                       - (int((size > 0).sum()) - int((_t(cap.size_after) > 0).sum())))
    theta = np.float32(cap.theta)
    rel32 = cap.rel.astype(np.float32)
    best_j = rel32.argmax(-1)
    best_v = rel32.max(-1)
    idx = np.arange(best_j.shape[1])[None, :]
    mutual = np.take_along_axis(best_j, best_j, 1) == idx
    mem = cap.members
    partner = np.take_along_axis(mem, best_j, 1)
    accept = mutual & (best_v > theta) & (idx < best_j) & (mem >= 0) & (partner >= 0)
    target = torch.arange(v)
    a, b = _t(mem[accept]).long(), _t(partner[accept]).long()
    target[b] = a
    live_ids = torch.unique(mid[live])
    before = _t(cap.n2s_before).long().clamp(0, v - 1)
    after = _t(cap.n2s_after).long()
    nodes = torch.isin(before, live_ids)
    round_faults += int((after[nodes] != target[before[nodes]]).sum())
    size_a = _t(cap.size_after).long()
    want_size = size.clone()
    want_size[a] = size[a] + size[b]
    want_size[b] = 0
    round_faults += int((size_a[live_ids] != want_size[live_ids]).sum())
    round_faults += int((summary.sizes(after.clamp(0, v - 1), v) != size_a).sum())
    return {"table_faults": table, "round_faults": round_faults,
            "cost_gap": cost_gap,
            "gain_gap": gain_gap}


def judge(src, dst, num_nodes: int, k_bits: float, max_neighbors: int,
          outs: list[Summary], caps: list[Capture]) -> tuple[dict, list[float]]:
    """Every number compared, over the runs' summaries (each distinct one
    judged once) and the captured rounds given; and the reference's RE₁ of
    each summary."""
    nums = {k: 0 for k in EXACT}
    nums.update({k: 0.0 for k in GAPS})
    seen: dict[tuple, dict] = {}
    re1 = []
    for out in outs:
        d = out.digest()
        if d not in seen:
            seen[d] = judge_summary(src, dst, num_nodes, k_bits, out)
        found = dict(seen[d])
        re1.append(found.pop("re1"))
        for k, x in found.items():
            nums[k] = max(nums[k], x)
    for cap in caps:
        for k, x in judge_capture(src, dst, num_nodes, cap, max_neighbors).items():
            nums[k] = max(nums[k], x)
    return nums, re1
