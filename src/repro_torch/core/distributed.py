"""Edge-sharded SSumM over ``torch.distributed``.

Port of ``repro/core/distributed.py``. The edges are split over the P ranks
of one process group (:mod:`repro_torch.graphs.feed`); the partition
(``node2super``, ``size``) is held whole on every rank. Where the reference
runs a ``shard_map`` body, each rank runs the same PyTorch code on its
shard, and the reference's collectives become ``torch.distributed`` calls:
NCCL on the card, gloo on the CPU.

  * **Ownership**, two groupings of one backend
    (:func:`make_distributed_backend`):

      - ``grouping="hash"``: supernode ``A`` belongs to rank
        ``owner_hash(A, salt) mod P``, with a new salt every round;
      - ``grouping="compact"``: the candidate groups are computed the same on
        every rank (shingles reduced with ``all_reduce(MIN)``, then one
        chunking) and rank ``r`` owns groups ``g ≡ r (mod P)``, with compact
        ``[G_own·C, D]`` neighbor tables.

  * **Pair exchange**: each rank aggregates its shard into partial
    ``(lo, hi, cnt)`` records and routes each to both endpoint owners through
    fixed-size ``[P, cap, 3]`` buckets and ``all_to_all_single``; records
    that do not fit are counted (``overflow``), never dropped silently. The
    records are int32 — the reference packs them into float32 (``_route``,
    ``distributed.py:135``), which holds ids exactly only below 2²⁴.
  * **Merge round**: owners build group tables and run the merge-gain
    kernel (``ops.merge_gain``), and, on the compact path, the pair-cost
    kernel in the owned rows' total costs
    (``tables.supernode_total_costs_compact``). The accepted ``(a, b)``
    lists are gathered in rank order and applied to the partition on every
    rank alike.
  * **Metrics**: per-pair closed forms summed over lo-owned pairs (each pair
    once): integer sums with ``all_reduce(SUM)``, maxima with
    ``all_reduce(MAX)``, float sums gathered and added in rank order
    (:func:`_ordered_psum`).
  * **Sparsification** (Sect. 3.2.4): pairs go to their lo owner only; the
    ξ-th smallest ΔRE comes from ``sparsify.select_delta_xi`` with the
    histograms summed across ranks; the drop mask stays with its owner.

The engine (:class:`~repro_torch.core.engine.SummaryEngine`) drives a
:class:`DistributedBackend` as it drives the local one: ``run_chunk`` is a
host loop over the chunk's rounds with one read-back a round.

Every round's permutations come from a
:class:`~repro_torch.core.shingles.RoundPermutationSource` by ``(round,
rank)``: the compact grouping's ``h`` is rank 0's draw on every rank, the
hash grouping's ``(h, tie)`` each rank's own.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import costs, shingles, sparsify, tables
from repro_torch.core.merge import apply_merges, select_matching
from repro_torch.core.shingles import RoundPermutationSource, SeededPermutations
from repro_torch.core.types import (
    PairTable,
    SummaryConfig,
    SummaryState,
    init_state,
    resolve_device,
)
from repro_torch.dist import owner_hash
from repro_torch.kernels import ops
from repro_torch.utils import boundaries_from_keys, segment_ids_from_boundaries, segment_start
from repro_torch.utils import f32math

F32 = torch.float32

# Per-round scalar stats of the distributed merge step, in the reference's
# order, and ω_max: Eq. (4) charges every superedge log₂ω_max bits, so the
# size rises in a round where ω_max rises.
DIST_STAT_KEYS = (
    "size_bits",
    "re1",
    "nmerges",
    "num_supernodes",
    "num_superedges",
    "overflow",
    "omega_max",
)


class RankGroup:
    """The process group a backend runs over, with the reference's reductions.

    ``group`` (a ``torch.distributed`` process group), else the default group
    when it is initialized; a group of one (every collective the identity)
    when it is not.
    """

    def __init__(self, device: torch.device, group=None):
        self.device = device
        self.pg = group
        self.active = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank(group) if self.active else 0
        self.size = dist.get_world_size(group) if self.active else 1
        self.backend = dist.get_backend(group) if self.active else None
        if self.backend == "nccl" and device.type != "cuda":
            raise ValueError("an NCCL group needs the backend's tensors on CUDA; "
                             f"got device {device}")
        if self.active and self.backend != "nccl" and device.type == "cuda":
            raise ValueError(f"the {self.backend!r} group cannot carry this backend's "
                             "CUDA tensors; initialize torch.distributed with NCCL")

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``psum``/``pmax``/``pmin``: ``op`` in {"sum", "max", "min"}; returns a
        new tensor (bools travel as int32)."""
        if self.size == 1:
            return x
        y = x.to(torch.int32) if x.dtype == torch.bool else x.clone()
        dist.all_reduce(y, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                               "min": dist.ReduceOp.MIN}[op], group=self.pg)
        return y.to(x.dtype)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
        order: ``all_gather(tiled=True)``."""
        if self.size == 1:
            return x
        src = x.to(torch.int32) if x.dtype == torch.bool else x.contiguous()
        out = torch.empty((self.size * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, src, group=self.pg)
        return out.to(x.dtype)

    def all_to_all(self, buck: torch.Tensor) -> torch.Tensor:
        """``buck[d]`` goes to rank ``d``; returns ``recv[s]``, what rank ``s``
        sent here."""
        if self.size == 1:
            return buck
        out = torch.empty_like(buck)
        dist.all_to_all_single(out, buck.contiguous(), group=self.pg)
        return out


def _ordered_psum(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """A float sum across ranks that does not depend on the collective's
    grouping: gather the partials, add them in rank order."""
    parts = group.all_gather(x.reshape(1))
    acc = parts[0]
    for r in range(1, parts.shape[0]):
        acc = acc + parts[r]
    return acc


def _local_pairs(src_l, dst_l, node2super, num_nodes: int):
    """This shard's partial pair table ``(lo, hi, cnt int64, valid)``, rows
    sorted by ``(lo, hi)``, invalid rows (padding, the shard's tail) set to
    ``(0, 0, 0)``."""
    e = src_l.shape[0]
    v = num_nodes
    pad = src_l < 0
    su = torch.where(pad, v, node2super[torch.clamp(src_l, min=0)])
    sv = torch.where(pad, v, node2super[torch.clamp(dst_l, min=0)])
    lo = torch.minimum(su, sv)
    hi = torch.maximum(su, sv)
    key_s = torch.sort(lo * (v + 1) + hi).values
    lo_s, hi_s = key_s // (v + 1), key_s % (v + 1)
    pid = segment_ids_from_boundaries(boundaries_from_keys(key_s))
    cnt = torch.zeros(e, dtype=torch.int64, device=src_l.device).index_add_(
        0, pid, (lo_s < v).to(torch.int64))
    plo = torch.zeros(e, dtype=torch.int64, device=src_l.device).scatter_(0, pid, lo_s)
    phi = torch.zeros(e, dtype=torch.int64, device=src_l.device).scatter_(0, pid, hi_s)
    valid = (torch.arange(e, device=src_l.device) <= pid[-1]) & (plo < v) & (cnt > 0)
    zero = torch.zeros((), dtype=torch.int64, device=src_l.device)
    return (torch.where(valid, plo, zero), torch.where(valid, phi, zero),
            torch.where(valid, cnt, zero), valid)


def _route(plo, phi, cnt, valid, owner, n_ranks: int, cap: int):
    """Pack pair records into per-destination buckets ``int32[P, cap, 3]``
    (empty slots ``-1``); returns them and the count of records that did not
    fit."""
    n = plo.shape[0]
    dest = torch.where(valid, owner, n_ranks)
    order = torch.sort(dest, stable=True).indices
    dest_s = dest[order]
    slot = torch.arange(n, device=plo.device) - segment_start(boundaries_from_keys(dest_s))
    ok = (slot < cap) & (dest_s < n_ranks)
    flat = torch.where(ok, dest_s * cap + slot, n_ranks * cap)  # sentinel row
    rec = torch.stack([plo[order], phi[order], cnt[order]], dim=-1).to(torch.int32)
    buck = torch.full((n_ranks * cap + 1, 3), -1, dtype=torch.int32, device=plo.device)
    buck.index_copy_(0, flat, rec)
    overflow = ((~ok) & (dest_s < n_ranks)).sum()
    return buck[:-1].reshape(n_ranks, cap, 3), overflow


def _aggregate(recv: torch.Tensor, num_nodes: int):
    """Add up the partial records from every rank into exact global counts:
    ``(lo, hi, cnt float32, valid)``, rows sorted by ``(lo, hi)``, invalid rows
    ``(0, 0, 0)``."""
    v = num_nodes
    m = recv.shape[0]
    rvalid = recv[:, 0] >= 0
    key = torch.where(rvalid, recv[:, 0].to(torch.int64) * (v + 1) + recv[:, 1].to(torch.int64),
                      v * (v + 1) + v)
    rcnt = torch.where(rvalid, recv[:, 2].to(torch.int64), 0)
    key_s, order = torch.sort(key)
    pid = segment_ids_from_boundaries(boundaries_from_keys(key_s))
    gcnt = torch.zeros(m, dtype=torch.int64, device=recv.device).index_add_(0, pid, rcnt[order])
    glo = torch.zeros(m, dtype=torch.int64, device=recv.device).scatter_(0, pid, key_s // (v + 1))
    ghi = torch.zeros(m, dtype=torch.int64, device=recv.device).scatter_(0, pid, key_s % (v + 1))
    gvalid = (torch.arange(m, device=recv.device) <= pid[-1]) & (glo < v) & (gcnt > 0)
    zero = torch.zeros((), dtype=torch.int64, device=recv.device)
    return (torch.where(gvalid, glo, zero), torch.where(gvalid, ghi, zero),
            torch.where(gvalid, gcnt, zero).to(F32), gvalid)


def _exchange(plo, phi, cnt, valid, own_lo, own_hi, group: RankGroup, cap: int,
              num_nodes: int):
    """Route partial pair records to their owner(s) and add them up there.

    ``own_hi=None`` routes each pair to its lo owner only (sparsification:
    each pair counted once); otherwise to both endpoint owners (a merge
    round: owners need their whole adjacency).
    """
    p = group.size
    b1, of1 = _route(plo, phi, cnt, valid, own_lo, p, cap)
    if own_hi is None:
        buck, overflow = b1, of1
    else:
        b2, of2 = _route(plo, phi, cnt, valid & (own_hi != own_lo), own_hi, p, cap)
        buck = torch.cat([b1, b2], dim=1)  # [P, 2cap, 3]
        overflow = of1 + of2
    recv = group.all_to_all(buck)
    return (*_aggregate(recv.reshape(-1, 3), num_nodes), overflow)


def _f32(x: float, device) -> torch.Tensor:
    return costs.f32_scalar(x, device)


def _round_metrics(cfg, state, glo, ghi, gcnt, mine, cbar, log2v, v, group,
                   s_count, nmerges_g, overflow):
    """Exact global Eq. (4)/(2) metrics over the lo-owned pairs."""
    dev = gcnt.device
    zero = torch.zeros((), dtype=F32, device=dev)
    pi = costs.pair_pi(PairTable(lo=glo, hi=ghi, cnt=gcnt, valid=mine), state.size)
    touched = (state.size[glo] > 1) | (state.size[ghi] > 1)
    decided = costs.keep_superedge(gcnt, pi, cbar, log2v, cfg.re_guard)
    keep = torch.where(touched, decided, gcnt > 0.0) & mine
    cntk = torch.where(keep, gcnt, zero)
    sigma = torch.where(keep, gcnt / torch.clamp(pi, min=1.0), zero)
    re1_local = (torch.sum(2.0 * cntk * (1.0 - sigma))
                 + torch.sum(torch.where(mine & ~keep, gcnt, zero)))
    p_total = group.all_reduce(keep.sum(), "sum").to(F32)
    w_total = group.all_reduce(torch.max(cntk), "max")
    re1_total = _ordered_psum(re1_local, group)
    log2s = f32math.log2(torch.clamp(s_count, min=2.0))
    log2w = f32math.log2(torch.clamp(w_total, min=2.0))
    size_bits = p_total * (2.0 * log2s + log2w) + _f32(v, dev) * log2s
    return {
        "size_bits": size_bits,
        "re1": 2.0 * re1_total / _f32(float(v) * (v - 1.0), dev),
        "num_superedges": p_total,
        "num_supernodes": s_count,
        "nmerges": nmerges_g,
        "overflow": group.all_reduce(overflow, "sum"),
        "omega_max": w_total,
    }


class DistributedBackend:
    """Engine backend over edge shards split across a process group.

    Built by :func:`make_distributed_backend`; call :meth:`bind` with this
    rank's shard before handing it to
    :class:`~repro_torch.core.engine.SummaryEngine`. The per-rank programs
    stay callable on their own:

      * ``step(src_l, dst_l, state, θ, salt[, groups_all])`` — one merge round;
      * ``sparsify(src_l, dst_l, state, k_bits, salt)`` — Sect. 3.2.4;
      * ``grouping_fn(src_l, dst_l, state)`` — the compact grouping alone
        (``make_grouping_fn``);
      * ``compact_tables(src_l, dst_l, state)`` — a compact round up to the
        merge gain's operands.

    Every rank holds the whole ``SummaryState``; a restored checkpoint is
    loaded whole on every rank, whatever rank count wrote it.
    """

    stat_keys = DIST_STAT_KEYS

    def __init__(self, cfg: SummaryConfig, num_nodes: int, num_edges: int, *,
                 grouping: str, capacity_factor: float, lean_sort: bool,
                 external_groups: bool, device: torch.device,
                 perms: RoundPermutationSource, group: RankGroup | None = None):
        if grouping not in ("hash", "compact"):
            raise ValueError(f"unknown grouping {grouping!r}; valid: ['compact', 'hash']")
        if external_groups and grouping != "compact":
            raise ValueError("external_groups requires grouping='compact'")
        self.cfg = cfg
        self.num_nodes = num_nodes
        self.num_edges = num_edges
        self.grouping = grouping
        self.capacity_factor = capacity_factor
        self.lean_sort = lean_sort
        self.external_groups = external_groups
        self.device = device
        self.perms = perms
        self.group = RankGroup(device) if group is None else group
        p, c = self.group.size, cfg.group_size
        g_total = -(-num_nodes // c)
        self.g_pad = -(-g_total // p) * p  # groups, padded to a multiple of P
        self.n_rows = self.g_pad // p * c  # owned supernode slots (compact)
        # the reference feeds its kernels float32(np.log2(V)) (float64 log2)
        self.log2v = _f32(float(np.log2(max(num_nodes, 2))), device)
        self.last_cap = 0
        self._src = self._dst = None

    # ---- the shards --------------------------------------------------------
    def bind(self, src_l: torch.Tensor, dst_l: torch.Tensor) -> "DistributedBackend":
        """Attach this rank's padded edge shard (int64, ``-1`` padding)."""
        self._src, self._dst = src_l.to(self.device), dst_l.to(self.device)
        return self

    def _shards(self):
        if self._src is None:
            raise ValueError("DistributedBackend: call bind(src_l, dst_l) with this "
                             "rank's edge shard before running the engine")
        return self._src, self._dst

    def bucket_cap(self, e_loc: int) -> int:
        """Records a bucket holds: ``e_loc·factor/P``, at most ``e_loc`` (a
        destination never receives more records than the sender has pairs),
        plus 8."""
        return min(int(e_loc * self.capacity_factor / self.group.size), e_loc) + 8

    def _cbar(self, s_count, omega_all):
        if self.cfg.cbar_mode == "paper":
            return _f32(2.0 * float(np.log2(max(self.num_nodes, 2)))
                        + float(np.log2(max(self.num_edges, 2))), self.device)
        w = torch.clamp(omega_all, min=2.0)
        if s_count.device.type == "cpu":
            # the reference's compiled round fuses this sum into one
            # multiply-add, log(s)·(2/ln 2) + log₂(w)
            return f32math.fma(f32math.log(s_count), 2.0 * f32math.INV_LN2,
                               f32math.log2(w))
        return 2.0 * f32math.log2(s_count) + f32math.log2(w)

    def _s_count(self, state):
        return torch.clamp((state.size > 0).sum().to(F32), min=2.0)

    # ---- one merge round -----------------------------------------------------
    def grouping_fn(self, src_l, dst_l, state: SummaryState) -> torch.Tensor:
        """The compact grouping: ``[G_pad, C]`` candidate groups, the same on
        every rank (``make_grouping_fn``)."""
        v, c = self.num_nodes, self.cfg.group_size
        h, tie = self.perms.draw_at(v, self.device, state.t, 0)
        f_loc = shingles.local_supernode_shingles(src_l, dst_l, state.node2super, h)
        f = self.group.all_reduce(f_loc, "min")
        if self.lean_sort:
            groups_all = shingles.chunk_groups_lean(f, c)
        else:
            if tie is None:
                raise ValueError("the compact grouping without lean_sort needs a tie "
                                 "permutation; the source drew none")
            groups_all = shingles.chunk_groups(f, state.size, tie, c)
        pad_rows = self.g_pad - groups_all.shape[0]
        if pad_rows:
            groups_all = torch.cat([groups_all, groups_all.new_full((pad_rows, c), -1)])
        return groups_all

    def compact_tables(self, src_l, dst_l, state: SummaryState, groups_all=None,
                       mark=None) -> dict:
        """A compact round up to the merge gain's operands: the groups, the
        exchanged pair table, the owner and slot maps and the group tables.
        ``mark(stage)``, where given, is called as each stage is issued (a
        caller that synchronizes there times the stages)."""
        cfg, v, g = self.cfg, self.num_nodes, self.group
        p, rank, c, n_rows = g.size, g.rank, cfg.group_size, self.n_rows
        mark = mark or (lambda stage: None)
        cap = self.bucket_cap(src_l.shape[0])
        self.last_cap = cap
        if groups_all is None:
            groups_all = self.grouping_fn(src_l, dst_l, state)
            mark("grouping")
        my_groups = groups_all.reshape(self.g_pad // p, p, c)[:, rank]  # g ≡ rank (mod P)
        dev = groups_all.device
        flat = groups_all.reshape(-1)
        gidx = torch.arange(self.g_pad * c, device=dev) // c
        owner_of = torch.zeros(v + 1, dtype=torch.int64, device=dev).scatter_(
            0, torch.where(flat >= 0, flat, v), gidx % p)[:-1]
        my_flat = my_groups.reshape(-1)
        slot_of = torch.full((v + 1,), -1, dtype=torch.int64, device=dev).scatter_(
            0, torch.where(my_flat >= 0, my_flat, v), torch.arange(n_rows, device=dev))[:-1]

        mark("owner and slot maps")
        plo, phi, cnt, valid = _local_pairs(src_l, dst_l, state.node2super, v)
        mark("local pairs")
        glo, ghi, gcnt, gvalid, overflow = _exchange(
            plo, phi, cnt, valid, owner_of[plo], owner_of[phi], g, cap, v)
        s_count = self._s_count(state)
        omega_all = g.all_reduce(torch.max(torch.where(gvalid, gcnt, 0.0)), "max")
        cbar = self._cbar(s_count, omega_all)
        scal = torch.stack([cbar, self.log2v])
        mark("exchange (route, all_to_all, aggregate), cbar")
        nbr = tables.build_neighbor_tables_compact(glo, ghi, gcnt, gvalid, slot_of, n_rows,
                                                   v, cfg.max_neighbors)
        mark("neighbor tables")
        t_all = tables.supernode_total_costs_compact(
            glo, ghi, gcnt, gvalid, slot_of, n_rows, v, state.size, scal, self.num_edges,
            backend=cfg.kernel_backend)
        mark("total costs (pair_cost)")
        gt = tables.assemble_group_tables(*nbr, t_all, state.size, my_groups,
                                          cfg.union_size, v, row_of_member=slot_of,
                                          backend=cfg.kernel_backend)
        mark("group tables")
        return dict(gt=gt, scal=scal, s_count=s_count, glo=glo, ghi=ghi, gcnt=gcnt,
                    gvalid=gvalid, overflow=overflow, owner_of=owner_of, slot_of=slot_of,
                    cap=cap)

    def _step_compact(self, src_l, dst_l, state, theta, salt, groups_all=None):
        del salt  # ownership changes with each round's h
        g = self.group
        r = self.compact_tables(src_l, dst_l, state, groups_all)
        gt, scal = r["gt"], r["scal"]
        rel, _ = ops.merge_gain(gt.m, gt.n, gt.s, gt.t, gt.n_u, gt.cidx, gt.w, scal,
                                backend=self.cfg.kernel_backend)
        a, b, sel = select_matching(rel, gt.members, theta)
        new_state, nmerges = apply_merges(state, g.all_gather(a), g.all_gather(b),
                                          g.all_gather(sel))
        mine = r["gvalid"] & (r["owner_of"][r["glo"]] == g.rank)
        stats = _round_metrics(self.cfg, state, r["glo"], r["ghi"], r["gcnt"], mine,
                               scal[0], self.log2v, self.num_nodes, g, r["s_count"],
                               nmerges, r["overflow"])
        return new_state, stats

    def _step_hash(self, src_l, dst_l, state, theta, salt):
        cfg, v, g = self.cfg, self.num_nodes, self.group
        p, rank = g.size, g.rank
        cap = self.bucket_cap(src_l.shape[0])
        self.last_cap = cap
        plo, phi, cnt, valid = _local_pairs(src_l, dst_l, state.node2super, v)
        glo, ghi, gcnt, gvalid, overflow = _exchange(
            plo, phi, cnt, valid, owner_hash(plo, salt, p), owner_hash(phi, salt, p),
            g, cap, v)
        s_count = self._s_count(state)
        omega_all = g.all_reduce(torch.max(torch.where(gvalid, gcnt, 0.0)), "max")
        cbar = self._cbar(s_count, omega_all)

        dev = state.size.device
        owned = owner_hash(torch.arange(v, device=dev), salt, p) == rank
        h, tie = self.perms.draw_at(v, dev, state.t, rank)
        groups = shingles.build_groups_from_pairs(
            glo, ghi, gvalid, torch.where(owned, state.size, 0), h, tie, cfg.group_size)
        pt = PairTable(lo=glo, hi=ghi, cnt=gcnt, valid=gvalid)
        # the reference's totals take log2(float32(V)) on the device, its
        # merge gain float32(np.log2(V))
        gt = tables.build_group_tables(
            pt, state, groups, cfg.max_neighbors, cfg.union_size,
            torch.stack([cbar, costs.log2_f32(v, dev)]), v, backend=cfg.kernel_backend)
        scal = torch.stack([cbar, self.log2v])
        rel, _ = ops.merge_gain(gt.m, gt.n, gt.s, gt.t, gt.n_u, gt.cidx, gt.w, scal,
                                backend=cfg.kernel_backend)
        a, b, sel = select_matching(rel, gt.members, theta)
        # only merges of two supernodes owned here: trailing groups hold
        # supernodes of other ranks, with live sizes in the shared tables
        sel = sel & owned[torch.clamp(a, 0, v - 1)] & owned[torch.clamp(b, 0, v - 1)]
        new_state, nmerges = apply_merges(state, g.all_gather(a), g.all_gather(b),
                                          g.all_gather(sel))
        mine = gvalid & (owner_hash(glo, salt, p) == rank)
        stats = _round_metrics(cfg, state, glo, ghi, gcnt, mine, cbar, self.log2v, v, g,
                               s_count, nmerges, overflow)
        return new_state, stats

    def step(self, src_l, dst_l, state: SummaryState, theta, salt: int,
             groups_all: torch.Tensor | None = None):
        """One merge round on this rank's shard; ``theta`` a float or a float32
        tensor, ``salt`` the round's ownership salt. Returns the new state
        (the same on every rank) and the round's stats (0-d tensors, the same
        on every rank)."""
        if not isinstance(theta, torch.Tensor):
            theta = _f32(theta, self.device)
        if self.grouping == "hash":
            new_state, stats = self._step_hash(src_l, dst_l, state, theta, int(salt))
        else:
            if groups_all is not None and not self.external_groups:
                raise ValueError("groups_all needs a backend built with external_groups=True")
            new_state, stats = self._step_compact(src_l, dst_l, state, theta, int(salt),
                                                  groups_all)
        return SummaryState(node2super=new_state.node2super, size=new_state.size,
                            t=state.t + 1), stats

    # ---- Sect. 3.2.4 further sparsification ------------------------------------
    def sparsify(self, src_l, dst_l, state: SummaryState, k_bits, salt: int):
        """Drop superedges until Size(Ḡ) ≤ ``k_bits``. Returns ``(stats, pairs)``:
        the stats the same on every rank, ``pairs`` this rank's rows
        (``lo``, ``hi``, ``cnt``, ``keep``, ``drop``, ``mine``)."""
        cfg, v, g = self.cfg, self.num_nodes, self.group
        p, rank, dev = g.size, g.rank, self.device
        cap = self.bucket_cap(src_l.shape[0])
        zero = torch.zeros((), dtype=F32, device=dev)
        plo, phi, cnt, valid = _local_pairs(src_l, dst_l, state.node2super, v)
        glo, ghi, gcnt, gvalid, of = _exchange(plo, phi, cnt, valid,
                                               owner_hash(plo, salt, p), None, g, cap, v)
        mine = gvalid & (owner_hash(glo, salt, p) == rank)

        # the metrics before the drop (costs.summary_metrics' closed forms)
        s_count = self._s_count(state)
        pi = costs.pair_pi(PairTable(lo=glo, hi=ghi, cnt=gcnt, valid=mine), state.size)
        omega_all = g.all_reduce(torch.max(torch.where(mine, gcnt, zero)), "max")
        cbar = costs.cbar_value(cfg.cbar_mode, v, self.num_edges, s_count, omega_all)
        touched = (state.size[glo] > 1) | (state.size[ghi] > 1)
        decided = costs.keep_superedge(gcnt, pi, cbar, self.log2v, cfg.re_guard)
        keep = torch.where(touched, decided, gcnt > 0.0) & mine
        cntk = torch.where(keep, gcnt, zero)
        p_int = g.all_reduce(keep.sum(), "sum")
        p_total = p_int.to(F32)
        w_total = g.all_reduce(torch.max(cntk), "max")
        log2s = f32math.log2(torch.clamp(s_count, min=2.0))
        vf = _f32(v, dev)
        size_before = p_total * (2.0 * log2s + f32math.log2(torch.clamp(w_total, min=2.0))) \
            + vf * log2s

        # ξ and the order statistic across ranks
        delta = sparsify.sparsify_deltas(gcnt, pi, cfg.error_p)
        k_f32 = k_bits if isinstance(k_bits, torch.Tensor) else _f32(k_bits, dev)
        xi = sparsify.sparsify_xi(size_before, k_f32, s_count, w_total)
        delta_xi = sparsify.select_delta_xi(delta, keep, xi,
                                            reduce_hist=lambda h: g.all_reduce(h, "sum"))
        drop = sparsify.drop_from_threshold(keep, delta, delta_xi, xi, p_int)

        # the metrics after the drop
        keep2 = keep & ~drop
        cntk2 = torch.where(keep2, gcnt, zero)
        sigma2 = torch.where(keep2, gcnt / torch.clamp(pi, min=1.0), zero)
        p2 = g.all_reduce(keep2.sum(), "sum").to(F32)
        w2 = g.all_reduce(torch.max(cntk2), "max")
        size_after = p2 * (2.0 * log2s + f32math.log2(torch.clamp(w2, min=2.0))) + vf * log2s
        dropped_cnt = torch.where(mine & ~keep2, gcnt, zero)
        re1_sum = _ordered_psum(torch.sum(2.0 * cntk2 * (1.0 - sigma2))
                                + torch.sum(dropped_cnt), g)
        re2_sq = _ordered_psum(torch.sum(cntk2 * (1.0 - sigma2)) + torch.sum(dropped_cnt),
                               g)
        denom = _f32(float(v) * (v - 1.0), dev)
        stats = {
            "size_bits": size_after,
            "size_bits_before": size_before,
            "re1": 2.0 * re1_sum / denom,
            "re2": torch.sqrt(2.0 * re2_sq) / denom,
            "num_superedges": p2,
            "num_supernodes": s_count,
            "omega_max": w2,
            "xi": xi.to(F32),
            "dropped": g.all_reduce(drop.sum(), "sum").to(F32),
            "overflow": g.all_reduce(of, "sum").to(F32),
        }
        pairs = {"lo": glo, "hi": ghi, "cnt": gcnt, "keep": keep2, "drop": drop,
                 "mine": mine}
        return stats, pairs

    # ---- the engine's Backend methods ------------------------------------------
    def input_size_bits(self) -> float:
        """Size(G) = 2|E|log₂|V|, with the reference's float64 log₂."""
        return 2.0 * self.num_edges * float(np.log2(max(self.num_nodes, 2)))

    def init(self) -> SummaryState:
        return init_state(self.num_nodes, self.device)

    def run_chunk(self, state: SummaryState, thetas: list[float], t0: int,
                  k_bits: float, limit: int) -> tuple[SummaryState, list[dict]]:
        """Up to ``limit`` rounds (``thetas[i]`` is round ``t0 + i``'s θ, its
        salt ``t0 + i``), one read-back a round; each row also holds
        ``round_s``, the round's wall time on this rank."""
        src_l, dst_l = self._shards()
        k_f32 = np.float32(k_bits)
        rows = []
        for i in range(limit):
            t_round = time.perf_counter()
            state, stats = self.step(src_l, dst_l, state, thetas[i], t0 + i)
            vals = torch.stack([stats[k].to(F32) for k in DIST_STAT_KEYS]).cpu().numpy()
            row = {k: float(x) for k, x in zip(DIST_STAT_KEYS, vals)}
            row["round_s"] = time.perf_counter() - t_round
            rows.append(row)
            # the reference's device-side test: float32 size_bits vs float32 k
            if vals[0] <= k_f32 or (row["nmerges"] == 0 and thetas[i] == 0.0):
                break
        return state, rows

    def num_supernodes(self, state: SummaryState) -> int:
        return int((state.size > 0).sum())

    def sparsify_finalize(self, state: SummaryState, k_bits: float, salt: int) -> dict:
        src_l, dst_l = self._shards()
        stats, pairs = self.sparsify(src_l, dst_l, state, k_bits, salt)
        return {"stats": stats, "pairs": pairs}


def make_distributed_backend(cfg: SummaryConfig, num_nodes: int, num_edges_global: int,
                             *, grouping: str = "compact", capacity_factor: float = 4.0,
                             lean_sort: bool = False, external_groups: bool = False,
                             device: str | torch.device = "cuda",
                             perms: RoundPermutationSource | None = None,
                             group: RankGroup | None = None) -> DistributedBackend:
    """The edge-sharded backend over ``torch.distributed``'s default group.

    ``grouping`` picks the candidate-set ownership (``"hash"``: [V, D]
    tables; ``"compact"``: group owners with compact tables);
    ``capacity_factor`` sizes the exchange buckets; ``lean_sort`` takes the
    2-key grouping sort; ``external_groups`` lets ``step`` take precomputed
    ``groups_all`` (from :func:`make_grouping_fn`). ``perms`` defaults to
    :class:`~repro_torch.core.shingles.SeededPermutations` of ``cfg.seed``;
    ``group`` to the default group (``RankGroup(device)``; the dry-run passes
    a counting one, ``launch/dry_ranks.py``).
    """
    dev = resolve_device(device)
    return DistributedBackend(
        cfg, num_nodes, num_edges_global, grouping=grouping,
        capacity_factor=capacity_factor, lean_sort=lean_sort,
        external_groups=external_groups, device=dev,
        perms=perms if perms is not None else SeededPermutations(cfg.seed, dev), group=group)


def make_distributed_step(cfg: SummaryConfig, num_nodes: int, num_edges_global: int,
                          capacity_factor: float = 4.0, **kw):
    """Compat shim: the hash-owner round (``backend.step``)."""
    return make_distributed_backend(cfg, num_nodes, num_edges_global, grouping="hash",
                                    capacity_factor=capacity_factor, **kw).step


def make_distributed_step_compact(cfg: SummaryConfig, num_nodes: int,
                                  num_edges_global: int, capacity_factor: float = 4.0,
                                  lean_sort: bool = False, external_groups: bool = False,
                                  **kw):
    """Compat shim: the group-owner round (``backend.step``)."""
    return make_distributed_backend(cfg, num_nodes, num_edges_global, grouping="compact",
                                    capacity_factor=capacity_factor, lean_sort=lean_sort,
                                    external_groups=external_groups, **kw).step


def make_distributed_sparsify(cfg: SummaryConfig, num_nodes: int, num_edges_global: int,
                              capacity_factor: float = 4.0, **kw):
    """Compat shim: the edge-sharded Sect. 3.2.4 phase (``backend.sparsify``):
    ``(src_l, dst_l, state, k_bits, salt) → (stats, pairs)``."""
    return make_distributed_backend(cfg, num_nodes, num_edges_global, grouping="hash",
                                    capacity_factor=capacity_factor, **kw).sparsify


def make_grouping_fn(cfg: SummaryConfig, num_nodes: int, lean_sort: bool = True, **kw):
    """The compact grouping alone, ``(src_l, dst_l, state) → groups_all``
    ``[G_pad, C]`` (G padded to a multiple of the rank count), to run every
    few rounds and feed a backend built with ``external_groups=True``."""
    return make_distributed_backend(cfg, num_nodes, 0, grouping="compact",
                                    lean_sort=lean_sort, **kw).grouping_fn


def bucket_bytes(cap: int, n_ranks: int) -> int:
    """Bytes of one rank's send buckets in a merge round: two ``[P, cap, 3]``
    int32 buckets, one for each endpoint owner."""
    return 2 * n_ranks * cap * 3 * 4
