"""Batched summary-query engines: one device, and P ranks over torch.distributed.

Port of ``repro/core/queries_jax.py``. The
:class:`~repro_torch.core.queries.BlockSummary` CSR lives on the device in
float64, and a batch of ``[B]`` requests of mixed kinds is answered at once:

  * ``expected_degree``  — one gather: ``deg[node2block[u]]``;
  * ``adjacency_weight`` — a binary search of σ on the sorted ``row·S + col``
    key;
  * ``pagerank``         — the block-space power iteration (computed once,
    then served as a gather), step for step the reference's loop with its
    early break; the engine keeps the number of steps it took;
  * ``triangle_density`` — per-row wedge sums, enumerated from the CSR by
    whole rows in chunks of a bounded wedge count (computed once, then
    served as a scalar);
  * ``cut_weight`` / ``conductance`` — node sets packed to per-block count
    rows on the device, reduced to per-row cut contributions;
  * ``k_hop_size`` — the BFS fixpoint on the superedge support, in block
    space.

The reference pads the CSR to a dense ``[S, D]`` layout (D the widest row)
to give the TPU static shapes. The port keeps the entry list: at the
skitter stand-in's full size the rows hold less than one entry on average
while R-MAT hubs make D large, so the padded layout would cost
``S · D · 20`` bytes and its ``[rows, D, D]`` triangle blocks more. Every
answer is computed per slot from that slot's inputs alone, with gathers and
the fixed-order sums of :mod:`repro_torch.core.queries`, so it does not
depend on how requests pack into a batch, on the run or on the device.

Three engines give the same answers, bit for bit:

  * :class:`QueryEngine` — one device holds the whole CSR.
  * :class:`RoutedQueryEngine` — the owner-routed tier: P ranks each hold
    the whole summary and compute row values only for the blocks they own,
    ``owner_hash(id, salt, P)`` (:mod:`repro_torch.dist.sharding`, the
    edge-sharded backend's hash).
  * :class:`PartitionedQueryEngine` — the row-partitioned tier: rank q holds
    the CSR entries of its owned rows, resident copies of the rows they
    reference on other ranks (the halo; rows denser than ``dense_row_nnz``
    excepted) and its part of the dense slab, per
    :class:`PartitionTables`, with the O(S) and O(V) arrays whole.

Why the bits agree. An answer that sums over rows is built from per-row
values, each a fixed-order sum over that row's own entries, merged into the
canonical ``[S]`` / ``[k, S]`` vector exactly, then one fixed-order sum that
every rank computes the same way. The merge is an ``all_gather`` of each
rank's owned slab and an index write: an ``all_reduce`` sum of disjoint
values would already turn a ``-0.0`` into ``0.0``. Point kinds are answered
by the owner of ``block(u)``, the global kinds (triangle, cut, conductance)
by rank 0, and the answers are merged the same way.

Ranks (:class:`RankSet`). Over a process group (NCCL on the card, gloo on
the CPU) each process runs its own rank, every rank serves the same batches
in the same order, and the collectives sit inside ``answer_batch``,
``pagerank_blocks``, ``triangle_density`` and ``partition_stats``. With
``ranks=P`` one process runs the P ranks' row work one after another and
merges by stacking: the same values, in the same order. A new rank count is
a new engine (the owner hash depends only on P and the salt).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import queries as Q
from repro_torch.core.distributed import RankGroup
from repro_torch.core.queries import F64, BlockSummary, RowSlab, build_block_summary
from repro_torch.core.types import SummaryResult, resolve_device
from repro_torch.dist import owner_hash

# Query kinds of the serving wire format (int32 per slot).
KIND_DEGREE = 0
KIND_ADJACENCY = 1
KIND_PAGERANK = 2
KIND_TRIANGLE = 3
KIND_KHOP = 4  # u = target node, v = hop count k
KIND_CUT = 5  # node sets A/B arrive as per-block count rows
KIND_CONDUCTANCE = 6  # node set A as count row; complement derived
KIND_NAMES = {
    "degree": KIND_DEGREE,
    "adjacency": KIND_ADJACENCY,
    "pagerank": KIND_PAGERANK,
    "triangle": KIND_TRIANGLE,
    "khop": KIND_KHOP,
    "cut": KIND_CUT,
    "conductance": KIND_CONDUCTANCE,
}
# kinds whose requests carry node sets (packed to count rows)
SET_KINDS = (KIND_CUT, KIND_CONDUCTANCE)
# kinds whose u lane is a node id
_NODE_KINDS = (KIND_DEGREE, KIND_ADJACENCY, KIND_PAGERANK, KIND_KHOP)
# kinds with no per-node target: answered by rank 0
_GLOBAL_KINDS = (KIND_TRIANGLE, KIND_CUT, KIND_CONDUCTANCE)


def adjacency_kernel(bs: BlockSummary, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    a = bs.node2block[u].to(torch.int64)
    b = bs.node2block[v].to(torch.int64)
    return torch.where(u == v, 0.0, Q.pair_sigma(bs, a, b))


def pack_set_counts(bs: BlockSummary, kinds, sets_a, sets_b):
    """Node-set requests packed to per-block count rows, on ``bs``'s device.

    ``sets_a``/``sets_b`` are length-B sequences (entries of other kinds are
    ignored; may be None). Returns float64 ``(cnt_a, cnt_b, ov)`` of shape
    [B, S]: A-counts, B-counts (cut only) and |A∩B|-counts (cut only) per
    block — the reference's ``block_counts`` semantics (a repeated node
    counts once). Each set is marked in a ``[slots, V]`` bitmap on the
    device and its marks are counted per block, exact in any order.
    """
    kinds = np.asarray(kinds, np.int32)
    b, s = kinds.shape[0], bs.num_blocks
    cnt_a, cnt_b, ov = (torch.zeros((b, s), dtype=F64, device=bs.device) for _ in range(3))
    slots = np.nonzero(np.isin(kinds, SET_KINDS))[0]
    if slots.size == 0:
        return cnt_a, cnt_b, ov
    cut = kinds[slots] == KIND_CUT
    mark_a = Q.set_marks(bs, [None if sets_a is None else sets_a[i] for i in slots])
    mark_b = Q.set_marks(bs, [None if sets_b is None else sets_b[i] for i in slots[cut]])
    cut_rows = torch.as_tensor(np.nonzero(cut)[0], device=bs.device)
    counts = Q.mark_counts(bs, torch.cat([mark_a, mark_b, mark_a[cut_rows] & mark_b]))
    n, n_cut = slots.size, int(cut.sum())
    cnt_a[torch.as_tensor(slots, device=bs.device)] = counts[:n]
    cut_slots = torch.as_tensor(slots[cut], device=bs.device)
    cnt_b[cut_slots] = counts[n:n + n_cut]
    ov[cut_slots] = counts[n + n_cut:]
    return cnt_a, cnt_b, ov


class QueryEngine:
    """Single-device batched query engine over one summary.

    PageRank and triangle density are computed on first use and then served
    as a gather / a scalar; ``pagerank_iterations`` and ``triangle_wedges``
    say what that took. Batched methods return host numpy float64 arrays.
    The per-row steps ``_row_sums``, ``_triangle_rows``, ``_cut_rows`` and
    ``_khop_rows`` (each over every row of the summary here), and
    ``_answers_of``/``_finish``, are where the tiers differ; the loops and
    the fixed-order sums around them are this class's, for every tier.
    """

    def __init__(self, summary: SummaryResult | BlockSummary, *,
                 device: str | torch.device = "cuda", damping: float = 0.85,
                 pagerank_iters: int = 50, pagerank_tol: float = 1e-10,
                 triangle_wedge_chunk: int = Q.WEDGE_CHUNK, khop_max: int = 16):
        if isinstance(summary, (BlockSummary, BlockMeta)):
            self.bs = summary
        else:
            self.bs = build_block_summary(summary, resolve_device(device))
        self.device = self.bs.device
        self.damping = damping
        self.pagerank_iters = pagerank_iters
        self.pagerank_tol = pagerank_tol
        self.triangle_wedge_chunk = triangle_wedge_chunk
        self.khop_max = khop_max
        self.pagerank_iterations: int | None = None
        self.triangle_wedges: int | None = None
        self._pr_blocks = None
        self._tri = None

    @functools.cached_property
    def slab(self) -> RowSlab:
        """Every row of the summary, as the per-row functions take them."""
        return Q.whole_slab(self.bs)

    # ------------------------------------------------- per-row work
    def _row_sums(self, share: torch.Tensor) -> torch.Tensor:
        return Q.pagerank_rows(self.slab, share[self.slab.cols.to(torch.int64)])

    def _pagerank(self) -> tuple[torch.Tensor, int]:
        """:func:`~repro_torch.core.queries.pagerank_power`'s loop, a step's
        row sums from :meth:`_row_sums`."""
        bs = self.bs
        s, v_total = bs.num_blocks, float(bs.num_nodes)
        p = torch.full((s,), 1.0 / v_total, dtype=F64, device=self.device)
        steps = 0
        for _ in range(self.pagerank_iters):
            new = Q.damped(self._row_sums(Q.pagerank_share(p, bs.deg)),
                           Q.dangling_mass(bs.sizes, bs.deg, p), self.damping, v_total)
            steps += 1
            done = s == 0 or float(torch.max(torch.abs(new - p))) < self.pagerank_tol
            p = new
            if done:
                break
        return p, steps

    def _triangle_rows(self) -> tuple[torch.Tensor, int]:
        bs = self.bs
        return Q.triangle_rows(self.slab, *Q.csr_wedge_bounds(bs), bs.cols, bs.sigma, bs.sizes,
                               self.triangle_wedge_chunk)

    def _cut_rows(self, c_a, c_b, ov) -> torch.Tensor:
        return Q.cut_rows(self.slab, c_a, c_b, ov)

    def _khop_rows(self, reach) -> torch.Tensor:
        return Q.khop_rows(self.slab, reach)

    def _answers_of(self, rank: int, kt, ut, vt, out) -> torch.Tensor:
        """``out`` with the adjacency slots filled in as ``rank`` sees them."""
        if vt is None:
            return out
        return torch.where(kt == KIND_ADJACENCY, adjacency_kernel(self.bs, ut, vt), out)

    def _finish(self, kt, ut, vt, a0, out) -> torch.Tensor:
        return self._answers_of(0, kt, ut, vt, out)

    def _k_hop(self, a0: torch.Tensor, hops: np.ndarray) -> torch.Tensor:
        """:func:`~repro_torch.core.queries.k_hop_sizes`' BFS, a step's rows
        from :meth:`_khop_rows`."""
        onehot = a0[:, None] == torch.arange(self.bs.num_blocks, device=self.device)[None, :]
        reach = torch.zeros_like(onehot)
        hops_t = torch.as_tensor(hops, device=self.device)
        for t in range(int(np.max(hops, initial=0))):
            grown = self._khop_rows(onehot if t == 0 else reach) | reach
            grown = torch.where((t < hops_t)[:, None], grown, reach)
            if torch.equal(grown, reach):  # a fixpoint: no later step grows it
                break
            reach = grown
        return Q.khop_counts(self.bs, onehot, reach)

    def _set_answers(self, kinds: np.ndarray, cnt_a, cnt_b, ov) -> torch.Tensor:
        """cut or conductance (float64[k]) of k set-kind slots from their
        count rows ([k, S]), the cut rows from :meth:`_cut_rows` added by one
        fixed-order sum; conductance's complement counts come from ``cnt_a``."""
        out = torch.zeros(kinds.shape[0], dtype=F64, device=self.device)
        for kind in SET_KINDS:
            rows = np.nonzero(kinds == kind)[0]
            if rows.size == 0:
                continue
            idx = torch.as_tensor(rows, device=self.device)
            c_a = cnt_a[idx]
            if kind == KIND_CUT:
                out[idx] = Q.ordered_sum(self._cut_rows(c_a, cnt_b[idx], ov[idx]))
            else:
                cut = Q.ordered_sum(self._cut_rows(c_a, self.bs.sizes - c_a,
                                                   torch.zeros_like(c_a)))
                out[idx] = Q.conductance_of_cut(self.bs, c_a, cut)
        return out

    # ------------------------------------------------ lazy global queries
    def pagerank_blocks(self) -> torch.Tensor:
        if self._pr_blocks is None:
            self._pr_blocks, self.pagerank_iterations = self._pagerank()
        return self._pr_blocks

    def triangle_density(self) -> float:
        if self._tri is None:
            tri, self.triangle_wedges = self._triangle_rows()
            self._tri = float(Q.ordered_sum(tri[None])[0])
        return self._tri

    def _nodes(self, u) -> torch.Tensor:
        u = np.asarray(u, np.int64)
        if u.size and (u.min() < 0 or u.max() >= self.bs.num_nodes):
            raise IndexError(f"node ids must be in [0, {self.bs.num_nodes}); got "
                             f"[{u.min()}, {u.max()}]")
        return torch.as_tensor(u, device=self.device)

    def pagerank_nodes(self, u) -> np.ndarray:
        pr = self.pagerank_blocks()
        return pr[self.bs.node2block[self._nodes(u)]].cpu().numpy()

    # --------------------------------------------------- batched queries
    def _one_kind(self, kind: int, u, v) -> np.ndarray:
        u = np.asarray(u, np.int64)
        v = np.broadcast_to(np.asarray(v, np.int64), u.shape)
        kinds = np.full(u.size, kind, np.int32)
        return self.answer_batch(kinds, u.ravel(), v.ravel()).reshape(u.shape)

    def expected_degree(self, u) -> np.ndarray:
        return self._one_kind(KIND_DEGREE, u, 0)

    def adjacency_weight(self, u, v) -> np.ndarray:
        return self._one_kind(KIND_ADJACENCY, u, v)

    def answer_batch(self, kinds, u, v, cnt_a=None, cnt_b=None, ov=None) -> np.ndarray:
        """Mixed-kind batch: ``kinds``/``u``/``v`` are int[B]; returns
        float64[B]. PageRank and the triangle total are computed only if the
        batch asks for them. Set kinds read the [B, S] count rows of
        :func:`pack_set_counts` (zeros when absent); khop carries k in v."""
        kinds = np.asarray(kinds, np.int32)
        u = np.asarray(u, np.int64)
        v = np.asarray(v, np.int64)
        bs = self.bs
        ut = self._nodes(np.where(np.isin(kinds, _NODE_KINDS), u, 0))
        kt = torch.as_tensor(kinds, device=self.device)
        a0 = bs.node2block[ut].to(torch.int64)
        out = torch.where(kt == KIND_DEGREE, bs.deg[a0], 0.0)
        if (kinds == KIND_PAGERANK).any():
            out = torch.where(kt == KIND_PAGERANK, self.pagerank_blocks()[a0], out)
        if (kinds == KIND_TRIANGLE).any():
            out = torch.where(kt == KIND_TRIANGLE, self.triangle_density(), out)
        khop = np.nonzero(kinds == KIND_KHOP)[0]
        if khop.size:
            hops = np.minimum(v[khop], self.khop_max)
            if hops.min() < 0:
                raise ValueError(f"khop: hop counts must be >= 0; got {hops.min()}")
            idx = torch.as_tensor(khop, device=self.device)
            out[idx] = self._k_hop(a0[idx], hops)
        sets = np.nonzero(np.isin(kinds, SET_KINDS))[0]
        if sets.size:
            idx = torch.as_tensor(sets, device=self.device)
            shape = (kinds.shape[0], bs.num_blocks)
            ca, cb, oo = (torch.zeros(shape, dtype=F64, device=self.device) if x is None
                          else torch.as_tensor(x, dtype=F64, device=self.device)
                          for x in (cnt_a, cnt_b, ov))
            out[idx] = self._set_answers(kinds[sets], ca[idx], cb[idx], oo[idx])
        adj = kinds == KIND_ADJACENCY
        vt = self._nodes(np.where(adj, v, 0)) if adj.any() else None
        return self._finish(kt, ut, vt, a0, out).cpu().numpy()

    # ------------------------------------------------- analytics queries
    def cut_weight(self, sets_a, sets_b) -> np.ndarray:
        """Batched Ĝ cut weight between node-set pairs (length-B lists)."""
        b = len(sets_a)
        kinds = np.full(b, KIND_CUT, np.int32)
        ca, cb, ov = pack_set_counts(self.bs, kinds, sets_a, sets_b)
        z = np.zeros(b, np.int64)
        return self.answer_batch(kinds, z, z, ca, cb, ov)

    def conductance(self, sets_a) -> np.ndarray:
        """Batched Ĝ conductance of node sets (length-B list)."""
        b = len(sets_a)
        kinds = np.full(b, KIND_CONDUCTANCE, np.int32)
        ca, cb, ov = pack_set_counts(self.bs, kinds, sets_a, None)
        z = np.zeros(b, np.int64)
        return self.answer_batch(kinds, z, z, ca, cb, ov)

    def k_hop_size(self, u, k) -> np.ndarray:
        """Batched k-hop neighborhood size (u, k broadcast; k capped at
        ``khop_max``)."""
        u = np.asarray(u, np.int64).ravel()
        k = np.broadcast_to(np.asarray(k, np.int64), u.shape)
        kinds = np.full(u.shape, KIND_KHOP, np.int32)
        return self.answer_batch(kinds, u, k)


# ----------------------------------------------------------------- ranks

class RankSet:
    """The P ranks a tier spreads its rows over, the ones this process runs
    (``hosted``), and the exact merge of per-rank parts.

    ``ranks=None``: the ranks of ``group`` (default: ``torch.distributed``'s
    default group, or a world of one when none is initialized), this
    process running its own; a merge is an ``all_gather``. ``ranks=P``: this
    process runs all P, one after another; a merge stacks their parts.
    """

    def __init__(self, device: torch.device, group=None, ranks: int | None = None):
        self.device = device
        if ranks is None:
            self.group = RankGroup(device, group)
            self.size, self.hosted = self.group.size, [self.group.rank]
        else:
            if group is not None or ranks < 1:
                raise ValueError(f"ranks={ranks} runs every rank in this process; it takes "
                                 "no process group and needs at least one rank")
            self.group, self.size, self.hosted = None, int(ranks), list(range(ranks))

    def gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The hosted ranks' parts (one shape on every rank) from every rank,
        stacked in rank order: [P, ...]."""
        if len(parts) == self.size:
            return torch.stack(parts)
        return self.group.all_gather(parts[0][None])

    def total(self, values) -> int:
        """The sum over every rank of the ints its hosted ranks pass, one each."""
        x = [torch.tensor(int(v), dtype=torch.int64, device=self.device) for v in values]
        return int(self.gather(x).sum())

    def check_same(self, what: str, values) -> None:
        """Raise unless every rank holds the same ints: the replicated inputs
        that keep the ranks in lockstep."""
        x = torch.as_tensor(values, dtype=torch.int64, device=self.device)
        g = self.gather([x] * len(self.hosted))
        if not bool((g == g[0]).all()):
            raise RuntimeError(f"the ranks hold different {what}: {g.tolist()}")


def _pad(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` padded with zeros to ``width`` along its last dimension."""
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (width - x.shape[-1],))], -1)


class RoutedQueryEngine(QueryEngine):
    """Owner-routed engine: the whole summary on every rank, the row work
    split by owner.

    Block ``a`` belongs to rank ``owner_hash(ids[a], salt, P)``. Each rank
    computes PageRank row sums (over a sub-CSR of its rows, through
    ``segment_sum``), triangle rows, cut rows and k-hop step rows only for
    the blocks it owns; the rows are merged exactly into the canonical
    vector, and what follows is the single-device engine's arithmetic on
    every rank alike. Port of the reference's ``RoutedQueryEngine``; a mesh
    change there is a new engine here, on the new group or rank count.
    """

    def __init__(self, summary: SummaryResult | BlockSummary, *,
                 device: str | torch.device = "cuda", group=None, ranks: int | None = None,
                 salt: int = 0, **params):
        """``params``: :class:`QueryEngine`'s (damping, iteration and chunk
        limits). What the tiers differ in is how the summary is built
        (:meth:`_block_summary`), what every rank holds whole (:meth:`_held`)
        and the rows of the ranks this process runs (:meth:`_hosted_rows`)."""
        if isinstance(summary, BlockSummary):
            full, dev = summary, summary.device
        else:
            dev = resolve_device(device)
            full = self._block_summary(summary, dev)
        super().__init__(self._held(full, dev), **params)
        self.ranks = RankSet(self.device, group, ranks)
        self._route(owner_hash(full.ids, salt, self.ranks.size))
        self.slabs = self._hosted_rows(full)

    def _block_summary(self, summary: SummaryResult, device: torch.device) -> BlockSummary:
        return build_block_summary(summary, device)

    def _held(self, full: BlockSummary, device: torch.device) -> BlockSummary:
        return full

    def _hosted_rows(self, full: BlockSummary) -> dict[int, RowSlab]:
        return {r: Q.slab_of(full, self.own[r]) for r in self.ranks.hosted}

    def _route(self, owner: torch.Tensor) -> None:
        """The routing table (block → rank) and each rank's owned blocks, and
        where a merge writes each rank's slab."""
        bs, p = self.bs, self.ranks.size
        self.ranks.check_same("summaries (|V|, S, nnz)", [bs.num_nodes, bs.num_blocks, bs.nnz])
        self.owner = owner.to(torch.int64).to(self.device)
        self.own = [torch.nonzero(self.owner == q).squeeze(1) for q in range(p)]
        self.slab_width = max([1] + [x.numel() for x in self.own])
        gids = torch.full((p, self.slab_width), -1, dtype=torch.int64, device=self.device)
        for q, x in enumerate(self.own):
            gids[q, :x.numel()] = x
        gids = gids.reshape(-1)
        self._src = torch.nonzero(gids >= 0).squeeze(1)
        self._dst = gids[self._src]

    def owner_counts(self) -> np.ndarray:
        """Blocks per owning rank — the routing table's histogram."""
        return np.bincount(self.owner.cpu().numpy(), minlength=self.ranks.size)

    def _scatter(self, g: torch.Tensor) -> torch.Tensor:
        """Every rank's slab ``[P, ..., width]`` → the canonical ``[..., S]``."""
        g = g.movedim(0, -2).reshape(g.shape[1:-1] + (-1,))
        out = g.new_zeros(g.shape[:-1] + (self.bs.num_blocks,))
        out[..., self._dst] = g[..., self._src]
        return out

    def _merge(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The hosted ranks' owned-row values ``[..., rows_r]`` from every
        rank, written into the canonical ``[..., S]`` (exact: each block's
        value comes from its owner alone)."""
        return self._scatter(self.ranks.gather([_pad(x, self.slab_width) for x in parts]))

    def _row_sums(self, share):
        return self._merge([Q.pagerank_rows(sl, share[sl.cols.to(torch.int64)])
                            for sl in self.slabs.values()])

    def _triangle_rows(self):
        bs = self.bs
        parts, wedges = [], []
        for sl in self.slabs.values():
            tri, w = Q.triangle_rows(sl, *Q.csr_wedge_bounds(bs, sl.cols), bs.cols, bs.sigma,
                                     bs.sizes, self.triangle_wedge_chunk)
            parts.append(tri)
            wedges.append(w)
        return self._merge(parts), self.ranks.total(wedges)

    def _cut_rows(self, c_a, c_b, ov):
        return self._merge([Q.cut_rows(sl, c_a, c_b, ov) for sl in self.slabs.values()])

    def _khop_rows(self, reach):
        return self._merge([Q.khop_rows(sl, reach) for sl in self.slabs.values()])

    def _finish(self, kt, ut, vt, a0, out):
        glob = torch.zeros_like(kt, dtype=torch.bool)
        for k in _GLOBAL_KINDS:
            glob |= kt == k
        route = torch.where(glob, 0, self.owner[a0])
        parts = [torch.where(route == r, self._answers_of(r, kt, ut, vt, out), 0.0)
                 for r in self.ranks.hosted]
        return self.ranks.gather(parts)[route, torch.arange(kt.shape[0], device=self.device)]


# ------------------------------------------------------- partitioned tier

@dataclasses.dataclass(frozen=True)
class PartitionTables:
    """Host-built partition and halo index tables for one (summary, P).

    A deterministic function of ``(BlockSummary, owner, P, dense_row_nnz)``,
    the reference's fields with its values and int32 dtypes, per-rank lists
    padded to the largest with -1:

    * ``own_gids[q]`` — the blocks rank q owns (ascending); ``block_pos[a]``
      is a's position in its owner's list;
    * ``halo_*[q]`` — every remote block q's rows reference, with its owner
      and position there: the PageRank share exchange reads these;
    * ``row_halo_gids[q]`` — the non-dense halo blocks whose rows q keeps
      (the wedge closure needs whole rows);
    * ``dense_gids`` — rows with more than ``dense_row_nnz`` entries, kept in
      no halo: their owners' ``dense_slots`` rows are gathered when the
      triangles are computed (the second hop);
    * ``loc_share[q]`` / ``loc_row[q]`` — for each CSR entry of q's rows, in
      row and storage order, the index of its column in ``[own | halo |
      sentinel]`` and in ``[own | resident halo | dense slab | sentinel]``.
      The reference keeps them as padded ``[P, S_own, D]`` rows, its padding
      slots holding the sentinels; the port keeps the entry list, as its
      CSR does.
    """

    n_devices: int
    s: int
    d: int
    dense_row_nnz: int | None
    owner: np.ndarray  # int32[S] block -> rank
    block_pos: np.ndarray  # int32[S] position in the owner's list
    own_gids: np.ndarray  # int32[P, S_own]
    halo_gids: np.ndarray  # int32[P, H]
    halo_src_dev: np.ndarray  # int32[P, H]
    halo_src_pos: np.ndarray  # int32[P, H]
    row_halo_gids: np.ndarray  # int32[P, Ht]
    dense_gids: np.ndarray  # int32[n_dense] (sorted)
    dense_slots: np.ndarray  # int32[P, Dm] dense rows per owner
    loc_share: list[np.ndarray]  # per rank int32[entries of its rows]
    loc_row: list[np.ndarray]  # per rank int32[entries of its rows]


def _entries_np(indptr: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """The CSR entries of ``rows``, in row order and storage order."""
    return Q.row_entries(torch.as_tensor(indptr), torch.as_tensor(rows, dtype=torch.int64))[1].numpy()


def build_partition_tables(bs: BlockSummary, owner, n_devices: int,
                           dense_row_nnz: int | None = None) -> PartitionTables:
    """The per-rank row partition and halo index tables, on the host: the
    reference's ``build_partition_tables`` over the CSR entry list."""
    owner = np.asarray(owner.cpu() if torch.is_tensor(owner) else owner).astype(np.int32)
    p = int(n_devices)
    s = bs.num_blocks
    indptr = bs.indptr.cpu().numpy()
    cols = bs.cols.cpu().numpy().astype(np.int64)
    row_nnz = np.diff(indptr)
    d = max(1, int(row_nnz.max()) if s else 0)
    dense = np.zeros(s, bool)
    if dense_row_nnz is not None and s:
        dense = row_nnz > int(dense_row_nnz)
    dense_gids = np.flatnonzero(dense).astype(np.int32)

    own_lists = [np.flatnonzero(owner == q).astype(np.int32) for q in range(p)]
    s_own = max([1] + [x.size for x in own_lists])
    block_pos = np.zeros(s, np.int32)
    for x in own_lists:
        block_pos[x] = np.arange(x.size, dtype=np.int32)

    dense_lists = [x[dense[x]] for x in own_lists]
    dmax = max([1] + [x.size for x in dense_lists])
    dense_slots = np.full((p, dmax), -1, np.int32)
    dense_slab_pos = np.full(s, -1, np.int32)  # block -> slot in the [P·Dm] slab
    for q, x in enumerate(dense_lists):
        dense_slots[q, :x.size] = x
        dense_slab_pos[x] = q * dmax + np.arange(x.size, dtype=np.int32)

    own_cols = [cols[_entries_np(indptr, x)] for x in own_lists]
    halo_lists, row_halo_lists = [], []
    for q in range(p):
        refs = np.unique(own_cols[q]).astype(np.int32)
        remote = refs[owner[refs] != q]
        halo_lists.append(remote)
        row_halo_lists.append(remote[~dense[remote]])
    h = max([1] + [x.size for x in halo_lists])
    ht = max([1] + [x.size for x in row_halo_lists])

    own_gids = np.full((p, s_own), -1, np.int32)
    halo_gids = np.full((p, h), -1, np.int32)
    halo_src_dev = np.zeros((p, h), np.int32)
    halo_src_pos = np.zeros((p, h), np.int32)
    row_halo_gids = np.full((p, ht), -1, np.int32)
    share_sent = s_own + h
    row_sent = s_own + ht + p * dmax
    dm = np.flatnonzero(dense_slab_pos >= 0)
    loc_share, loc_row = [], []
    for q in range(p):
        own, hl, rhl = own_lists[q], halo_lists[q], row_halo_lists[q]
        own_gids[q, :own.size] = own
        halo_gids[q, :hl.size] = hl
        halo_src_dev[q, :hl.size] = owner[hl]
        halo_src_pos[q, :hl.size] = block_pos[hl]
        row_halo_gids[q, :rhl.size] = rhl
        share_map = np.full(s, share_sent, np.int64)
        share_map[hl] = s_own + np.arange(hl.size)
        share_map[own] = block_pos[own]
        row_map = np.full(s, row_sent, np.int64)
        row_map[dm] = s_own + ht + dense_slab_pos[dm]
        row_map[rhl] = s_own + np.arange(rhl.size)
        row_map[own] = block_pos[own]  # own rows win over the dense slab
        loc_share.append(share_map[own_cols[q]].astype(np.int32))
        loc_row.append(row_map[own_cols[q]].astype(np.int32))

    return PartitionTables(
        n_devices=p, s=s, d=d, dense_row_nnz=dense_row_nnz, owner=owner,
        block_pos=block_pos, own_gids=own_gids, halo_gids=halo_gids,
        halo_src_dev=halo_src_dev, halo_src_pos=halo_src_pos,
        row_halo_gids=row_halo_gids, dense_gids=dense_gids,
        dense_slots=dense_slots, loc_share=loc_share, loc_row=loc_row)


@dataclasses.dataclass(frozen=True)
class BlockMeta:
    """What every rank of the partitioned tier holds whole: the O(V) and
    O(S) arrays of a :class:`BlockSummary`, without its rows. It stands in
    for the summary where only those are read (set packing, the answers'
    gathers); ``nnz`` and ``max_row_nnz()`` describe the rows it left out."""

    ids: torch.Tensor  # int32[S]
    node2block: torch.Tensor  # int32[V]
    sizes: torch.Tensor  # float64[S]
    deg: torch.Tensor  # float64[S]
    num_nodes: int
    nnz: int
    d: int

    @property
    def num_blocks(self) -> int:
        return int(self.ids.shape[0])

    @property
    def device(self) -> torch.device:
        return self.deg.device

    def max_row_nnz(self) -> int:
        return self.d


@dataclasses.dataclass(frozen=True)
class PartitionRank:
    """The rows rank ``rank`` of the partitioned tier holds, on its device:
    its owned rows, the maps of their entries (:class:`PartitionTables`'
    ``loc_share``/``loc_row``), the halo coordinates, the resident halo rows
    and its dense rows, padded to the largest rank's ``dense_width`` entries
    for the second hop's gather."""

    rank: int
    own: RowSlab
    loc_share: torch.Tensor  # int32[n]
    loc_row: torch.Tensor  # int32[n]
    halo_src_dev: torch.Tensor  # int32[H]
    halo_src_pos: torch.Tensor  # int32[H]
    halo_indptr: torch.Tensor  # int64[Ht+1] resident halo rows
    halo_cols: torch.Tensor  # int32
    halo_sigma: torch.Tensor  # float64
    dense_len: torch.Tensor  # int64[Dm] entries of each dense row (0: a pad)
    dense_cols: torch.Tensor  # int32[dense_width]
    dense_sigma: torch.Tensor  # float64[dense_width]

    def nbytes(self) -> int:
        """Bytes of the tensors this rank holds for its rows."""
        return self.own.nbytes() + sum(
            getattr(self, f.name).numel() * getattr(self, f.name).element_size()
            for f in dataclasses.fields(self) if f.name not in ("rank", "own"))


def _rows_padded(bs: BlockSummary, gids: np.ndarray, width: int | None = None):
    """``(indptr, cols, sigma)`` of the rows ``gids`` (-1: an empty pad row) of
    ``bs``, on its device; the entries padded to ``width`` when given."""
    live = torch.as_tensor(gids[gids >= 0], dtype=torch.int64, device=bs.device)
    sub, ent, _ = Q.row_entries(bs.indptr, live)
    indptr = torch.cat([sub, sub[-1:].expand(int((gids < 0).sum()))])
    cols, sigma = bs.cols[ent], bs.sigma[ent]
    if width is not None:
        cols, sigma = _pad(cols, width), _pad(sigma, width)
    return indptr, cols, sigma


def partition_rank(bs: BlockSummary, t: PartitionTables, rank: int, dense_width: int,
                   device: torch.device) -> PartitionRank:
    """Rank ``rank``'s rows of ``bs`` per the tables, moved to ``device``."""
    q = rank
    own = Q.slab_of(bs, torch.as_tensor(t.own_gids[q][t.own_gids[q] >= 0],
                                        dtype=torch.int64, device=bs.device))
    h_indptr, h_cols, h_sigma = _rows_padded(bs, t.row_halo_gids[q])
    d_indptr, d_cols, d_sigma = _rows_padded(bs, t.dense_slots[q], dense_width)

    def put(x):
        return torch.as_tensor(x).to(device)

    return PartitionRank(
        rank=q, own=own.to(device),
        loc_share=put(t.loc_share[q]), loc_row=put(t.loc_row[q]),
        halo_src_dev=put(t.halo_src_dev[q]), halo_src_pos=put(t.halo_src_pos[q]),
        halo_indptr=put(h_indptr), halo_cols=put(h_cols), halo_sigma=put(h_sigma),
        dense_len=put(d_indptr[1:] - d_indptr[:-1]), dense_cols=put(d_cols),
        dense_sigma=put(d_sigma))


class PartitionedQueryEngine(RoutedQueryEngine):
    """Row-partitioned engine: each rank holds its owned rows and halo.

    The same wire format and answers as the other engines, but rank q keeps
    of the rows only what :class:`PartitionRank` lists (its owned rows'
    entries, the non-dense halo rows, its dense rows), with the O(S)/O(V)
    arrays whole (:class:`BlockMeta`). PageRank all-gathers the owned
    ``[2, S_own]`` (p, share) slab each step and reads remote shares at their
    ``(src_dev, src_pos)``; the residual is a max across ranks. The
    triangles run over ``[own | resident halo | gathered dense slab |
    sentinel]`` row tables, σ_ca looked up in row a's own entries. Cut and
    k-hop rows are the routed tier's, over the owned rows; adjacency is
    looked up in the owner's rows. A summary's CSR is built on the host and
    not kept: the tables are built from it (as the reference builds them on
    the host), each rank's part is cut from it and moved to the device, and
    it is dropped, so no device ever holds the whole CSR. A
    :class:`BlockSummary` passed in is cut where it lies. Port of the
    reference's ``PartitionedQueryEngine``.
    """

    def __init__(self, summary: SummaryResult | BlockSummary, *,
                 device: str | torch.device = "cuda", group=None, ranks: int | None = None,
                 salt: int = 0, dense_row_nnz: int | None = None, **params):
        self.dense_row_nnz = dense_row_nnz
        super().__init__(summary, device=device, group=group, ranks=ranks, salt=salt, **params)

    def _block_summary(self, summary, device):
        # the whole CSR on the host, only while the ranks' parts are cut from it
        return Q.block_summary(summary, "cpu")

    def _held(self, full, device):
        return BlockMeta(ids=full.ids.to(device), node2block=full.node2block.to(device),
                         sizes=full.sizes.to(device), deg=full.deg.to(device),
                         num_nodes=full.num_nodes, nnz=full.nnz, d=full.max_row_nnz())

    def _hosted_rows(self, full):
        self.tables = t = build_partition_tables(full, self.owner, self.ranks.size,
                                                 self.dense_row_nnz)
        lens = np.diff(full.indptr.cpu().numpy())
        dense_width = max([1] + [int(lens[x[x >= 0]].sum()) for x in t.dense_slots])
        self.parts = {r: partition_rank(full, t, r, dense_width, self.device)
                      for r in self.ranks.hosted}
        self._block_pos = torch.as_tensor(t.block_pos, dtype=torch.int64, device=self.device)
        self._replicated_bytes = sum(x.numel() * x.element_size() for x in (
            full.indptr, full.cols, full.sigma, full.deg_w, full.rows, full.key, full.long_rows))
        return {r: pr.own for r, pr in self.parts.items()}

    # ------------------------------------------------------------ pagerank
    def _pagerank(self):
        meta, w = self.bs, self.slab_width
        s, v_total = meta.num_blocks, float(meta.num_nodes)
        deg = {r: meta.deg[pr.own.gids] for r, pr in self.parts.items()}
        p = {r: torch.full((pr.own.n_rows,), 1.0 / v_total, dtype=F64, device=self.device)
             for r, pr in self.parts.items()}
        zero = torch.zeros(1, dtype=F64, device=self.device)
        steps = 0
        for _ in range(self.pagerank_iters):
            share = {r: Q.pagerank_share(p[r], deg[r]) for r in p}
            slab = self.ranks.gather([torch.stack([_pad(p[r], w), _pad(share[r], w)]) for r in p])
            dangling = Q.dangling_mass(meta.sizes, meta.deg, self._scatter(slab[:, 0]))
            new = {}
            for r, pr in self.parts.items():
                halo = slab[pr.halo_src_dev, 1, pr.halo_src_pos]
                share_ext = torch.cat([_pad(share[r], w), halo, zero])
                rows = Q.pagerank_rows(pr.own, share_ext[pr.loc_share])
                new[r] = Q.damped(rows, dangling, self.damping, v_total)
            steps += 1
            resid = self.ranks.gather([_pad(torch.abs(new[r] - p[r]), w).max() for r in p])
            done = s == 0 or float(resid.max()) < self.pagerank_tol
            p = new
            if done:
                break
        return self._merge([p[r] for r in self.parts]), steps

    # ------------------------------------------------------------ triangles
    def _triangle_rows(self):
        t = self.tables
        s, p, dm = t.s, t.n_devices, t.dense_slots.shape[1]
        dev = self.device
        hosted = list(self.parts.values())
        d_len = self.ranks.gather([pr.dense_len for pr in hosted]).reshape(-1)
        d_cols = self.ranks.gather([pr.dense_cols for pr in hosted])
        d_sigma = self.ranks.gather([pr.dense_sigma for pr in hosted])
        live = (torch.arange(d_cols.shape[1], device=dev)[None, :]
                < d_len.reshape(p, dm).sum(1, keepdim=True))
        d_cols, d_sigma = d_cols[live], d_sigma[live]
        parts, wedges = [], []
        for pr in hosted:
            own_len = pr.own.indptr[1:] - pr.own.indptr[:-1]
            lens = torch.cat([_pad(own_len, t.own_gids.shape[1]),
                              pr.halo_indptr[1:] - pr.halo_indptr[:-1], d_len,
                              torch.zeros(1, dtype=torch.int64, device=dev)])
            indptr = torch.zeros(lens.shape[0] + 1, dtype=torch.int64, device=dev)
            indptr[1:] = torch.cumsum(lens, 0)
            cols = torch.cat([pr.own.cols, pr.halo_cols, d_cols])
            sigma = torch.cat([pr.own.sigma, pr.halo_sigma, d_sigma])
            gids = torch.as_tensor(np.concatenate([
                t.own_gids[pr.rank], t.row_halo_gids[pr.rank], t.dense_slots.reshape(-1), [-1]]),
                dtype=torch.int64, device=dev)
            local = torch.repeat_interleave(torch.arange(lens.shape[0], device=dev), lens,
                                            output_size=cols.shape[0])
            upper = Q.row_upper(local * s + cols.to(torch.int64), gids, s)
            e = pr.loc_row.to(torch.int64)
            tri, w = Q.triangle_rows(pr.own, upper[e], indptr[e + 1], cols, sigma,
                                     self.bs.sizes, self.triangle_wedge_chunk)
            parts.append(tri)
            wedges.append(w)
        return self._merge(parts), self.ranks.total(wedges)

    # ------------------------------------------------------------ answers
    def _answers_of(self, rank, kt, ut, vt, out):
        if vt is None:
            return out
        a = self.bs.node2block[ut].to(torch.int64)
        b = self.bs.node2block[vt].to(torch.int64)
        sig = Q.pair_sigma(self.slabs[rank], self._block_pos[a], b)
        return torch.where(kt == KIND_ADJACENCY, torch.where(ut == vt, 0.0, sig), out)

    # ------------------------------------------------- memory accounting
    def partition_stats(self) -> dict:
        """The partition's shape and each rank's resident bytes (a collective
        over a process group: every rank calls it)."""
        t = self.tables
        return {
            "devices": int(t.n_devices),
            "s": int(t.s),
            "d": int(t.d),
            "s_own_max": int(t.own_gids.shape[1]),
            "halo_max": int(t.halo_gids.shape[1]),
            "row_halo_max": int(t.row_halo_gids.shape[1]),
            "dense_rows": int(t.dense_gids.size),
            "owner_counts": self.owner_counts().tolist(),
            "halo_counts": (t.halo_gids >= 0).sum(axis=1).tolist(),
            "resident_bytes_per_device": self.resident_bytes_per_device(),
            "replicated_row_bytes": self.replicated_row_bytes(),
        }

    def resident_bytes_per_device(self) -> list[int]:
        """Each rank's bytes of rows, measured from the tensors it holds
        (:meth:`PartitionRank.nbytes`), in rank order."""
        x = [torch.tensor(pr.nbytes(), dtype=torch.int64, device=self.device)
             for pr in self.parts.values()]
        return [int(b) for b in self.ranks.gather(x)]

    def replicated_row_bytes(self) -> int:
        """What the single-device engine and the routed tier keep of the rows
        on every device: the port's CSR (``indptr``, ``cols``, ``sigma``,
        ``deg_w``, ``rows``, ``key``, ``long_rows`` of the
        :class:`BlockSummary`), not the reference's padded ``S·D·20`` bytes."""
        return self._replicated_bytes
