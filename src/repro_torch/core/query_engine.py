"""Batched summary-query engine on one device.

Port of the single-device part of ``repro/core/queries_jax.py``. The
:class:`~repro_torch.core.queries.BlockSummary` CSR lives on the device in
float64, and a batch of ``[B]`` requests of mixed kinds is answered at once:

  * ``expected_degree``  — one gather: ``deg[node2block[u]]``;
  * ``adjacency_weight`` — a binary search of σ on the sorted ``row·S + col``
    key;
  * ``pagerank``         — the block-space power iteration (computed once,
    then served as a gather), step for step the reference's loop with its
    early break; the engine keeps the number of steps it took;
  * ``triangle_density`` — wedges enumerated from the CSR in chunks of a
    fixed wedge count (computed once, then served as a scalar);
  * ``cut_weight`` / ``conductance`` — node sets packed to per-block count
    rows on the device, reduced over the CSR's entry list;
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

Not ported here: the owner-routed and memory-partitioned multi-device
engines (``RoutedQueryEngine``, ``PartitionTables``,
``PartitionedQueryEngine``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import queries as Q
from repro_torch.core.queries import F64, BlockSummary, build_block_summary
from repro_torch.core.types import SummaryResult, resolve_device

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


def degree_kernel(bs: BlockSummary, u: torch.Tensor) -> torch.Tensor:
    return bs.deg[bs.node2block[u]]


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


def analytics_answers(bs: BlockSummary, kinds: np.ndarray, cnt_a, cnt_b, ov) -> torch.Tensor:
    """cut or conductance (float64[k]) of k set-kind slots from their count
    rows ([k, S]); conductance derives its complement counts from ``cnt_a``."""
    out = torch.zeros(kinds.shape[0], dtype=F64, device=bs.device)
    for kind in SET_KINDS:
        rows = np.nonzero(kinds == kind)[0]
        if rows.size == 0:
            continue
        idx = torch.as_tensor(rows, device=bs.device)
        if kind == KIND_CUT:
            out[idx] = Q.cut_from_counts(bs, cnt_a[idx], cnt_b[idx], ov[idx])
        else:
            out[idx] = Q.conductance_from_counts(bs, cnt_a[idx])
    return out


class QueryEngine:
    """Single-device batched query engine over one summary.

    PageRank and triangle density are computed on first use and then served
    as a gather / a scalar; ``pagerank_iterations`` and ``triangle_wedges``
    say what that took. Batched methods return host numpy float64 arrays.
    """

    def __init__(self, summary: SummaryResult | BlockSummary, *,
                 device: str | torch.device = "cuda", damping: float = 0.85,
                 pagerank_iters: int = 50, pagerank_tol: float = 1e-10,
                 triangle_wedge_chunk: int = Q.WEDGE_CHUNK, khop_max: int = 16):
        if isinstance(summary, BlockSummary):
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

    # ------------------------------------------------ lazy global queries
    def pagerank_blocks(self) -> torch.Tensor:
        if self._pr_blocks is None:
            self._pr_blocks, self.pagerank_iterations = Q.pagerank_power(
                self.bs, self.damping, self.pagerank_iters, self.pagerank_tol)
        return self._pr_blocks

    def triangle_density(self) -> float:
        if self._tri is None:
            self._tri, self.triangle_wedges = Q.triangle_sum(self.bs, self.triangle_wedge_chunk)
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
    def expected_degree(self, u) -> np.ndarray:
        return degree_kernel(self.bs, self._nodes(u)).cpu().numpy()

    def adjacency_weight(self, u, v) -> np.ndarray:
        return adjacency_kernel(self.bs, self._nodes(u), self._nodes(v)).cpu().numpy()

    def answer_batch(self, kinds, u, v, cnt_a=None, cnt_b=None, ov=None) -> np.ndarray:
        """Mixed-kind batch: ``kinds``/``u``/``v`` are int[B]; returns
        float64[B]. PageRank and the triangle total are computed only if the
        batch asks for them. Set kinds read the [B, S] count rows of
        :func:`pack_set_counts` (zeros when absent); khop carries k in v."""
        kinds = np.asarray(kinds, np.int32)
        u = np.asarray(u, np.int64)
        v = np.asarray(v, np.int64)
        bs = self.bs
        node = np.isin(kinds, _NODE_KINDS)
        ut = self._nodes(np.where(node, u, 0))
        kt = torch.as_tensor(kinds, device=self.device)
        out = torch.where(kt == KIND_DEGREE, degree_kernel(bs, ut), 0.0)
        adj = kinds == KIND_ADJACENCY
        if adj.any():
            vt = self._nodes(np.where(adj, v, 0))
            out = torch.where(kt == KIND_ADJACENCY, adjacency_kernel(bs, ut, vt), out)
        if (kinds == KIND_PAGERANK).any():
            pr = self.pagerank_blocks()[bs.node2block[ut]]
            out = torch.where(kt == KIND_PAGERANK, pr, out)
        if (kinds == KIND_TRIANGLE).any():
            out = torch.where(kt == KIND_TRIANGLE, self.triangle_density(), out)
        khop = np.nonzero(kinds == KIND_KHOP)[0]
        if khop.size:
            hops = np.minimum(v[khop], self.khop_max)
            if hops.min() < 0:
                raise ValueError(f"khop: hop counts must be >= 0; got {hops.min()}")
            idx = torch.as_tensor(khop, device=self.device)
            a0 = bs.node2block[ut[idx]].to(torch.int64)
            out[idx] = Q.k_hop_sizes(bs, a0, hops)
        sets = np.nonzero(np.isin(kinds, SET_KINDS))[0]
        if sets.size:
            idx = torch.as_tensor(sets, device=self.device)
            shape = (kinds.shape[0], bs.num_blocks)
            ca, cb, oo = (torch.zeros(shape, dtype=F64, device=self.device) if x is None
                          else torch.as_tensor(x, dtype=F64, device=self.device)
                          for x in (cnt_a, cnt_b, ov))
            out[idx] = analytics_answers(bs, kinds[sets], ca[idx], cb[idx], oo[idx])
        return out.cpu().numpy()

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
