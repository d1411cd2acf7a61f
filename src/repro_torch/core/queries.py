"""Graph analytics served directly from the summary graph, in block space.

Port of ``repro/core/queries.py`` (paper Sect. 1, benefit (b)
"Analyzable"). The reconstruction Ĝ (Eq. 1) is *block-constant*: every node
pair (u, v) with u∈A, v∈B has the same weight σ_AB = w(A,B)/|Π_AB|, so every
query runs in O(|S| + |P|) — supernode space — instead of O(|V| + |E|):

  * ``expected_degree`` — E[deg(u)] under Ĝ;
  * ``adjacency_weight`` — Â_uv, one block-σ lookup;
  * ``pagerank_summary`` — PageRank of Ĝ by power iteration in block space;
  * ``triangle_density`` — E[#triangles] of Ĝ from superedge weights;
  * ``cut_weight`` / ``conductance`` — expected cut mass between node sets
    and the conductance of a set, from per-block membership counts;
  * ``k_hop_size`` — |{v : dist_Ĝ(u, v) ≤ k}|, BFS on the superedge support.

All of them read one structure, :class:`BlockSummary`, the compacted
block-space CSR that :func:`build_block_summary` builds on a device once per
:class:`~repro_torch.core.types.SummaryResult` (memoized on the result, per
device). The batched engine :mod:`repro_torch.core.query_engine` answers
the same queries for a batch of requests with the functions of this module.

Order of additions. Row sums over the CSR (the expected degree, a PageRank
power step) go through :func:`repro_torch.kernels.ops.segment_sum`, which
adds each row's entries in storage order from zero: ``np.add.at``'s order,
so ``deg`` equals the reference's bit for bit and a power step's row sums
do too. Every longer sum (cut mass, volumes, the dangling mass, wedge sums)
is :func:`ordered_sum` (:func:`repro_torch.kernels.ops.ordered_sum`): fixed
segments of ``SUM_SEGMENT`` values, then their partial sums, in order. That
order does not depend on the device or on how many sums are taken at once,
so an answer has the same bits on the card and on the CPU, in any batch, on
every run; it is not numpy's pairwise order, so those answers agree with the
reference to rounding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import SummaryResult, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.segment_sum import long_rows

# Build counter for the memoization test: successive queries against the
# same SummaryResult on one device reuse the CSR instead of rebuilding it.
BLOCK_BUILDS = 0

_CACHE_ATTR = "_torch_block_summary_cache"

SUM_SEGMENT = 1024  # values added in order in the first fold of ordered_sum
WEDGE_CHUNK = 1 << 22  # wedges (a<b<c) materialized at once by triangle_sum

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class BlockSummary:
    """Compacted block-space view of a summary graph, on one device.

    The reference's arrays with its dtypes: supernode ids compacted to dense
    block indices ``0..S-1`` (sorted original-id order); the superedge set
    symmetrized into a CSR whose rows and columns are sorted, self-superedges
    as diagonal entries ``(a, a)``, zero-capacity self pairs (singleton
    blocks) skipped. ``deg_w[e] = σ_e · (n_col − [col == row])`` is the
    per-entry expected-degree weight, ``deg[a]`` its row sum. The port also
    keeps each entry's row and the globally sorted key ``row·S + col`` (the
    pair lookup's search array), which the reference recomputes per query,
    and the rows long enough for the row-sum kernel to give a warp each.
    """

    ids: torch.Tensor  # int32[S] original supernode ids (sorted)
    node2block: torch.Tensor  # int32[V] dense block index per node
    sizes: torch.Tensor  # float64[S] block cardinalities n_a
    indptr: torch.Tensor  # int64[S+1] CSR row pointers
    cols: torch.Tensor  # int32[nnz] neighbor block (row-major, col-sorted)
    sigma: torch.Tensor  # float64[nnz] block-constant weight σ
    deg_w: torch.Tensor  # float64[nnz] σ·(n_col − [col==row])
    deg: torch.Tensor  # float64[S] expected degree per node of block
    num_nodes: int  # |V|
    rows: torch.Tensor  # int32[nnz] row of every CSR entry
    key: torch.Tensor  # int64[nnz] row·S + col, ascending
    long_rows: torch.Tensor  # int64[L] rows of more than LONG_ROW entries

    @property
    def num_blocks(self) -> int:
        return int(self.ids.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0])

    @property
    def device(self) -> torch.device:
        return self.deg.device

    def max_row_nnz(self) -> int:
        """Widest CSR row (the reference engine's padded-row width D)."""
        if self.num_blocks == 0:
            return 0
        return int((self.indptr[1:] - self.indptr[:-1]).max())


def build_block_summary(res: SummaryResult,
                        device: str | torch.device = "cuda") -> BlockSummary:
    """Build (or fetch the memoized) block-space CSR for ``res`` on ``device``.

    Built on the device: ``torch.unique`` for the ids, ``torch.searchsorted``
    for ``node2block`` and the superedge endpoints, one sort of the int64
    key ``row·S + col`` for the CSR order (the keys are unique, so this is
    the reference's ``lexsort`` order), the row sums in storage order.
    """
    dev = resolve_device(device)
    cache = res.__dict__.setdefault(_CACHE_ATTR, {})
    if str(dev) in cache:
        return cache[str(dev)]
    global BLOCK_BUILDS
    BLOCK_BUILDS += 1

    def on_dev(x, dtype):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    n2s = on_dev(res.node2super, torch.int64)
    ids = torch.unique(n2s)
    s = int(ids.shape[0])
    node2block = torch.searchsorted(ids, n2s).to(torch.int32)
    n = on_dev(res.super_size, torch.int64)[ids].to(F64)

    lo = torch.searchsorted(ids, on_dev(res.edge_lo, torch.int64))
    hi = torch.searchsorted(ids, on_dev(res.edge_hi, torch.int64))
    w = on_dev(res.edge_w, F64)
    self_e = lo == hi
    # pair capacities |Π_AB| (Eq. 1); zero-capacity self pairs are dropped
    pi = torch.where(self_e, n[lo] * (n[lo] - 1.0) / 2.0, n[lo] * n[hi])
    keep = ~self_e | (pi > 0)
    lo, hi, self_e, pi, w = lo[keep], hi[keep], self_e[keep], pi[keep], w[keep]
    sig = torch.where(pi > 0, w / torch.clamp(pi, min=1.0), 0.0)

    # symmetrize: one CSR entry per direction, self pairs once
    cross = ~self_e
    rows = torch.cat([lo, hi[cross]])
    cols = torch.cat([hi, lo[cross]])
    sigs = torch.cat([sig, sig[cross]])
    key, order = torch.sort(rows * s + cols, stable=True)
    rows, cols, sigs = rows[order], cols[order], sigs[order]

    indptr = torch.zeros(s + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=s), 0)
    deg_w = sigs * (n[cols] - (cols == rows).to(F64))
    long = long_rows(indptr)
    deg = ops.segment_sum(indptr, deg_w, long)

    bs = BlockSummary(
        ids=ids.to(torch.int32), node2block=node2block, sizes=n, indptr=indptr,
        cols=cols.to(torch.int32), sigma=sigs, deg_w=deg_w, deg=deg,
        num_nodes=int(n2s.shape[0]), rows=rows.to(torch.int32), key=key, long_rows=long,
    )
    cache[str(dev)] = bs
    return bs


# --------------------------------------------------------- ordered sums

def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of ``x`` ([k, n] float64 → [k]) in a fixed order: segments of
    ``SUM_SEGMENT`` values left to right, then the segments' sums left to
    right. Each row's result depends on that row alone, and is the same on
    the card and on the CPU. One kernel launch on the card."""
    return ops.ordered_sum(x.to(F64).contiguous(), SUM_SEGMENT)


# --------------------------------------------------------- point queries

def pair_sigma(bs: BlockSummary, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """σ of the block pairs (a, b) (int64 tensors of one shape); 0 where the
    pair has no superedge. A binary search on the sorted key."""
    if bs.nnz == 0:
        return torch.zeros(a.shape, dtype=F64, device=bs.device)
    qk = a * bs.num_blocks + b
    pos = torch.clamp(torch.searchsorted(bs.key, qk), max=bs.nnz - 1)
    return torch.where(bs.key[pos] == qk, bs.sigma[pos], 0.0)


def expected_degree(res: SummaryResult, u: int,
                    device: str | torch.device = "cuda") -> float:
    bs = build_block_summary(res, device)
    return float(bs.deg[bs.node2block[int(u)]])


def adjacency_weight(res: SummaryResult, u: int, v: int,
                     device: str | torch.device = "cuda") -> float:
    """Â_uv of the reconstructed Ĝ (Eq. 1): the σ of the (block(u),
    block(v)) superedge, 0 on the diagonal and for absent pairs."""
    if int(u) == int(v):
        return 0.0
    bs = build_block_summary(res, device)
    a = bs.node2block[int(u)].to(torch.int64)
    b = bs.node2block[int(v)].to(torch.int64)
    return float(pair_sigma(bs, a, b))


# --------------------------------------------------------- PageRank

def pagerank_power(bs: BlockSummary, damping: float = 0.85, iters: int = 50,
                   tol: float = 1e-10) -> tuple[torch.Tensor, int]:
    """Power iteration in block space: the per-node PageRank value of each
    block (float64[S]) and the number of power steps taken. The reference's
    loop update for update, with its early break when no value moved by
    ``tol`` (one host read of the residual a step)."""
    s = bs.num_blocks
    v_total = float(bs.num_nodes)
    p = torch.full((s,), 1.0 / v_total, dtype=F64, device=bs.device)
    has_deg = bs.deg > 0
    deg_floor = torch.clamp(bs.deg, min=1e-300)
    dangling_rows = bs.deg <= 0
    steps = 0
    for _ in range(iters):
        share = torch.where(has_deg, p / deg_floor, 0.0)
        new = ops.segment_sum(bs.indptr, bs.deg_w * share[bs.cols], bs.long_rows)
        dangling = ordered_sum(torch.where(dangling_rows, p * bs.sizes, 0.0)[None])[0]
        new = (1.0 - damping) / v_total + damping * (new + dangling / v_total)
        steps += 1
        done = s == 0 or float(torch.max(torch.abs(new - p))) < tol
        p = new
        if done:
            break
    return p, steps


def pagerank_blocks(bs: BlockSummary, damping: float = 0.85, iters: int = 50,
                    tol: float = 1e-10) -> torch.Tensor:
    return pagerank_power(bs, damping, iters, tol)[0]


def pagerank_summary(res: SummaryResult, damping: float = 0.85, iters: int = 50,
                     tol: float = 1e-10,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """PageRank of the reconstructed Ĝ, computed in supernode space: the
    per-*node* vector (length |V|), node u's value its block's."""
    bs = build_block_summary(res, device)
    return pagerank_blocks(bs, damping=damping, iters=iters, tol=tol)[bs.node2block]


# --------------------------------------------------------- triangles

def triangle_sum(bs: BlockSummary, wedge_chunk: int = WEDGE_CHUNK) -> tuple[float, int]:
    """E[#triangles] over strictly-distinct block triples a<b<c on the
    superedge support, Σ σ_ab σ_bc σ_ca n_a n_b n_c, and the number of
    wedges walked.

    Wedges are enumerated from the CSR: every entry (a, b) with b > a meets
    every entry (b, c) of row b with c > b, and (c, a) is looked up by
    binary search. They are materialized ``wedge_chunk`` at a time (more
    only when one entry alone has more), so memory is bounded by the chunk
    and not by the square of the widest row; each chunk is an
    :func:`ordered_sum`, and the chunks' sums are added in order.
    """
    s, nnz = bs.num_blocks, bs.nnz
    if nnz == 0:
        return 0.0, 0
    dev = bs.device
    blocks = torch.arange(s, device=dev)
    # first entry of each row b whose column is past b
    upper = torch.searchsorted(bs.key, blocks * s + blocks, right=True)
    ent = torch.nonzero(bs.cols > bs.rows).squeeze(1)
    b_ent = bs.cols[ent].to(torch.int64)
    n_wedges = bs.indptr[b_ent + 1] - upper[b_ent]
    cum = torch.cumsum(n_wedges, 0).cpu().numpy()
    wedges = int(cum[-1]) if cum.size else 0
    total, start, done = 0.0, 0, 0
    while start < cum.size:
        end = max(int(np.searchsorted(cum, done + wedge_chunk, side="right")), start + 1)
        count = int(cum[end - 1]) - done
        if count:
            c_ent = n_wedges[start:end]
            local = torch.repeat_interleave(torch.arange(end - start, device=dev), c_ent,
                                            output_size=count)
            first = torch.cumsum(c_ent, 0) - c_ent
            e_ab = ent[start:end][local]
            e_bc = (upper[b_ent[start:end]][local]
                    + torch.arange(count, device=dev) - first[local])
            a = bs.rows[e_ab].to(torch.int64)
            b = bs.cols[e_ab].to(torch.int64)
            c = bs.cols[e_bc].to(torch.int64)
            term = (bs.sigma[e_ab] * bs.sigma[e_bc] * pair_sigma(bs, c, a)
                    * bs.sizes[a] * bs.sizes[b] * bs.sizes[c])
            total += float(ordered_sum(term[None])[0])
        done = int(cum[end - 1])
        start = end
    return total, wedges


def triangle_blocks(bs: BlockSummary) -> float:
    return triangle_sum(bs)[0]


def triangle_density(res: SummaryResult, device: str | torch.device = "cuda") -> float:
    """E[#triangles] of Ĝ (sum over supernode triples of σ products),
    restricted to the superedge support."""
    return triangle_blocks(build_block_summary(res, device))


# --------------------------------------------------------- set queries

def set_marks(bs: BlockSummary, sets) -> torch.Tensor:
    """bool[k, V]: row i marks the nodes of ``sets[i]`` (None or empty: none),
    so repeated nodes count once — the analytics are set queries."""
    arrays = [np.asarray(() if x is None else x, dtype=np.int64).ravel() for x in sets]
    nodes = np.concatenate(arrays) if arrays else np.zeros(0, np.int64)
    if nodes.size and (nodes.min() < 0 or nodes.max() >= bs.num_nodes):
        raise IndexError(f"node ids must be in [0, {bs.num_nodes}); got "
                         f"[{nodes.min()}, {nodes.max()}]")
    slot = np.repeat(np.arange(len(arrays)), [x.size for x in arrays])
    mark = torch.zeros((len(arrays), bs.num_nodes), dtype=torch.bool, device=bs.device)
    mark[torch.as_tensor(slot, device=bs.device), torch.as_tensor(nodes, device=bs.device)] = True
    return mark


def mark_counts(bs: BlockSummary, mark: torch.Tensor) -> torch.Tensor:
    """Per-block member counts of marked node sets (bool[k, V] → float64[k, S])."""
    k, s = mark.shape[0], bs.num_blocks
    slot, node = torch.nonzero(mark, as_tuple=True)
    flat = slot * s + bs.node2block[node].to(torch.int64)
    return torch.bincount(flat, minlength=k * s).reshape(k, s).to(F64)


def block_counts(bs: BlockSummary, nodes) -> torch.Tensor:
    """Per-block membership counts of a node *set* (float64[S]); duplicates
    count once."""
    return mark_counts(bs, set_marks(bs, [nodes]))[0]


def cut_from_counts(bs: BlockSummary, c_a: torch.Tensor, c_b: torch.Tensor,
                    overlap: torch.Tensor) -> torch.Tensor:
    """Σ_{u∈A, v∈B, u≠v} Â_uv from per-block counts ([k, S] each → [k]).

    Every ordered pair inside one block pair has the same σ, so the sum is
    Σ_e σ_e · c_A[row] · c_B[col] over the symmetrized CSR, less the u == v
    diagonal of same-block pairs (``overlap`` counts |A∩B| per block), which
    Â zeroes. The entry list is reduced as it is, with no padded rows.
    """
    rows, cols = bs.rows, bs.cols
    total = ordered_sum(bs.sigma * c_a[:, rows] * c_b[:, cols])
    diag = torch.where(rows == cols, bs.sigma * overlap[:, rows], 0.0)
    return total - ordered_sum(diag)


def conductance_from_counts(bs: BlockSummary, c_a: torch.Tensor) -> torch.Tensor:
    """φ(A) = cut(A, V∖A) / min(vol(A), vol(V∖A)) from per-block counts of A
    ([k, S] → [k]); 0 where a side has no volume."""
    c_c = bs.sizes - c_a
    vol_a = ordered_sum(c_a * bs.deg)
    vol_c = ordered_sum(c_c * bs.deg)
    denom = torch.minimum(vol_a, vol_c)
    cut = cut_from_counts(bs, c_a, c_c, torch.zeros_like(c_a))
    return torch.where(denom > 0.0, cut / torch.where(denom > 0.0, denom, 1.0), 0.0)


def cut_weight(res: SummaryResult, a_nodes, b_nodes,
               device: str | torch.device = "cuda") -> float:
    """Expected total edge weight between node sets A and B under Ĝ
    (self-pairs u == v excluded; A and B may overlap)."""
    bs = build_block_summary(res, device)
    mark = set_marks(bs, [a_nodes, b_nodes])
    cnt = mark_counts(bs, torch.cat([mark, mark[:1] & mark[1:]]))
    return float(cut_from_counts(bs, cnt[:1], cnt[1:2], cnt[2:])[0])


def conductance(res: SummaryResult, a_nodes,
                device: str | torch.device = "cuda") -> float:
    """φ(A) on Ĝ, where vol sums expected degrees. Degenerate sets (A empty,
    A = V, or a zero-volume side) give 0.0."""
    bs = build_block_summary(res, device)
    return float(conductance_from_counts(bs, block_counts(bs, a_nodes)[None])[0])


# --------------------------------------------------------- k-hop

def khop_step(bs: BlockSummary, reach: torch.Tensor) -> torch.Tensor:
    """One BFS step on the superedge support: block a becomes reachable when
    an entry (a, b) with σ > 0 has b in ``reach`` (bool [k, S] → [k, S])."""
    live = bs.sigma > 0.0
    hits = torch.where(live, reach[:, bs.cols], False).to(torch.int32)
    out = torch.zeros(reach.shape, dtype=torch.int32, device=reach.device)
    return out.index_add_(1, bs.rows, hits) > 0


def k_hop_sizes(bs: BlockSummary, a0: torch.Tensor, hops: np.ndarray) -> torch.Tensor:
    """|{v : dist_Ĝ(u, v) ≤ k}| for start blocks ``a0`` (int64[k]) and hop
    counts ``hops`` (host ints, [k]); float64[k].

    Every member of a block has the same adjacency, so one BFS over blocks
    answers for all its members. The first step leaves u's block (a
    self-superedge puts its *other* members at distance 1); the loop stops
    at each request's k, or earlier when nothing grows.
    """
    s = bs.num_blocks
    onehot = a0[:, None] == torch.arange(s, device=bs.device)[None, :]
    reach = torch.zeros_like(onehot)
    hops_t = torch.as_tensor(np.asarray(hops), device=bs.device)
    for t in range(int(np.max(hops, initial=0))):
        grown = khop_step(bs, onehot if t == 0 else reach) | reach
        grown = torch.where((t < hops_t)[:, None], grown, reach)
        if torch.equal(grown, reach):  # a fixpoint: no later step grows it
            break
        reach = grown
    members = bs.sizes[None, :] - onehot.to(F64)
    return 1.0 + torch.where(reach, members, 0.0).sum(-1)


def k_hop_size(res: SummaryResult, u: int, k: int,
               device: str | torch.device = "cuda") -> float:
    """|{v : dist_Ĝ(u, v) ≤ k}| — the size of u's k-hop neighborhood in the
    reconstructed graph, served from the superedge support; k = 0 is {u}."""
    bs = build_block_summary(res, device)
    a0 = bs.node2block[int(u)].to(torch.int64).reshape(1)
    return float(k_hop_sizes(bs, a0, np.array([int(k)]))[0])
