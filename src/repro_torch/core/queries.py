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

Order of additions. Every answer that sums over rows is built from per-row
values, each a fixed-order sum over that row's own entries, followed by one
:func:`ordered_sum` over the ``[S]`` (or ``[k, S]``) row values. Row sums
over the CSR (the expected degree, a PageRank power step, a cut row, a
row's wedges) go through :func:`repro_torch.kernels.ops.segment_sum`, which
adds each row's entries in storage order from zero: ``np.add.at``'s order,
so ``deg`` equals the reference's bit for bit and a power step's row sums
do too. :func:`ordered_sum` (:func:`repro_torch.kernels.ops.ordered_sum`)
adds fixed segments of ``SUM_SEGMENT`` values, then their partial sums, in
order. Neither order depends on the device, on how many sums are taken at
once, or on which rows one launch covers, so an answer has the same bits
on the card and on the CPU, in any batch, on every run, and when the rows
are computed by the ranks that own them and merged
(:mod:`repro_torch.core.query_engine`'s tiers). It is not numpy's pairwise
order, so those answers agree with the reference to rounding.

The per-row functions take a :class:`RowSlab`, some rows of the CSR as one
rank holds them (:func:`whole_slab`: every row, on one device).
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
    """Build (or fetch the memoized) block-space CSR for ``res`` on ``device``
    (:func:`block_summary`, kept on ``res`` per device)."""
    dev = resolve_device(device)
    cache = res.__dict__.setdefault(_CACHE_ATTR, {})
    if str(dev) not in cache:
        cache[str(dev)] = block_summary(res, dev)
    return cache[str(dev)]


def block_summary(res: SummaryResult, device: str | torch.device = "cuda") -> BlockSummary:
    """Build the block-space CSR for ``res`` on ``device``, not memoized.

    Built on the device: ``torch.unique`` for the ids, ``torch.searchsorted``
    for ``node2block`` and the superedge endpoints, one sort of the int64
    key ``row·S + col`` for the CSR order (the keys are unique, so this is
    the reference's ``lexsort`` order), the row sums in storage order.
    """
    dev = resolve_device(device)
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

    return BlockSummary(
        ids=ids.to(torch.int32), node2block=node2block, sizes=n, indptr=indptr,
        cols=cols.to(torch.int32), sigma=sigs, deg_w=deg_w, deg=deg,
        num_nodes=int(n2s.shape[0]), rows=rows.to(torch.int32), key=key, long_rows=long,
    )


# --------------------------------------------------------- row slabs

@dataclasses.dataclass(frozen=True)
class RowSlab:
    """Some rows of the block CSR, as one rank holds them.

    ``gids`` are the rows' block ids, ascending; their entries follow in
    storage order, each with its local row (the position in ``gids``), its
    global column and weights, and the key ``local row · S + col``, which is
    ascending, so an entry of these rows is found by binary search.
    :func:`whole_slab` is every row (the single-device engine's view of a
    :class:`BlockSummary`); :func:`slab_of` gathers a rank's rows.
    """

    gids: torch.Tensor  # int64[k] block ids of the rows, ascending
    indptr: torch.Tensor  # int64[k+1] row pointers into the entries below
    rows: torch.Tensor  # int32[n] local row of every entry
    cols: torch.Tensor  # int32[n] global column (block id)
    sigma: torch.Tensor  # float64[n]
    deg_w: torch.Tensor  # float64[n]
    key: torch.Tensor  # int64[n] local row · S + col, ascending
    long: torch.Tensor  # int64[L] local rows of more than LONG_ROW entries
    num_blocks: int  # S, the size of the column space

    @property
    def n_rows(self) -> int:
        return int(self.gids.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0])

    def to(self, device) -> RowSlab:
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "num_blocks"})

    def nbytes(self) -> int:
        """Bytes of the tensors that hold these rows."""
        return sum(x.numel() * x.element_size() for x in (
            self.gids, self.indptr, self.rows, self.cols, self.sigma, self.deg_w, self.key,
            self.long))


def whole_slab(bs: BlockSummary) -> RowSlab:
    """Every row of ``bs``, sharing its tensors (local row = block id)."""
    return RowSlab(gids=torch.arange(bs.num_blocks, device=bs.device), indptr=bs.indptr,
                   rows=bs.rows, cols=bs.cols, sigma=bs.sigma, deg_w=bs.deg_w, key=bs.key,
                   long=bs.long_rows, num_blocks=bs.num_blocks)


def row_entries(indptr: torch.Tensor, rows: torch.Tensor):
    """The entries of ``rows`` (int64, on ``indptr``'s device) of a CSR:
    ``(sub_indptr int64[k+1], ent int64[n], local int64[n])``, the entries in
    row order and storage order, each with its position in ``rows``."""
    lengths = indptr[rows + 1] - indptr[rows]
    sub = torch.zeros(rows.shape[0] + 1, dtype=torch.int64, device=indptr.device)
    sub[1:] = torch.cumsum(lengths, 0)
    n = int(sub[-1])
    local = torch.repeat_interleave(torch.arange(rows.shape[0], device=indptr.device),
                                    lengths, output_size=n)
    ent = indptr[rows][local] + torch.arange(n, device=indptr.device) - sub[:-1][local]
    return sub, ent, local


def slab_of(bs: BlockSummary, gids: torch.Tensor) -> RowSlab:
    """The rows ``gids`` (ascending block ids) of ``bs``, copied out."""
    gids = gids.to(torch.int64)
    sub, ent, local = row_entries(bs.indptr, gids)
    cols = bs.cols[ent]
    return RowSlab(gids=gids, indptr=sub, rows=local.to(torch.int32), cols=cols,
                   sigma=bs.sigma[ent], deg_w=bs.deg_w[ent],
                   key=local * bs.num_blocks + cols.to(torch.int64), long=long_rows(sub),
                   num_blocks=bs.num_blocks)


def row_upper(key: torch.Tensor, gids: torch.Tensor, s: int) -> torch.Tensor:
    """For each row of a CSR whose key is ``local row · s + col``: the first
    entry whose column is past the row's block id ``gids`` (a padding row,
    id -1, has no entries: its start)."""
    local = torch.arange(gids.shape[0], device=key.device)
    return torch.searchsorted(key, local * s + gids.to(torch.int64), right=True)


def slab_row_sums(slab: RowSlab, vals: torch.Tensor) -> torch.Tensor:
    """Row sums of ``k`` value lists over the slab's entries ([k, n] →
    float64[k, rows]): one :func:`~repro_torch.kernels.ops.segment_sum`
    launch over ``k`` copies of the slab's row pointers."""
    k, n, m = vals.shape[0], slab.n_rows, slab.nnz
    dev = vals.device
    off = torch.arange(k, device=dev)[:, None]
    indptr = torch.cat([(slab.indptr[:-1][None, :] + off * m).reshape(-1),
                        torch.full((1,), k * m, dtype=torch.int64, device=dev)])
    long = (slab.long[None, :] + off * n).reshape(-1)
    return ops.segment_sum(indptr, vals.reshape(-1).to(F64).contiguous(), long).reshape(k, n)


# --------------------------------------------------------- ordered sums

def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of ``x`` ([k, n] float64 → [k]) in a fixed order: segments of
    ``SUM_SEGMENT`` values left to right, then the segments' sums left to
    right. Each row's result depends on that row alone, and is the same on
    the card and on the CPU. One kernel launch on the card."""
    return ops.ordered_sum(x.to(F64).contiguous(), SUM_SEGMENT)


# --------------------------------------------------------- point queries

def pair_sigma(rows: BlockSummary | RowSlab, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """σ of the entries (row ``a``, column ``b``) (int64 tensors of one
    shape); 0 where the row has no such entry. A binary search on the sorted
    key. ``rows`` is a :class:`BlockSummary` (``a`` a block id) or a
    :class:`RowSlab` (``a`` a local row)."""
    if rows.nnz == 0:
        return torch.zeros(a.shape, dtype=F64, device=rows.sigma.device)
    qk = a * rows.num_blocks + b
    pos = torch.clamp(torch.searchsorted(rows.key, qk), max=rows.nnz - 1)
    return torch.where(rows.key[pos] == qk, rows.sigma[pos], 0.0)


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

def pagerank_rows(slab: RowSlab, share_e: torch.Tensor) -> torch.Tensor:
    """A power step's row sums Σ_e deg_w[e]·share(col e) over the slab's rows
    (float64[rows]); ``share_e`` is the share of every entry's column."""
    return ops.segment_sum(slab.indptr, slab.deg_w * share_e, slab.long)


def pagerank_share(p: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Each block's share p/deg of its PageRank (0 where deg is 0)."""
    return torch.where(deg > 0, p / torch.clamp(deg, min=1e-300), 0.0)


def dangling_mass(sizes: torch.Tensor, deg: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Σ over blocks without degree of p·n, in :func:`ordered_sum`'s order."""
    return ordered_sum(torch.where(deg <= 0, p * sizes, 0.0)[None])[0]


def damped(rows: torch.Tensor, dangling: torch.Tensor, damping: float,
           v_total: float) -> torch.Tensor:
    """The power step's update from its row sums and the dangling mass."""
    return (1.0 - damping) / v_total + damping * (rows + dangling / v_total)


def pagerank_power(bs: BlockSummary, damping: float = 0.85, iters: int = 50,
                   tol: float = 1e-10) -> tuple[torch.Tensor, int]:
    """Power iteration in block space: the per-node PageRank value of each
    block (float64[S]) and the number of power steps taken. The reference's
    loop update for update, with its early break when no value moved by
    ``tol`` (one host read of the residual a step); a step's row sums are
    one launch over every row."""
    slab, cols = whole_slab(bs), bs.cols.to(torch.int64)
    s = bs.num_blocks
    v_total = float(bs.num_nodes)
    p = torch.full((s,), 1.0 / v_total, dtype=F64, device=bs.device)
    steps = 0
    for _ in range(iters):
        new = damped(pagerank_rows(slab, pagerank_share(p, bs.deg)[cols]),
                     dangling_mass(bs.sizes, bs.deg, p), damping, v_total)
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

def triangle_rows(slab: RowSlab, b_lo: torch.Tensor, b_hi: torch.Tensor,
                  tcols: torch.Tensor, tsigma: torch.Tensor, sizes: torch.Tensor,
                  wedge_chunk: int = WEDGE_CHUNK) -> tuple[torch.Tensor, int]:
    """Per-row triangle mass of the slab's rows and the wedges walked.

    ``tri[a] = Σ σ_ab σ_bc σ_ca n_a n_b n_c`` over the wedges (a, b, c) whose
    first entry (a, b), b > a, lies in row a, and c > b in row b: row b's
    entries past b are ``tcols[b_lo[e]:b_hi[e]]`` / ``tsigma[...]`` for the
    slab entry e = (a, b) (the whole CSR on one device, a rank's own, halo
    and dense rows in the partitioned tier). σ_ca is looked up in row a
    (the CSR is symmetric, σ_ca is σ_ac's value). Each row's wedges are
    added in order (entry by entry, then row b's storage order) by one
    :func:`~repro_torch.kernels.ops.segment_sum`, so a row's value depends
    on that row alone. Wedges are materialized by whole rows, ``wedge_chunk``
    at a time (a row of more gets a chunk of its own), so memory is bounded
    by the chunk and not by the square of the widest row.
    """
    n_rows = slab.n_rows
    dev = slab.sigma.device
    tri = torch.zeros(n_rows, dtype=F64, device=dev)
    if slab.nnz == 0:
        return tri, 0
    rows = slab.rows.to(torch.int64)
    ent = torch.nonzero(slab.cols.to(torch.int64) > slab.gids[rows]).squeeze(1)
    n_wedges = b_hi[ent] - b_lo[ent]
    row_of = rows[ent]
    per_row = torch.zeros(n_rows, dtype=torch.int64, device=dev).index_add_(0, row_of, n_wedges)
    cum = torch.cumsum(per_row, 0).cpu().numpy()
    row_of_h = row_of.cpu().numpy()
    wedges = int(cum[-1]) if cum.size else 0
    start, done = 0, 0
    while start < n_rows:
        end = max(int(np.searchsorted(cum, done + wedge_chunk, side="right")), start + 1)
        count = int(cum[end - 1]) - done
        if count:
            e0, e1 = (int(x) for x in np.searchsorted(row_of_h, [start, end]))
            c_ent = n_wedges[e0:e1]
            local = torch.repeat_interleave(torch.arange(e1 - e0, device=dev), c_ent,
                                            output_size=count)
            first = torch.cumsum(c_ent, 0) - c_ent
            e_ab = ent[e0:e1][local]
            e_bc = b_lo[e_ab] + torch.arange(count, device=dev) - first[local]
            a_loc = rows[e_ab]
            a = slab.gids[a_loc]
            b = slab.cols[e_ab].to(torch.int64)
            c = tcols[e_bc].to(torch.int64)
            term = (slab.sigma[e_ab] * tsigma[e_bc] * pair_sigma(slab, a_loc, c)
                    * sizes[a] * sizes[b] * sizes[c])
            indptr = torch.zeros(end - start + 1, dtype=torch.int64, device=dev)
            indptr[1:] = torch.cumsum(per_row[start:end], 0)
            tri[start:end] = ops.segment_sum(indptr, term, long_rows(indptr))
        done = int(cum[end - 1])
        start = end
    return tri, wedges


def triangle_sum(bs: BlockSummary, wedge_chunk: int = WEDGE_CHUNK) -> tuple[float, int]:
    """E[#triangles] over strictly-distinct block triples a<b<c on the
    superedge support, Σ σ_ab σ_bc σ_ca n_a n_b n_c, and the number of
    wedges walked: the :func:`triangle_rows` of every row, then one
    :func:`ordered_sum` over them."""
    tri, wedges = triangle_rows(whole_slab(bs), *csr_wedge_bounds(bs), bs.cols, bs.sigma,
                                bs.sizes, wedge_chunk)
    return float(ordered_sum(tri[None])[0]), wedges


def csr_wedge_bounds(bs: BlockSummary, cols: torch.Tensor | None = None):
    """For entries whose columns are ``cols`` (default: every entry of
    ``bs``): where row b = col's entries past b start and end in ``bs``."""
    b = (bs.cols if cols is None else cols).to(torch.int64)
    upper = row_upper(bs.key, torch.arange(bs.num_blocks, device=bs.device), bs.num_blocks)
    return upper[b], bs.indptr[b + 1]


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


def cut_rows(slab: RowSlab, c_a: torch.Tensor, c_b: torch.Tensor,
             overlap: torch.Tensor) -> torch.Tensor:
    """Per-row cut contributions of the slab's rows ([k, rows]) from the
    per-block counts ([k, S] each): row a gives
    ``c_a[a]·Σ_j σ_aj·c_b[col_j] − σ_aa·overlap[a]``, the reference's
    ``cut_rows`` (``repro/core/queries_jax.py``), its row sum in storage
    order. Every ordered pair inside one block pair has the same σ; the
    ``overlap`` term (|A∩B| per block) takes out the u == v diagonal of
    same-block pairs, which Â zeroes."""
    rows = slab.rows.to(torch.int64)
    rowsum = slab_row_sums(slab, slab.sigma * c_b[:, slab.cols.to(torch.int64)])
    diag = slab.cols.to(torch.int64) == slab.gids[rows]
    sdiag = torch.zeros(slab.n_rows, dtype=F64, device=slab.sigma.device)
    sdiag[rows[diag]] = slab.sigma[diag]
    return c_a[:, slab.gids] * rowsum - sdiag * overlap[:, slab.gids]


def cut_from_counts(bs: BlockSummary, c_a: torch.Tensor, c_b: torch.Tensor,
                    overlap: torch.Tensor) -> torch.Tensor:
    """Σ_{u∈A, v∈B, u≠v} Â_uv from per-block counts ([k, S] each → [k]): the
    :func:`cut_rows` of every block, added by one :func:`ordered_sum`."""
    return ordered_sum(cut_rows(whole_slab(bs), c_a, c_b, overlap))


def conductance_of_cut(bs: BlockSummary, c_a: torch.Tensor, cut: torch.Tensor) -> torch.Tensor:
    """φ(A) = cut(A, V∖A) / min(vol(A), vol(V∖A)) from per-block counts of A
    ([k, S]) and its cut ([k]); 0 where a side has no volume."""
    vol_a = ordered_sum(c_a * bs.deg)
    vol_c = ordered_sum((bs.sizes - c_a) * bs.deg)
    denom = torch.minimum(vol_a, vol_c)
    return torch.where(denom > 0.0, cut / torch.where(denom > 0.0, denom, 1.0), 0.0)


def conductance_from_counts(bs: BlockSummary, c_a: torch.Tensor) -> torch.Tensor:
    """φ(A) from per-block counts of A ([k, S] → [k])."""
    cut = cut_from_counts(bs, c_a, bs.sizes - c_a, torch.zeros_like(c_a))
    return conductance_of_cut(bs, c_a, cut)


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

def khop_rows(slab: RowSlab, reach: torch.Tensor) -> torch.Tensor:
    """One BFS step over the slab's rows: row a becomes reachable when an
    entry (a, b) with σ > 0 has b in ``reach`` (bool [k, S] → [k, rows])."""
    live = slab.sigma > 0.0
    hits = torch.where(live, reach[:, slab.cols.to(torch.int64)], False).to(torch.int32)
    out = torch.zeros((reach.shape[0], slab.n_rows), dtype=torch.int32, device=reach.device)
    return out.index_add_(1, slab.rows, hits) > 0


def k_hop_sizes(bs: BlockSummary, a0: torch.Tensor, hops: np.ndarray) -> torch.Tensor:
    """|{v : dist_Ĝ(u, v) ≤ k}| for start blocks ``a0`` (int64[k]) and hop
    counts ``hops`` (host ints, [k]); float64[k].

    Every member of a block has the same adjacency, so one BFS over blocks
    answers for all its members. The first step leaves u's block (a
    self-superedge puts its *other* members at distance 1); the loop stops
    at each request's k, or earlier when nothing grows.
    """
    slab = whole_slab(bs)
    onehot = a0[:, None] == torch.arange(bs.num_blocks, device=bs.device)[None, :]
    reach = torch.zeros_like(onehot)
    hops_t = torch.as_tensor(np.asarray(hops), device=bs.device)
    for t in range(int(np.max(hops, initial=0))):
        grown = khop_rows(slab, onehot if t == 0 else reach) | reach
        grown = torch.where((t < hops_t)[:, None], grown, reach)
        if torch.equal(grown, reach):  # a fixpoint: no later step grows it
            break
        reach = grown
    return khop_counts(bs, onehot, reach)


def khop_counts(bs: BlockSummary, onehot: torch.Tensor, reach: torch.Tensor) -> torch.Tensor:
    """The k-hop sizes from the start blocks and the blocks reached ([k, S]
    each → float64[k]): u itself, and every member of a reached block but u."""
    members = bs.sizes[None, :] - onehot.to(F64)
    return 1.0 + torch.where(reach, members, 0.0).sum(-1)


def k_hop_size(res: SummaryResult, u: int, k: int,
               device: str | torch.device = "cuda") -> float:
    """|{v : dist_Ĝ(u, v) ≤ k}| — the size of u's k-hop neighborhood in the
    reconstructed graph, served from the superedge support; k = 0 is {u}."""
    bs = build_block_summary(res, device)
    a0 = bs.node2block[int(u)].to(torch.int64).reshape(1)
    return float(k_hop_sizes(bs, a0, np.array([int(k)]))[0])
