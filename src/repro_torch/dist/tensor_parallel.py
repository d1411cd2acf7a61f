"""Tensor parallelism: the model group's collectives as autograd functions.

The reference shards the LM's dense layers over its mesh's ``model`` axis
(``make_rules(mesh, "train")``, ``dist/sharding.py``) and lets GSPMD
insert the collectives. The port runs one process a rank, so a model rank
computes its part of each tensor-parallel layer and the collectives are
written out, Megatron's way:

  * :meth:`TensorParallel.copy`: identity forward, the sum over the group
    backward (the input of a layer whose ranks compute different parts);
  * :meth:`TensorParallel.reduce`: the sum over the group forward, identity
    backward (the partial outputs of such a layer);
  * :meth:`TensorParallel.gather_dim`: the parts of a tensor split along a
    dimension, concatenated in rank order; its backward takes this rank's
    part of the gradient (the consumer is the same on every rank) or the
    sum over the ranks of that part (a reduce-scatter: the ranks consumed
    different parts);
  * :meth:`TensorParallel.scatter`: this rank's part forward, the parts
    gathered backward;
  * :meth:`TensorParallel.all_reduce`: the sum over the group forward and
    backward (a statistic of a split dimension that every rank then
    consumes differently, such as an RMSNorm's sum of squares).

Every sum adds the ranks' values in rank order (an all-gather, then the
adds), so every rank holds the same bits, run after run. :meth:`take` turns
a leaf as the rule table stores it into what a rank's part of a layer
reads, :meth:`take_index` reads it at chosen indices (columns the table's
contiguous split cuts across), and :meth:`read` does either for each leaf of
a block by a map the block's module gives (``models/tp_ranks.py`` reads the
same maps off whole leaves). A group of one does no collective work.
"""

from __future__ import annotations

import torch

from repro_torch.dist.data_parallel import DataParallel, add_in_order


class TensorParallel(DataParallel):
    """The model ranks of one data rank: the ranks of ``group`` (a
    ``torch.distributed`` process group; a world of one without one), this
    process running its own. ``rules``
    (:class:`~repro_torch.dist.sharding.Rules`) says where each leaf is
    stored split (:meth:`take`)."""

    def __init__(self, device, group=None, rules=None):
        super().__init__(device, group)
        self.rules = rules

    def splits(self, n: int) -> bool:
        """Whether ``n`` (heads, ff, vocab, experts) splits over the ranks."""
        return self.size > 1 and n % self.size == 0

    def part(self, n: int) -> tuple[int, int]:
        """This rank's ``[start, stop)`` of a dimension of ``n`` split over the ranks."""
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    # ------------------------------------------------------------ collectives
    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the ranks, detached."""
        x = x.detach()
        return x if self.size == 1 else self.gather(x).amax(dim=0)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _Copy.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _Reduce.apply(x, self)

    def gather_dim(self, x: torch.Tensor, dim: int, reduce_grad: bool = False) -> torch.Tensor:
        return x if self.size == 1 else _Gather.apply(x, self, dim, reduce_grad)

    def scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x if self.size == 1 else _Scatter.apply(x, self, dim)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks, added in rank order; its gradient is
        summed over the ranks too, since each rank consumes the sum in its
        own part of a layer."""
        return self.reduce(self.copy(x))

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's part along ``dim`` of the sum over the ranks of ``x``,
        added in rank order (no autograd)."""
        if self.size == 1:
            return x
        chunks = torch.stack(x.chunk(self.size, dim=dim))
        return add_in_order(self.exchange(chunks).unbind(0))

    # ----------------------------------------------------------------- leaves
    def take(self, view: torch.Tensor, axes, shape, compute_dim: int | None,
             partial: bool = True) -> torch.Tensor:
        """What this rank's part of a layer reads of a leaf of logical
        ``axes`` and global ``shape``, from ``view``, the leaf as the rule
        table stores it on this model rank (gathered over the data ranks).

        ``compute_dim``: the dimension whose part this rank computes with
        (None: the whole leaf). ``partial``: the ranks' computations differ
        (inside a tensor-parallel layer), so a leaf read whole or through
        another dimension's gather has its gradient summed over the ranks;
        otherwise every rank computes the same and keeps its own part."""
        if self.size == 1:
            return view
        stored = self.rules.split_dim(axes, shape, "model")
        if not partial:
            if compute_dim is not None:
                raise ValueError("a replicated computation reads whole leaves")
            return view if stored is None else self.gather_dim(view, stored)
        if compute_dim is not None and compute_dim == stored:
            return view
        whole = self.copy(view) if stored is None else self.gather_dim(view, stored, True)
        if compute_dim is None:
            return whole
        start, stop = self.part(shape[compute_dim])
        return whole.narrow(compute_dim, start, stop - start)

    def whole(self, p: dict, axes: dict, shapes: dict) -> dict:
        """Every leaf of a block (a dict tree, with its trees of logical
        axes and global shapes) whole, for a computation every model rank
        does alike: each keeps its own part of each gradient."""
        return {k: self.whole(v, axes[k], shapes[k]) if isinstance(v, dict)
                else self.take(v, axes[k], shapes[k], None, partial=False)
                for k, v in p.items()}

    def take_index(self, view: torch.Tensor, axes, shape, dim: int,
                   index: torch.Tensor) -> torch.Tensor:
        """The entries at ``index`` (distinct) along ``dim`` of a leaf of
        logical ``axes`` and global ``shape``, from ``view`` as :meth:`take`
        gets it: the stored split gathered whole, ``index_select``, and the
        whole leaf freed before the layer's products. The gradient is put
        back at ``index`` and reduce-scattered in rank order (summed over
        the ranks where the leaf is stored whole), so entries that several
        ranks read get the sum of their gradients."""
        if self.size == 1:
            return view.index_select(dim, index)
        return _TakeIndex.apply(view, self, self.rules.split_dim(axes, shape, "model"), dim,
                                index)

    def read(self, p: dict, axes: dict, shapes: dict, reads: dict) -> dict:
        """The leaves of a block as this rank reads them. ``reads`` maps a
        key to the dimension of the leaf whose part this rank computes with
        (an int, :meth:`take`), to ``(dim, index)`` (:meth:`take_index`) or
        to a dict of the same kind for a subtree (a norm); ``axes`` and
        ``shapes`` are the block's trees of logical axes and global shapes."""
        out = {}
        for k, how in reads.items():
            if isinstance(how, dict):
                out[k] = self.read(p[k], axes[k], shapes[k], how)
            elif isinstance(how, tuple):
                out[k] = self.take_index(p[k], axes[k], shapes[k], *how)
            else:
                out[k] = self.take(p[k], axes[k], shapes[k], how)
        return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.sum(g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim, reduce_grad):
        ctx.tp, ctx.dim, ctx.reduce_grad = tp, dim, reduce_grad
        return torch.cat(tp.gather(x).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        tp, dim = ctx.tp, ctx.dim
        if ctx.reduce_grad:
            return tp.reduce_scatter(g, dim), None, None, None
        start, stop = tp.part(g.shape[dim])
        return g.narrow(dim, start, stop - start).contiguous(), None, None, None


class _TakeIndex(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, stored, dim, index):
        ctx.tp, ctx.stored, ctx.dim = tp, stored, dim
        whole = x if stored is None else torch.cat(tp.gather(x).unbind(0), dim=stored)
        ctx.shape = whole.shape
        ctx.save_for_backward(index)
        return whole.index_select(dim, index)

    @staticmethod
    def backward(ctx, g):
        tp, stored = ctx.tp, ctx.stored
        (index,) = ctx.saved_tensors
        whole = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        whole.index_copy_(ctx.dim, index, g)
        gx = tp.sum(whole) if stored is None else tp.reduce_scatter(whole, stored)
        return gx, None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        start, stop = tp.part(x.shape[dim])
        return x.narrow(dim, start, stop - start).contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(ctx.tp.gather(g).unbind(0), dim=ctx.dim), None, None
