"""Data-parallel training across the ranks of a ``torch.distributed`` group.

The reference's trainer shards the global batch over the mesh's ``data``
axis and lets GSPMD partition one logical program, so every quantity of
its step is the single-device step's on the global batch. The port runs
one process a rank. :class:`DataParallel` holds what a rank needs to give
that step:

  * which rows of a global batch it holds at an accumulation count
    (:meth:`DataParallel.rows`): microbatch ``i`` is the global rows
    ``[i·B/a, (i+1)·B/a)`` (``dist/microbatch.py``'s split), and rank ``r``
    holds its ``r``-th contiguous part, so the ranks in rank order hold each
    microbatch's tokens in global order;
  * the exact mean over the ranks, added in rank order (:meth:`DataParallel.mean`;
    ``dist/fsdp.py`` takes each rank's shard of the gradients' mean through
    :meth:`DataParallel.exchange`), the same bits on every rank and run
    after run (gloo's all-reduce at 4 ranks does not add in rank order);
  * the sums and gathers the MoE block needs for the global capacity, slots
    and load-balance loss (``models/moe.py``).

Where ``P`` does not divide a microbatch, the reference's shape-aware rule
(``MeshRules``: a mesh axis that does not divide a dimension is dropped
from it) replicates the batch, and its step is the single-device step: then
every rank takes the whole batch and no collective is needed
(:meth:`DataParallel.shards` is False). A world of one, with or without an
initialised group, does no collective work.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def add_in_order(parts) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, left to right."""
    acc = parts[0]
    for x in parts[1:]:
        acc = acc + x
    return acc


class DataParallel:
    """The ranks of ``group`` (default: the default group; a world of one
    when none is initialised), this process running its own."""

    def __init__(self, device: str | torch.device, group=None):
        self.device = torch.device(device)
        self.pg = group
        active = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank(group) if active else 0
        self.size = dist.get_world_size(group) if active else 1

    def shards(self, batch: int, accum: int) -> bool:
        """Whether each rank holds its own rows of a ``batch``-row step
        split into ``accum`` microbatches: more than one rank, and the ranks
        divide every microbatch."""
        return self.size > 1 and batch % (accum * self.size) == 0

    def rows(self, batch: int, accum: int) -> np.ndarray:
        """The global rows this rank holds, microbatch after microbatch:
        ``[i·B/a + r·B/(aP), i·B/a + (r+1)·B/(aP))`` for ``i < a``, so
        ``microbatch_grads``' split of the local batch gives microbatch
        ``i``'s part. Every row when the ranks do not shard."""
        if not self.shards(batch, accum):
            return np.arange(batch)
        micro = batch // accum
        per = micro // self.size
        starts = np.arange(accum)[:, None] * micro + self.rank * per
        return (starts + np.arange(per)[None, :]).reshape(-1)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (one shape on every rank), stacked in rank
        order: ``[P, ...]``."""
        if self.size == 1:
            return x[None]
        out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, x.contiguous()[None], group=self.pg)
        return out

    def exchange(self, chunks: torch.Tensor) -> torch.Tensor:
        """``chunks[j]`` goes to rank ``j``; row ``j`` of the result came
        from rank ``j`` (``all_to_all_single`` over dim 0)."""
        if self.size == 1:
            return chunks
        out = torch.empty_like(chunks)
        dist.all_to_all_single(out, chunks.contiguous(), group=self.pg)
        return out

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` added in rank order: exact for integers, the
        same bits on every rank for floats."""
        return x if self.size == 1 else add_in_order(self.gather(x).unbind(0))

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`sum` over the number of ranks (a true division)."""
        if self.size == 1:
            return x
        return self.sum(x) / torch.full((), self.size, dtype=x.dtype, device=x.device)

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.pg)
