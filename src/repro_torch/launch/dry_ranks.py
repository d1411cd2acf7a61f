"""Ranks that count instead of communicate: one rank's step traced alone.

The dry-run (``launch/dryrun.py``) runs one rank's real step, the port's
own code, with its groups replaced by these stand-ins. Each holds a plan's
``rank`` and ``size`` and no process group, as ``models/tp_ranks.py``'s
``ThreadRank`` does, and records every collective it is asked for in a
:class:`CollectiveLog`: the op kind, the shape and dtype of what it returns,
its bytes and the group's axis (``data``, ``model`` or ``world``) with the
global ranks it spans (the link it crosses, ``launch/costs.py``).

What a collective returns has the right shape and dtype and no values:
``gather`` gives ``[P, ...]``, ``exchange``/``all_to_all`` a tensor of the
input's shape, made with ``torch.empty`` on the input's device (on
``meta``, nothing at all); the real group's local copies and casts around
the call (``contiguous``, ``clone``, bools as int32) are made as it makes
them. ``barrier`` does nothing. So a
step traced over these ranks is the step one rank of the plan runs, with
every collective where the port issues it: the sums written as an
all-gather plus adds in rank order (``dist/data_parallel.py``), the
Megatron-style copies and reductions of ``dist/tensor_parallel.py``, the
FSDP gathers and all-to-alls of ``dist/fsdp.py``, the MoE block's global
counts (``models/moe.py``) and the edge-sharded round's exchange
(``core/distributed.py``). A world of one does no collective work, as the
real groups' do not.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.core.distributed import RankGroup
from repro_torch.dist.data_parallel import DataParallel
from repro_torch.dist.tensor_parallel import TensorParallel


def nbytes(x: torch.Tensor) -> int:
    return int(x.numel()) * x.element_size()


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective as this rank issues it. ``bytes``: what it returns on
    this rank (the reference's parser reads the result shapes too)."""

    op: str  # all-gather | all-to-all | all-reduce | barrier
    shape: tuple
    dtype: str
    bytes: int
    axis: str  # data | model | world
    ranks: tuple  # the global ranks of the group, in rank order
    reduces: str = ""  # "sum" or "max": an all-reduce written as this all-gather


class CollectiveLog:
    """Every collective of a traced step, in the order issued."""

    def __init__(self):
        self.calls: list[Collective] = []

    def record(self, op: str, out: torch.Tensor | None, axis: str, ranks: tuple,
               reduces: str = "") -> None:
        shape = () if out is None else tuple(out.shape)
        dtype = "" if out is None else str(out.dtype).replace("torch.", "")
        self.calls.append(Collective(op, shape, dtype, 0 if out is None else nbytes(out),
                                     axis, tuple(ranks), reduces))

    def reductions(self) -> dict:
        """The all-reduces the port writes as an all-gather plus adds in
        rank order (``DataParallel.sum``/``max``): their calls, the bytes
        they gather (P parts) and the bytes a ring all-reduce of the same
        values would move (2 × one part, the parser's factor)."""
        calls = [c for c in self.calls if c.reduces]
        return {"calls": len(calls), "gathered_bytes": sum(c.bytes for c in calls),
                "ring_all_reduce_bytes": sum(2 * c.bytes // len(c.ranks) for c in calls)}

    def clear(self) -> None:
        self.calls.clear()

    def grouped(self) -> list[dict]:
        """The calls grouped by op, shape, dtype and group, largest total
        first: ``[{"op", "shape", "dtype", "axis", "ranks", "reduces",
        "count", "bytes"}]`` with ``bytes`` the group's total (``count``
        calls), ``ranks`` the group's global ranks (the links it crosses)
        and ``reduces`` the reduction a gather stands for."""
        agg = collections.OrderedDict()
        for c in self.calls:
            key = (c.op, c.shape, c.dtype, c.axis, c.ranks, c.reduces)
            n, b = agg.get(key, (0, 0))
            agg[key] = (n + 1, b + c.bytes)
        rows = [{"op": k[0], "shape": list(k[1]), "dtype": k[2], "axis": k[3],
                 "ranks": list(k[4]), "reduces": k[5], "count": n, "bytes": b}
                for k, (n, b) in agg.items()]
        return sorted(rows, key=lambda r: -r["bytes"])


class _Counting:
    """The collectives of a counting rank: the shapes a real group returns,
    recorded in ``self.log``."""

    log: CollectiveLog
    axis: str
    members: tuple
    _reducing = ""

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x[None]
        out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        x.contiguous()  # the real group's local copy, where there is one
        self.log.record("all-gather", out, self.axis, self.members, self._reducing)
        return out

    def _reduce(self, kind: str, fn, x):
        self._reducing = kind
        try:
            return fn(x)
        finally:
            self._reducing = ""

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce("sum", super().sum, x)

    def exchange(self, chunks: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return chunks
        out = torch.empty_like(chunks)
        chunks.contiguous()
        self.log.record("all-to-all", out, self.axis, self.members)
        return out

    def barrier(self) -> None:
        if self.size > 1:
            self.log.record("barrier", None, self.axis, self.members)


class CountingData(_Counting, DataParallel):
    """A :class:`~repro_torch.dist.data_parallel.DataParallel` group of the
    global ranks ``members``, this process rank ``rank`` of it."""

    def __init__(self, device, rank: int, members, log: CollectiveLog, axis: str = "data"):
        self.device, self.pg = torch.device(device), None
        self.rank, self.size = rank, len(members)
        self.members, self.log, self.axis = tuple(members), log, axis


class CountingModel(_Counting, TensorParallel):
    """A :class:`~repro_torch.dist.tensor_parallel.TensorParallel` group of
    the global ranks ``members`` under the rule table ``rules``."""

    def __init__(self, device, rank: int, members, log: CollectiveLog, rules,
                 axis: str = "model"):
        self.device, self.pg, self.rules = torch.device(device), None, rules
        self.rank, self.size = rank, len(members)
        self.members, self.log, self.axis = tuple(members), log, axis

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce("max", super().max, x)


class CountingRankGroup(RankGroup):
    """The edge-sharded backend's :class:`~repro_torch.core.distributed.RankGroup`
    as rank ``rank`` of ``size``: ``all_reduce`` (sum, max, min),
    ``all_gather`` (tiled on dim 0) and ``all_to_all``, counted."""

    def __init__(self, device, rank: int, size: int, log: CollectiveLog):
        self.device, self.pg = torch.device(device), None
        self.active, self.backend = size > 1, None
        self.rank, self.size, self.log = rank, size, log
        self.members = tuple(range(size))

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        if self.size == 1:
            return x
        if op not in ("sum", "max", "min"):
            raise ValueError(f"unknown reduction {op!r}")
        y = x.to(torch.int32) if x.dtype == torch.bool else x.clone()
        self.log.record("all-reduce", y, "world", self.members)
        return y.to(x.dtype)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x
        src = x.to(torch.int32) if x.dtype == torch.bool else x.contiguous()
        out = torch.empty((self.size * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        self.log.record("all-gather", out, "world", self.members)
        return out.to(x.dtype)

    def all_to_all(self, buck: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return buck
        out = torch.empty_like(buck)
        buck.contiguous()
        self.log.record("all-to-all", out, "world", self.members)
        return out


def plan_members(rules, rank: int) -> tuple[tuple, tuple]:
    """The global ranks of rank ``rank``'s data group (its model coordinate,
    every (pod, data) coordinate, in rank order) and of its model group
    (its data coordinates, every model coordinate), as
    ``launch/mesh.py::mesh_groups`` enumerates them: rank ``r`` is ``(d, m)
    = divmod(r, model)``."""
    n, m = rules.n_ranks, rules.sizes.get("model", 1)
    d, i = divmod(rank, m)
    return tuple(j * m + i for j in range(n // m)), tuple(d * m + k for k in range(m))


def counting_groups(rules, rank: int, device, log: CollectiveLog):
    """``(data, model, world)``: rank ``rank``'s counting groups on the plan
    of ``rules``, the stand-ins for ``mesh_groups`` and the trainer's world."""
    data, model = plan_members(rules, rank)
    dp = CountingData(device, data.index(rank), data, log, "data")
    tp = CountingModel(device, model.index(rank), model, log, rules, "model")
    world = CountingData(device, rank, range(rules.n_ranks), log, "world")
    return dp, tp, world
