"""FSDP's sharded parameter storage, by the trainer's rule table.

The reference's trainer places every parameter leaf, and its AdamW moments
with it, by ``make_rules(mesh, "train")``: the ``embed`` dimension split
over the data axes, the tensor-parallel dimensions over ``model``, a mesh
axis dropped where it does not divide (``dist/sharding.py``). GSPMD gathers
a leaf where it is used and reduce-scatters its gradient. The port stores
the same shard on every rank (rank ``r`` is the reference's device at
position ``r`` of the plan's mesh) and writes the collectives out, leaf by
leaf (:class:`Sharded`):

  * :meth:`Sharded.shard`: a global tree to this rank's shards;
  * :meth:`Sharded.views`: the shards gathered over the data ranks (an
    all-gather, concatenated in rank order), which is what this model rank
    computes with (``dist/tensor_parallel.py`` gathers over the model ranks
    where a layer needs more);
  * :meth:`Sharded.reduce`: a gradient of those views to this rank's shard
    of the exact mean over the data ranks, added in rank order: an
    all-to-all of shard-sized chunks, so no rank holds every rank's
    gradient;
  * :meth:`Sharded.full`: shards to global leaves on every rank (the
    compressed all-reduce);
  * :meth:`Sharded.full_to_host`: shards to global leaves in one rank's
    host memory, one leaf at a time (checkpoints, the trainer's returned
    state), so no device holds more than its shards and one leaf's parts.

A leaf whose split the table drops is stored whole on the ranks it is not
split over. In a world of one every shard is its global leaf, and nothing
is copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.dist.compress import tree_leaves, tree_unflatten
from repro_torch.dist.data_parallel import add_in_order


def _part_index(coords: dict, sizes: dict, kept: tuple) -> int:
    """The index of a rank's part along a dimension split over the mesh
    axes ``kept``, row-major over them."""
    idx = 0
    for ax in kept:
        idx = idx * sizes[ax] + coords[ax]
    return idx


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """Where one leaf of global ``shape`` lives on this rank."""

    shape: tuple
    spec: tuple  # the mesh axes each dimension is split over
    data_dim: int | None  # the dimension split over the data axes
    data_parts: int
    data_index: int  # this rank's part along ``data_dim``
    member_parts: tuple  # the part each rank of this rank's data group holds
    model_dim: int | None
    model_parts: int
    model_index: int
    owner: bool  # the first rank (in rank order) to hold this shard

    def slices(self) -> list:
        out = [slice(None)] * len(self.shape)
        for dim, parts, idx in ((self.data_dim, self.data_parts, self.data_index),
                                (self.model_dim, self.model_parts, self.model_index)):
            if dim is not None:
                per = self.shape[dim] // parts
                out[dim] = slice(idx * per, (idx + 1) * per)
        return out


class Sharded:
    """The shards of one parameter tree on rank ``rank`` of ``rules``.

    ``shapes``/``axes``: the global shape and the logical axes of every
    leaf (``models/api.py::param_shapes``/``param_axes``). ``data``: this
    rank's data group (a :class:`~repro_torch.dist.data_parallel.DataParallel`
    of the ranks with its model coordinate), ``model``: its model group
    (a :class:`~repro_torch.dist.tensor_parallel.TensorParallel`)."""

    def __init__(self, rules, rank: int, shapes, axes, data, model):
        self.rules, self.rank, self.data, self.model = rules, rank, data, model
        self._shapes = [tuple(s) for s in _dict_leaves(shapes)]
        self._axes = _dict_leaves(axes)
        self.layouts = self.layouts_of(rank)

    def layouts_of(self, rank: int) -> list:
        """Every leaf's :class:`LeafLayout` on rank ``rank`` of the plan."""
        rules = self.rules
        coords, sizes = rules.coords(rank), rules.sizes
        dp_axes = tuple(a for a in rules.axes if a != "model")
        # the data group's ranks, in rank order: every (pod, data) coordinate
        n_dp = int(np.prod([sizes[a] for a in dp_axes])) if dp_axes else 1
        members = []
        for j in range(n_dp):
            c, rest = {}, j
            for ax in reversed(dp_axes):
                rest, c[ax] = divmod(rest, sizes[ax])
            members.append(c)
        layouts = []
        for shape, ax in zip(self._shapes, self._axes):
            spec = rules.spec(ax, shape)
            data_dim = model_dim = None
            data_kept = ()
            for i, kept in enumerate(spec):
                if "model" in kept:
                    model_dim = i
                dkept = tuple(a for a in kept if a != "model")
                if dkept:
                    data_dim, data_kept = i, dkept
            used = {a for kept in spec for a in kept}
            layouts.append(LeafLayout(
                shape=shape, spec=spec, data_dim=data_dim,
                data_parts=int(np.prod([sizes[a] for a in data_kept])) if data_kept else 1,
                data_index=_part_index(coords, sizes, data_kept),
                member_parts=tuple(_part_index(c, sizes, data_kept) for c in members),
                model_dim=model_dim, model_parts=sizes["model"] if model_dim is not None else 1,
                model_index=coords.get("model", 0) if model_dim is not None else 0,
                owner=all(coords[a] == 0 for a in rules.axes if a not in used)))
        return layouts

    @property
    def trivial(self) -> bool:
        """A world of one: every shard is its global leaf."""
        return self.rules.n_ranks == 1

    # ------------------------------------------------------------- storage
    def shard(self, tree, device=None):
        """This rank's shard of every leaf of a global tree (a copy, so the
        global tree can go). ``device``: copy each shard there (a tree in
        host memory, read leaf by leaf; in a world of one each whole leaf is
        copied), else the shards stay where the leaves are."""
        if device is not None:
            return self._map(lambda x, lay: x[tuple(lay.slices())].to(device, copy=True), tree)
        if self.trivial:
            return tree
        return self._map(lambda x, lay: x[tuple(lay.slices())].clone(), tree)

    def views(self, shards):
        """The shards gathered over the data ranks, concatenated in rank
        order along each leaf's data dimension: this model rank's view."""
        def one(x, lay):
            if lay.data_parts == 1:
                return x
            parts = self.data.gather(x)
            return torch.cat([parts[lay.member_parts.index(i)] for i in range(lay.data_parts)],
                             dim=lay.data_dim)
        return self._map(one, shards)

    def full(self, shards):
        """The global leaves, on every rank's device (the compressed
        all-reduce takes the whole gradient)."""
        if self.trivial:
            return shards

        def one(x, lay):
            if lay.model_parts == 1:
                return x
            return torch.cat(self.model.gather(x).unbind(0), dim=lay.model_dim)
        return self._map(one, self.views(shards))

    def full_to_host(self, shards, dst: int = 0):
        """The global leaves in host memory on rank ``dst``, None on every
        other rank, one leaf at a time: every rank sends its shard of a leaf
        to ``dst`` (a gather over the default group), which copies one part
        of each shard into the whole leaf in host memory and frees the parts
        before the next leaf. No rank holds a whole leaf on its device. In a
        world of one, the shards themselves (no copy)."""
        if self.trivial:
            return shards
        dist = torch.distributed
        world = dist.get_world_size()
        if world != self.rules.n_ranks:
            raise ValueError(f"a plan of {self.rules.n_ranks} ranks in a group of {world}")
        main = self.rank == dst
        ranks = [self.layouts_of(r) for r in range(world)] if main else None

        def one(i, x):
            parts = [torch.empty_like(x) for _ in range(world)] if main else None
            dist.gather(x.contiguous(), parts, dst=dst)
            if not main:
                return None
            host = torch.empty(self._shapes[i], dtype=x.dtype)
            seen = set()
            for r, part in enumerate(parts):
                lay = ranks[r][i]
                if (lay.data_index, lay.model_index) not in seen:
                    seen.add((lay.data_index, lay.model_index))
                    host[tuple(lay.slices())].copy_(part)
            return host

        leaves = [one(i, x) for i, x in enumerate(self._leaves(shards))]
        return tree_unflatten(shards, leaves) if main else None

    def reduce(self, grads, mean: bool = True):
        """This rank's shard of the gradient of its views: with ``mean``
        (the data ranks hold different rows) the exact mean over the data
        ranks, added in rank order, else its own part (every data rank holds
        the same gradient)."""
        d = self.data

        def one(g, lay):
            if lay.data_parts == 1:
                return d.mean(g) if mean else g
            chunks = g.chunk(lay.data_parts, dim=lay.data_dim)
            if not mean:
                return chunks[lay.data_index].contiguous()
            sent = torch.stack([chunks[p] for p in lay.member_parts])
            got = d.exchange(sent)
            return add_in_order(got.unbind(0)) / torch.full((), d.size, dtype=g.dtype,
                                                             device=g.device)
        return self._map(one, grads)

    # ------------------------------------------------------------- accounting
    def owners(self) -> list[bool]:
        """Per leaf (tree order), whether this rank is the first to hold its
        shard: the global norm counts each shard once."""
        return [lay.owner for lay in self.layouts]

    def stored_bytes(self, shards) -> int:
        """The bytes this rank stores: its parameter shards and two float32
        AdamW moments of each."""
        return sum(int(x.numel()) * (x.element_size() + 8) for x in tree_leaves(shards))

    def local_shapes(self) -> list:
        """The shape of this rank's shard of every leaf, in tree order."""
        return [tuple(len(range(*sl.indices(n))) for sl, n in zip(lay.slices(), lay.shape))
                for lay in self.layouts]

    def _leaves(self, tree) -> list:
        leaves = tree_leaves(tree)
        if len(leaves) != len(self.layouts):
            raise ValueError(f"{len(leaves)} leaves against a layout of {len(self.layouts)}")
        return leaves

    def _map(self, fn, tree):
        leaves = self._leaves(tree)
        return tree_unflatten(tree, [fn(x, lay) for x, lay in zip(leaves, self.layouts)])


def _dict_leaves(tree) -> list:
    """The leaves of a tree of shapes or of logical axes, in
    :func:`tree_leaves`' order (a tuple is a leaf here, not a subtree)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _dict_leaves(tree[k])]
    return [tuple(tree)]
