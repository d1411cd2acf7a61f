"""Supernode ownership for the edge-sharded backend, and the trainer's and
the server's rule tables.

Port of ``repro/dist/sharding.py``'s ``owner_hash_np`` and ``MeshRules.owner``,
and of its ``"train"`` and ``"serve"`` tables (:func:`make_rules`, :class:`Rules`).
In ``"summarize"`` mode the reference splits the edge dimension over every
mesh axis (``MeshRules.edge_spec``), so device ``d``'s shard is the ``d``-th
contiguous block, where ``d`` is ``jax.lax.axis_index`` over all axes. A flat
group of P ranks has the same layout with rank ``r`` in place of ``d``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Knuth's multiplicative constant, the reference's OWNER_HASH_MULT.
OWNER_HASH_MULT = 2654435761
_U32 = 0xFFFFFFFF


def owner_hash(ids: torch.Tensor, salt: int, n_ranks: int) -> torch.Tensor:
    """Rank owning supernode ``ids`` for this round's ``salt``, int64.

    The reference's uint32 arithmetic, ``x = (id·MULT mod 2³²) ^ salt;
    x ^= x >> 16; x mod P``, carried out in int64 with explicit wrap-around.
    """
    x = ((ids.to(torch.int64) & _U32) * OWNER_HASH_MULT) & _U32
    x = x ^ (int(salt) & _U32)
    x = (x >> 16) ^ x
    return x % max(1, int(n_ranks))


# ---------------------------------------------------------------------------
# The rule tables (the reference's ``make_rules(mesh, "train" | "serve")``)
# ---------------------------------------------------------------------------
#
# Port of ``_mode_table``'s ``"train"`` and ``"serve"`` entries, the override-free
# ``make_rules`` and ``MeshRules.spec``'s shape-aware assignment, on a
# ``MeshPlan`` (``runtime/elastic.py``) instead of a jax mesh. Rank ``r`` is
# the reference's device at position ``r`` of the plan's mesh in row-major
# order: ``(d, m) = divmod(r, model)``, or ``(p, d, m)`` with a pod axis.

#: tensor-parallel dimensions, split over ``model``
TP_AXES = ("ff", "heads", "kv_heads", "vocab", "experts", "attn_embed")
#: every logical name the reference's tables define
LOGICAL = TP_AXES + ("batch", "seq", "kvseq", "embed", "act_embed", "edges")
MODES = ("train", "serve")


@dataclasses.dataclass(frozen=True)
class Rules:
    """A logical-name → mesh-axes table bound to one plan."""

    shape: tuple  # the plan's mesh shape
    axes: tuple  # its axis names, e.g. ("data", "model")
    table: dict  # logical name -> tuple of mesh axes (empty: replicated)

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axes, self.shape))

    @property
    def n_ranks(self) -> int:
        return int(np.prod(self.shape))

    def coords(self, rank: int) -> dict:
        """Rank ``rank``'s coordinate on each mesh axis (row-major)."""
        out = {}
        for ax, n in zip(reversed(self.axes), reversed(self.shape)):
            rank, out[ax] = divmod(rank, n)
        return out

    def spec(self, logical_axes, shape) -> tuple:
        """The mesh axes each dimension of a ``shape`` leaf is split over:
        the reference's ``MeshRules.spec`` with its divisibility guard. An
        axis is dropped from a dimension when it does not divide it (with
        the axes kept before it) or an earlier dimension took it."""
        if len(logical_axes) != len(shape):
            raise ValueError(f"axes {logical_axes} do not match shape {shape}")
        used, out = set(), []
        for name, dim in zip(logical_axes, shape):
            if name is not None and name not in self.table:
                raise KeyError(f"unknown logical axis {name!r}; known: {sorted(self.table)}")
            kept, prod = [], 1
            for ax in self.table.get(name, ()) if name is not None else ():
                size = self.sizes.get(ax)
                if ax in used or size is None or dim % (prod * size):
                    continue
                kept.append(ax)
                used.add(ax)
                prod *= size
            out.append(tuple(kept))
        return tuple(out)

    def block(self, rank: int, name: str, n: int) -> tuple[int, int]:
        """Rank ``rank``'s ``[start, stop)`` of a dimension of ``n`` named
        ``name`` (all of it where the table does not split it)."""
        coords, idx, parts = self.coords(rank), 0, 1
        for ax in self.spec((name,), (n,))[0]:
            idx = idx * self.sizes[ax] + coords[ax]
            parts *= self.sizes[ax]
        per = n // parts
        return idx * per, (idx + 1) * per

    def split_dim(self, logical_axes, shape, axis: str = "model") -> int | None:
        """The dimension of a ``shape`` leaf split over ``axis`` (None: none)."""
        for i, kept in enumerate(self.spec(logical_axes, shape)):
            if axis in kept:
                return i
        return None


def _validate_override(plan, key: str, val) -> None:
    """An override must name axes of *this* plan (or be None): the
    reference's ``_validate_override``, with its error types. Without it a
    mistyped axis would replicate the dimension silently (:meth:`Rules.spec`
    drops axes it does not know)."""
    if val is None:
        return
    if isinstance(val, str):
        axes = (val,)
    elif isinstance(val, (tuple, list)):
        axes = tuple(val)
    else:
        raise ValueError(
            f"override {key!r}={val!r}: expected a mesh axis name, a "
            f"tuple of names, or None; got {type(val).__name__}")
    plan_axes = tuple(plan.axes)
    for ax in axes:
        if not isinstance(ax, str) or ax not in plan_axes:
            raise ValueError(
                f"override {key!r}={val!r}: {ax!r} is not an axis of this "
                f"mesh; mesh axes: {plan_axes}")
    if len(set(axes)) != len(axes):
        raise ValueError(f"override {key!r}={val!r} names a mesh axis more than once")


def make_rules(plan, mode: str = "train", overrides=None) -> Rules:
    """The rule table of ``plan`` (a :class:`~repro_torch.runtime.MeshPlan`)
    in ``mode``. Both modes put the batch over ``(pod, data)`` and the
    tensor-parallel dimensions over ``model``. ``"train"`` adds FSDP: the
    ``embed`` parameter dimension over the data axes. ``"serve"`` keeps the
    parameters whole on the data axes and puts ``seq`` and ``kvseq`` over
    ``model`` (a KV cache split on its positions: flash-decoding). The
    summarize and eval tables have no sharded user in the port.

    ``overrides`` remaps single logical names (a mesh axis name, a tuple of
    names, or None to replicate): the dry-run's ``--variant`` knobs. Unknown
    names raise ``KeyError``, axes not of the plan ``ValueError``, as the
    reference's ``make_rules`` does."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the port has {MODES}")
    dp = tuple(a for a in ("pod", "data") if a in plan.axes)
    tp = ("model",) if "model" in plan.axes else ()
    table = {name: () for name in LOGICAL}
    table.update({name: tp for name in TP_AXES})
    table["batch"] = dp
    if mode == "train":
        table["embed"] = dp
    else:
        table["seq"] = tp
        table["kvseq"] = tp
    for key, val in (overrides or {}).items():
        if key not in table:
            raise KeyError(f"unknown logical axis {key!r}; known: {sorted(table)}")
        _validate_override(plan, key, val)
        table[key] = () if val is None else (val,) if isinstance(val, str) else tuple(val)
    return Rules(shape=tuple(plan.shape), axes=tuple(plan.axes), table=table)
