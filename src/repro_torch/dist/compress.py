"""Payload codecs and the compressed all-reduce across ranks.

Port of ``repro/dist/compress.py``. Two wire formats over trees of tensors
(a dict, or nested lists, tuples and dicts, flattened in jax's order: dict
keys sorted, sequences in order):

  * **int8**: per-leaf absmax quantization, 1 byte an element and one
    float32 scale a leaf; round half to even keeps the reconstruction within
    half a quantization step.
  * **top-k**: each leaf sends its ``ceil(ratio·n)`` largest-magnitude
    accumulated entries (value and index pairs on the wire) and keeps the
    rest in a residual that is added back next call (error feedback), so
    ``sent + residual`` is the accumulated signal exactly.

:func:`payload_bytes` prices a tree's payload under a
:class:`CompressConfig`. :func:`compressed_all_reduce` sums one tree a rank
across the ranks of a :class:`~repro_torch.core.query_engine.RankSet`
(a ``torch.distributed`` group, one rank a process, or all P ranks in one
process) through the configured format and returns the wire bytes measured
from the tensors it passed to the collectives, summed over ranks; they
equal ``P × payload_bytes``. Every sum adds the ranks' parts in rank order,
so the result does not depend on how the ranks are spread over processes
(``kind="none"`` is the backend's all-reduce and adds in its order).
"""

from __future__ import annotations

import dataclasses
import math

import torch

KINDS = ("none", "int8", "topk")


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    """Payload compression at the collective boundary."""

    kind: str = "none"  # none | int8 | topk
    topk_ratio: float = 0.05

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown compression kind {self.kind!r}")


# ---------------------------------------------------------------------------
# Trees, in jax's flatten order
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in jax's order: dict keys sorted, lists and
    tuples in order, ``None`` an empty subtree, anything else a leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [] if tree is None else [tree]


def tree_unflatten(like, leaves) -> object:
    """A tree shaped as ``like`` holding ``leaves`` in :func:`tree_leaves`'
    order."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, dict):
            built = {k: build(x[k]) for k in sorted(x)}
            return {k: built[k] for k in x}
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        return None if x is None else next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of ``rest`` (same structure)."""
    cols = [tree_leaves(t) for t in rest]
    return tree_unflatten(tree, [fn(x, *xs) for x, *xs in zip(tree_leaves(tree), *cols)])


# ---------------------------------------------------------------------------
# int8 absmax quantization
# ---------------------------------------------------------------------------


def _int8_scale(x: torch.Tensor) -> torch.Tensor:
    scale = x.to(torch.float32).abs().max() / 127.0
    return torch.where(scale > 0.0, scale, torch.ones_like(scale))


def _int8_leaf(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.to(torch.float32) / s), -127.0, 127.0).to(torch.int8)


def encode_int8(tree):
    """Quantize every leaf to int8. Returns ``(q_tree, scale_tree)``, each
    scale a float32 scalar."""
    scales = tree_map(_int8_scale, tree)
    return tree_map(_int8_leaf, tree, scales), scales


def decode_int8(q_tree, scale_tree):
    """Dequantize an :func:`encode_int8` pair back to float32 leaves."""
    return tree_map(lambda q, s: q.to(torch.float32) * s, q_tree, scale_tree)


# ---------------------------------------------------------------------------
# top-k sparsification with error feedback
# ---------------------------------------------------------------------------


def init_error_buffers(tree):
    """Zero residual buffers (float32, one a leaf) for :func:`encode_topk`."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), tree)


def _leaf_k(n: int, ratio: float) -> int:
    return max(math.ceil(ratio * n), 1)


def _topk_index(flat: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` entries of largest ``|flat|``, ties to the lower index as
    ``jax.lax.top_k`` breaks them (a stable descending sort)."""
    return torch.sort(flat.abs(), descending=True, stable=True).indices[:k]


def _topk_split(g: torch.Tensor, err: torch.Tensor, ratio: float):
    """``(flat, idx, vals)``: the accumulated signal ``g + err`` flattened,
    its top-k positions and their values in the leaf's dtype."""
    flat = (g.to(torch.float32) + err).reshape(-1)
    idx = _topk_index(flat, _leaf_k(flat.numel(), ratio))
    return flat, idx, flat[idx].to(g.dtype)


def _topk_leaf(g: torch.Tensor, err: torch.Tensor, ratio: float):
    flat, idx, vals = _topk_split(g, err, ratio)
    sent = torch.zeros_like(flat)
    sent[idx] = flat[idx]
    sent = sent.reshape(g.shape).to(g.dtype)
    # the residual against the values as sent (after the cast), so the
    # conservation holds for low-precision leaves too
    return sent, flat.reshape(g.shape) - sent.to(torch.float32)


def encode_topk(tree, err, ratio: float):
    """Send the top ``ratio`` fraction of each leaf; keep the rest as error.

    ``err`` may be None (zeros). Returns the dense zero-masked ``sent`` tree
    (the leaves' dtypes) and the new float32 residual tree; ``sent +
    residual`` equals the accumulated signal exactly.
    """
    if err is None:
        err = init_error_buffers(tree)
    pairs = [_topk_leaf(g, e, ratio) for g, e in zip(tree_leaves(tree), tree_leaves(err))]
    return (tree_unflatten(tree, [p[0] for p in pairs]),
            tree_unflatten(tree, [p[1] for p in pairs]))


# ---------------------------------------------------------------------------
# The compressed all-reduce
# ---------------------------------------------------------------------------


def _sum_none(ranks, xs: list[torch.Tensor], wire: list[int]) -> torch.Tensor:
    for h, x in enumerate(xs):
        wire[h] += x.numel() * x.element_size()
    if ranks.group is None:  # every rank in this process: add in rank order
        acc = xs[0].clone()
        for x in xs[1:]:
            acc = acc + x
        return acc
    y = xs[0].clone()
    if ranks.size > 1:
        torch.distributed.all_reduce(y, group=ranks.group.pg)
    return y


def _gather(ranks, parts: list[torch.Tensor], wire: list[int]) -> torch.Tensor:
    """The hosted ranks' parts from every rank, ``[P, ...]`` in rank order;
    counts what each hosted rank put on the wire."""
    for h, x in enumerate(parts):
        wire[h] += x.numel() * x.element_size()
    return ranks.gather(parts)


def _sum_int8(ranks, xs: list[torch.Tensor], wire: list[int]) -> torch.Tensor:
    ss = [_int8_scale(x) for x in xs]
    qs = [_int8_leaf(x, s) for x, s in zip(xs, ss)]
    qg = _gather(ranks, [q.reshape(-1) for q in qs], wire)  # [P, n] int8
    sg = _gather(ranks, [s.reshape(1) for s in ss], wire)  # [P, 1] float32
    acc = qg[0].to(torch.float32) * sg[0]
    for p in range(1, qg.shape[0]):
        acc = acc + qg[p].to(torch.float32) * sg[p]
    return acc.reshape(xs[0].shape).to(xs[0].dtype)


def _sum_topk(ranks, xs: list[torch.Tensor], es: list[torch.Tensor], ratio: float,
              wire: list[int]) -> tuple[torch.Tensor, list[torch.Tensor]]:
    vals, idxs, residuals = [], [], []
    for g, e in zip(xs, es):
        flat, idx, v = _topk_split(g, e, ratio)
        res = flat.clone()
        res[idx] = flat[idx] - v.to(torch.float32)  # top-k positions are distinct
        residuals.append(res.reshape(g.shape))
        vals.append(v)
        idxs.append(idx.to(torch.int32))
    vg = _gather(ranks, vals, wire)  # [P, k], the leaf's dtype
    ig = _gather(ranks, idxs, wire)  # [P, k] int32
    summed = torch.zeros(xs[0].numel(), dtype=torch.float32, device=xs[0].device)
    for p in range(vg.shape[0]):  # one rank's distinct positions at a time
        summed.index_add_(0, ig[p].to(torch.int64), vg[p].to(torch.float32))
    return summed.reshape(xs[0].shape).to(xs[0].dtype), residuals


def compressed_all_reduce(tree, err, config: CompressConfig, ranks):
    """Sum one tree a rank over ``ranks`` through the configured wire format.

    ``ranks`` is a :class:`~repro_torch.core.query_engine.RankSet`. Over a
    group, ``tree`` and ``err`` are this process's rank's; with every rank in
    this process, ``tree`` is a list of the P ranks' trees and ``err`` a list
    of their residual trees (or None). Every rank's tree has the same leaf
    shapes and dtypes. Returns ``(summed, new_err, wire_bytes)``: ``summed``
    the sum of every rank's contribution in the leaves' dtypes (the same on
    every rank), ``new_err`` in ``err``'s form and ``wire_bytes`` the bytes
    every rank put on the wire.

    * ``none``: an all-reduce (sum) of each leaf; ``err`` comes back as given.
    * ``int8``: each rank quantizes its leaves (:func:`encode_int8`); the
      int8 payloads and float32 scales are all-gathered, decoded and added
      in rank order.
    * ``topk``: each rank sends only its ``k`` largest accumulated entries
      as (value in the leaf's dtype, int32 index) pairs, all-gathered and
      added in float32 in rank order; the unsent rest is the rank's own new
      residual, which never leaves it (``None`` means zeros).
    """
    hosted = len(ranks.hosted)
    trees = [tree] if hosted == 1 else list(tree)
    if len(trees) != hosted:
        raise ValueError(f"{len(trees)} trees for the {hosted} ranks this process runs")
    leaves = [tree_leaves(t) for t in trees]
    if any(len(x) != len(leaves[0]) for x in leaves):
        raise ValueError("the ranks' trees hold different numbers of leaves")
    wire = [0] * hosted
    new_err = err
    if config.kind == "topk":
        errs = [err] if hosted == 1 else (list(err) if err is not None else [None] * hosted)
        err_leaves = [tree_leaves(e) if e is not None else tree_leaves(init_error_buffers(t))
                      for e, t in zip(errs, trees)]
        outs = [_sum_topk(ranks, [x[i] for x in leaves], [e[i] for e in err_leaves],
                          config.topk_ratio, wire) for i in range(len(leaves[0]))]
        summed = [o[0] for o in outs]
        res = [tree_unflatten(trees[0], [o[1][h] for o in outs]) for h in range(hosted)]
        new_err = res[0] if hosted == 1 else res
    else:
        fn = _sum_none if config.kind == "none" else _sum_int8
        summed = [fn(ranks, [x[i] for x in leaves], wire) for i in range(len(leaves[0]))]
    return tree_unflatten(trees[0], summed), new_err, ranks.total(wire)


# ---------------------------------------------------------------------------
# Wire-size accounting
# ---------------------------------------------------------------------------


def payload_bytes(tree, config: CompressConfig) -> float:
    """Bytes on the wire for one rank's all-reduce payload of ``tree``."""
    total = 0.0
    for leaf in tree_leaves(tree):
        n = float(leaf.numel())
        if config.kind == "none":
            total += n * leaf.element_size()
        elif config.kind == "int8":
            total += n + 4.0  # 1 B an element and one float32 scale a leaf
        else:  # topk: (value in the leaf's dtype, int32 index) an entry
            total += _leaf_k(leaf.numel(), config.topk_ratio) * (leaf.element_size() + 4.0)
    return total
