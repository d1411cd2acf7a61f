"""AdamW with decoupled weight decay, global-norm clipping, cosine schedule.

Port of ``repro/optim/adamw.py``. Moments are float32 whatever the
parameter's type; the update is computed in float32 and cast back. Every
constant enters as the reference's ``jnp`` arithmetic has it: a Python
float is rounded to float32 where it meets a float32 array (Python-level
arithmetic between constants stays float64, as it does there), and the
schedule works on a float32 tensor step. Constants that divide are float32
tensors, not Python numbers: on the card a Python divisor becomes a
product with its reciprocal. The state trees mirror the parameter tree;
leaves are visited in jax's flatten order (dict keys sorted), so the global
norm adds the leaves' sums in the reference's order.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.dist.compress import tree_leaves, tree_map, tree_unflatten
from repro_torch.dist.data_parallel import add_in_order


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any  # float32 tree
    nu: Any  # float32 tree


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = tree_leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=first.device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in order, of each leaf's sum of squares."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def sharded_global_norm(shards, owners, group) -> torch.Tensor:
    """:func:`global_norm` of a tree stored in shards over the ranks of
    ``group`` (a :class:`~repro_torch.dist.data_parallel.DataParallel`):
    each rank's sum of squares of every shard it is the first to hold
    (``owners``, per leaf), gathered, added over the ranks in rank order
    leaf by leaf, then over the leaves. Every rank gets the same bits."""
    leaves = tree_leaves(shards)
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    sq = torch.stack([torch.sum(torch.square(x.float())) if own else zero
                      for x, own in zip(leaves, owners)])
    return torch.sqrt(torch.sum(add_in_order(group.gather(sq).unbind(0))))


def cosine_schedule(step, *, base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``base_lr``, then cosine decay to ``min_ratio·base_lr``;
    ``step`` is an integer tensor, the result a float32 scalar."""
    step_f = step.float()
    lr = _f32(base_lr, step_f)
    warm = lr * step_f / _f32(max(warmup, 1), step_f)
    prog = torch.clamp((step_f - _f32(warmup, step_f)) / _f32(max(total - warmup, 1), step_f),
                       0.0, 1.0)
    cos = torch.cos(_f32(math.pi, step_f) * prog)
    cos = lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + cos))
    return torch.where(step_f < _f32(warmup, step_f), warm, cos)


def adamw_update(grads, state: AdamWState, params, *, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1, grad_clip: float = 1.0,
                 gnorm=None):
    """One AdamW step. Returns ``(new_params, new_state, {"grad_norm", "lr"})``.
    Elementwise but for the clip, so it runs alike on shards: ``gnorm`` is
    then the global norm of the whole gradient (:func:`sharded_global_norm`),
    else :func:`global_norm` of ``grads``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    if grad_clip > 0:
        clipped = _f32(grad_clip, gnorm) / torch.maximum(gnorm, _f32(1e-9, gnorm))
        scale = torch.where(gnorm > grad_clip, clipped, _f32(1.0, gnorm))
    else:
        scale = _f32(1.0, gnorm)
    step = state.step + 1
    c1 = 1.0 - torch.pow(_f32(b1, gnorm), step.float())
    c2 = 1.0 - torch.pow(_f32(b2, gnorm), step.float())

    def upd(g, m, v, p):
        g = g.float() * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps) + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_new, v_new

    out = [upd(*x) for x in zip(tree_leaves(grads), tree_leaves(state.mu),
                                 tree_leaves(state.nu), tree_leaves(params))]
    new = [tree_unflatten(params, [o[i] for o in out]) for i in range(3)]
    return new[0], AdamWState(step=step, mu=new[1], nu=new[2]), {"grad_norm": gnorm, "lr": lr}
