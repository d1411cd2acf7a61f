"""Gradients of a loss over a parameter tree, and microbatched accumulation.

Port of ``repro/dist/microbatch.py``. :func:`value_and_grad` is the port's
``jax.value_and_grad(loss_fn, has_aux=True)``: ``torch.autograd.grad`` of
the loss with respect to every leaf of the tree (a leaf the loss does not
reach gets zeros, as in JAX). :func:`microbatch_grads` splits the batch's
leading axis into ``accum`` equal microbatches, takes the gradients of one
microbatch at a time (only one microbatch's activations are live) and
averages losses, aux values and gradients. Gradients accumulate in float32
whatever the parameter's type and are cast back at the end, after the
optional ``reduce`` (the trainer's exact mean over data-parallel ranks).
"""

from __future__ import annotations

import torch

from repro_torch.dist.compress import tree_leaves, tree_map, tree_unflatten


def value_and_grad(loss_fn, params, *args):
    """``((loss, aux), grads)`` of ``loss_fn(params, *args) -> (loss, aux)``;
    loss and aux come back detached."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        xs = [p.detach().requires_grad_(True) for p in leaves]
        loss, aux = loss_fn(tree_unflatten(params, xs), *args)
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, gs)]
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), tree_unflatten(params, gs)


def microbatch_grads(loss_fn, params, batch, accum: int = 1, reduce=None):
    """Accumulated gradients of ``loss_fn(params, batch) -> (loss, aux)``
    (aux: a dict of scalar metrics) over ``accum`` microbatches. Returns
    ``(loss, aux, grads)``, the means over the microbatches; with equal
    microbatch sizes these equal the full-batch quantities. ``reduce``, when
    given, maps the float32 mean gradients (a tree) before their cast back
    to the parameters' types: the data-parallel mean over ranks."""
    if accum <= 1 and reduce is None:
        (loss, aux), grads = value_and_grad(loss_fn, params, batch)
        return loss, aux, grads
    accum = max(accum, 1)
    for x in batch.values():
        if x.shape[0] % accum != 0:
            raise ValueError(f"leading batch dim {x.shape[0]} not divisible by accum={accum}")
    n = torch.full((), accum, dtype=torch.float32, device=tree_leaves(params)[0].device)
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    losses, auxes = [], []
    for i in range(accum):
        mb = {k: x.reshape((accum, x.shape[0] // accum) + x.shape[1:])[i]
              for k, x in batch.items()}
        (loss, aux), grads = value_and_grad(loss_fn, params, mb)
        g_acc = tree_map(lambda a, g: a + g.float() / n, g_acc, grads)
        losses.append(loss)
        auxes.append(aux)
    if reduce is not None:
        g_acc = reduce(g_acc)
    grads = tree_map(lambda g, p: g.to(p.dtype), g_acc, params)
    aux = {k: torch.mean(torch.stack([a[k] for a in auxes]), dim=0) for k in auxes[0]}
    return torch.mean(torch.stack(losses)), aux, grads
