"""Shared model building blocks: initialisers, norms, RoPE, gated MLPs.

Port of ``repro/models/common.py``. Parameters are plain nested dicts of
tensors with the reference's keys, so a reference parameter tree carries
over leaf for leaf (:func:`repro_torch.core.convert.lm_params_from_numpy`).
The reference's ``Px`` leaves pair each leaf with its logical sharding axes;
the port keeps the axes as trees of their own beside the shapes
(``models/api.py::param_axes``), which the trainer's rule table reads.
Random draws come from an explicit ``torch.Generator``: one float32 tensor
at a time, scaled, then cast, so a full-width model is never held in
float32 whole.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def param_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    return int(tree.numel())


def tree_map(fn, *trees):
    """``fn`` over the leaves of dict trees of one structure, in a new tree."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_to(tree, device):
    """A copy of a parameter or cache tree on ``device``."""
    return tree_map(lambda x: x.to(device), tree)


def param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    return int(tree.numel() * tree.element_size())


def remat_call(fn, remat: bool, *args):
    """``fn(*args)``; with ``remat``, under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of a block): its activations are dropped
    after the forward and recomputed in the backward."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def normal_init(gen: torch.Generator, shape, scale: float, dtype=torch.bfloat16,
                device="cuda") -> torch.Tensor:
    """``scale`` times a float32 standard normal draw, cast to ``dtype``."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def dense_init(gen, shape, in_axis: int | None = 0, dtype=torch.bfloat16,
               device="cuda") -> torch.Tensor:
    fan_in = shape[in_axis] if in_axis is not None else int(np.prod(shape[:-1]))
    return normal_init(gen, shape, 1.0 / math.sqrt(max(fan_in, 1)), dtype, device)


def embed_init(gen, shape, dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    return normal_init(gen, shape, 0.02, dtype, device)


# ---------------------------------------------------------------------------
# norms (params in f32, math in f32, cast back)
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def sum_squares(x):
    """``Σ x²`` over the last dimension in float32, kept as ``[..., 1]``: a
    rank's part of the statistic of an RMSNorm over a split dimension."""
    xf = x.float()
    return torch.sum(xf * xf, dim=-1, keepdim=True)


def rmsnorm_part(x, scale, ss, d: int, eps: float = 1e-6):
    """:func:`rmsnorm` of a rank's entries ``x`` of a dimension of ``d``
    split over the model ranks, and its entries ``scale``: ``ss`` is the
    :func:`sum_squares` of the whole dimension (the ranks' parts added)."""
    xf = x.float()
    out = xf * torch.rsqrt(ss / d + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def norm_tp(p, x, kind: str, d: int, eps: float, tp):
    """:func:`apply_norm` over a dimension of ``d`` split over the model
    group ``tp``: ``x`` and ``p``'s ``scale`` are this rank's entries, and
    the parts' sums of squares are added over the group in rank order
    (every rank holds the same bits; the gradient of the sum reaches every
    rank's part). Only an RMSNorm splits so."""
    if kind != "rmsnorm":
        raise ValueError(f"a norm over a split dimension is an RMSNorm, not a {kind}")
    return rmsnorm_part(x, p["scale"], tp.all_reduce(sum_squares(x)), d, eps)


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    out = out + bias.float()
    return out.to(x.dtype)


def norm_shapes(d, kind: str = "rmsnorm") -> dict:
    """The shape of every leaf :func:`init_norm` makes."""
    return {"scale": (d,)} if kind == "rmsnorm" else {"scale": (d,), "bias": (d,)}


def norm_axes(kind: str = "rmsnorm") -> dict:
    """The logical axes of every leaf :func:`init_norm` makes (replicated)."""
    return {"scale": (None,)} if kind == "rmsnorm" else {"scale": (None,), "bias": (None,)}


def init_norm(d, kind: str = "rmsnorm", device="cuda"):
    if kind == "rmsnorm":
        return {"scale": torch.zeros(d, dtype=torch.float32, device=device)}
    return {
        "scale": torch.ones(d, dtype=torch.float32, device=device),
        "bias": torch.zeros(d, dtype=torch.float32, device=device),
    }


def apply_norm(p, x, kind: str = "rmsnorm", eps: float = 1e-6):
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"], eps)
    return layernorm(x, p["scale"], p["bias"], eps)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float = 10_000.0):
    """Apply RoPE, rotating halves. x: [..., S, H, hd]; positions: broadcastable
    to [..., S]. Computes in float32 and casts back."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.arange(half, dtype=torch.float32, device=x.device) / half
    inv = torch.pow(float(np.float32(theta)), -freq)  # float32, no host-to-card copy
    ang = positions.to(torch.float32)[..., None] * inv  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]  # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=16)
def sinusoidal_pos(seq_len: int, d: int, device="cuda") -> torch.Tensor:
    """[seq_len, d] sin/cos table, built in numpy float64 and cast to float32
    as the reference builds it (a float32 ``torch.sin`` differs in the last
    bits). Built once a shape and device; callers must not write to it."""
    pos = np.arange(seq_len)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * i / d)
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(out.astype(np.float32)).to(device)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


#: the logical axes of :func:`init_mlp`'s leaves (the reference's ``Px``)
MLP_AXES = {"wi": ("embed", "ff"), "wg": ("embed", "ff"), "wo": ("ff", "embed")}


def init_mlp(gen, d, f, dtype=torch.bfloat16, device="cuda"):
    return {
        "wi": dense_init(gen, (d, f), 0, dtype, device),
        "wg": dense_init(gen, (d, f), 0, dtype, device),
        "wo": dense_init(gen, (f, d), 0, dtype, device),
    }


def mlp_tp(p, x, tp, f: int, fn):
    """``fn(p, x)``, an MLP of ``MLP_AXES``' leaves (``wi``, ``wo`` and
    ``wg`` where it has one), under a model group ``tp``: column-parallel
    ``wi``/``wg`` and row-parallel ``wo`` over ``ff`` (width ``f``), one
    reduce; where the group does not split ``ff`` every rank computes the
    whole MLP, as the reference replicates it."""
    d = x.shape[-1]
    shapes = {"wi": (d, f), "wg": (d, f), "wo": (f, d)}
    if not tp.splits(f):
        return fn(tp.whole(p, MLP_AXES, shapes), x)
    local = {k: tp.take(v, MLP_AXES[k], shapes[k], 0 if k == "wo" else 1)
             for k, v in p.items()}
    return tp.reduce(fn(local, tp.copy(x)))


def matmul_cols(x, w, axes, shape, tp):
    """``x @ w`` whole on every rank of a serve table's model group ``tp``,
    from ``w`` [k, n] as the table stores it: where its columns are split,
    each rank multiplies by its columns and the parts are gathered in rank
    order (``B·n`` elements); else ``w`` is read whole."""
    if tp.rules.split_dim(axes, shape, "model") == 1:
        return tp.gather_dim(torch.matmul(x, w), -1)
    return torch.matmul(x, tp.take(w, axes, shape, None, partial=False))


def matmul_rows(y, w, axes, shape, tp):
    """``y @ w`` whole on every rank of a serve table's model group ``tp``
    (``w`` [k, ...] flattened after its rows, the product unflattened),
    ``y`` whole on every rank: where ``w``'s rows are split, each rank
    multiplies its part of ``y`` by its rows and the partial products are
    added in rank order; else ``w`` is read whole."""
    if tp.rules.split_dim(axes, shape, "model") == 0:
        d0, d1 = tp.part(shape[0])
        out = tp.sum(torch.matmul(y[..., d0:d1], w.reshape(d1 - d0, -1)))
    else:
        w = tp.take(w, axes, shape, None, partial=False)
        out = torch.matmul(y, w.reshape(shape[0], -1))
    return out.unflatten(-1, tuple(shape[1:]))


def apply_mlp_tp(p, x, act: str, tp, f: int):
    """:func:`apply_mlp` under a model group ``tp`` (:func:`mlp_tp`)."""
    return mlp_tp(p, x, tp, f, functools.partial(apply_mlp, act=act))


def apply_mlp(p, x, act: str = "silu"):
    h = torch.matmul(x, p["wi"])
    g = torch.matmul(x, p["wg"])
    if act == "gelu":  # jax.nn.gelu's default: the tanh approximation
        h = F.gelu(g.float(), approximate="tanh").to(x.dtype) * h
    else:
        h = F.silu(g.float()).to(x.dtype) * h
    return torch.matmul(h, p["wo"])
