"""Model API of the port: ``build_model(cfg, device)`` for every family.

Port of ``repro/models/api.py``. :class:`Model` gives

    init(seed)                        → params (a dict tree of tensors)
    forward(params, batch)            → (logits, aux)           train/prefill
    loss(params, batch)               → (scalar, metrics)
    train_step(params, opt, batch, run) → (params, opt, metrics)
    prefill_step(params, batch, tp)   → last-position logits [B, V]
    serve_step(params, batch, tp)     → (logits [B, V], cache)   decode
    init_cache(batch, seq_len)        → decode cache (dict tree)
    cache_axes()                      → the cache's logical axes

on the model's device (``"cuda"`` unless the caller asks for the CPU). The
dense and MoE families (the MoE block plugs into the transformer block),
the VLM family (paligemma: a projected image prefix before the tokens,
``batch["img_emb"]``; decode is the dense step with no image, as in the
reference), the hybrid (zamba2's Mamba2 blocks and shared attention),
xLSTM, and the encoder-decoder (whisper: ``batch["frames"]`` through the
encoder, then the teacher-forced decoder; decode attends to the cache's
cross K/V). The two recurrent families set the server's admission seam,
``clear_slot`` and ``restore_slots`` (see :class:`Model`). Under a model
group (``forward(..., tp=)``) every family computes tensor-parallel: the
vocab-parallel embedding and head where the group splits the vocab,
head-parallel attention, cross attention, Mamba2, mLSTM and sLSTM blocks,
MLPs over ``ff``, the MoE block over its experts or ``ff``; a layer the
group does not divide reads its leaves whole (replicated compute, as the
reference's rule table replicates it).
:func:`param_shapes` gives each family's tree of leaf shapes, and
:func:`param_axes` their logical sharding axes (the rule tables);
``Model.cache_axes()`` the decode cache's. Under a serve table's model
group (``serve_step(..., tp=, kv_len=)``) every family decodes
tensor-parallel on its rank's shard of the cache (:func:`shard_cache`):
the dense, MoE and VLM families on a KV cache split on its positions or
KV heads (``transformer.decode_step``), the hybrid with its Mamba2 state
whole on every rank (``mamba2.ssd_decode_tp``) and the shared block's KV
caches split, xLSTM with its mLSTM and sLSTM states split on their heads
(``xlstm.mlstm_decode_tp``, ``slstm_decode_tp``), and the
encoder-decoder with its self-attention cache split and its cross K/V on
their KV heads (``attention.cross_attention_decode_tp``); every rank
returns the whole logits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.types import resolve_device
from repro_torch.dist.compress import tree_leaves, tree_unflatten
from repro_torch.dist.fsdp import Sharded
from repro_torch.dist.microbatch import value_and_grad
from repro_torch.models import transformer, whisper, xlstm, zamba2
from repro_torch.models.common import DTYPES, dense_init, tree_map
from repro_torch.models.losses import causal_lm_loss, causal_lm_loss_parallel
from repro_torch.optim import adamw_update, cosine_schedule


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init_fn: Callable  # (generator) -> params
    # (params, batch, last_only=False, remat=False, dp=None, tp=None) -> (logits, aux);
    # dp: the MoE blocks' data-parallel group (models/moe.py); tp: the model
    # group (dist/tensor_parallel.py), params then this rank's view of the
    # stored leaves
    forward: Callable
    # (params, batch, tp=None, kv_len=None) -> (logits, cache); tp: a serve
    # table's model group, the cache then this rank's shard of kv_len positions
    decode: Callable
    init_cache: Callable  # (batch, seq_len, device=the model's) -> cache
    cache_axes: Callable  # () -> the logical axes of init_cache's leaves
    # Admission seam for recurrent families: clear_slot(cache, s) zeroes slot
    # s of every leaf; restore_slots(new, old, s) keeps slot s of ``new`` and
    # every other slot of ``old``. A KV cache needs neither (position masking).
    clear_slot: Callable | None = None
    restore_slots: Callable | None = None
    prefix_len: int = 0  # positions before the tokens (the VLM's image)
    # init_cache's value of every leaf of these names (the others start at 0)
    cache_fill: dict = dataclasses.field(default_factory=dict)

    def init(self, seed: int = 0, place=None):
        """The seeded parameters; ``place(key, subtree)`` keeps each
        top-level entry as it is drawn (``transformer.init_lm``)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return self.init_fn(gen) if place is None else self.init_fn(gen, place)

    def loss(self, params, batch, remat: bool = True, dp=None, tp=None):
        """``(total, metrics)``; ``dp``, the data-parallel group, reaches
        every MoE block (a family without one computes the same loss);
        ``tp``, the model group, splits every family's layers, and the loss
        of vocab-sharded logits is the vocab-parallel one."""
        logits, aux = self.forward(params, batch, remat=remat, dp=dp, tp=tp)
        loss = causal_lm_loss
        if logits.shape[-1] != self.cfg.vocab:  # this model rank's vocab part
            loss = functools.partial(causal_lm_loss_parallel, tp=tp)
        return loss(logits, batch["tokens"], moe_aux=aux.get("moe_aux"),
                    prefix_len=self.prefix_len)

    def train_step(self, params, opt_state, batch, run: RunConfig | None = None,
                   remat: bool = True):
        """One AdamW step on the loss's gradients; the schedule is evaluated
        at the step being taken (``step + 1``), so the first update moves
        the parameters."""
        run = run or RunConfig()
        (loss, metrics), grads = value_and_grad(
            lambda p: self.loss(p, batch, remat), params)
        lr = cosine_schedule(opt_state.step + 1, base_lr=run.lr, warmup=run.warmup_steps,
                             total=run.total_steps, min_ratio=run.lr_min_ratio)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=run.weight_decay,
            grad_clip=run.grad_clip)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    def serve_step(self, params, batch, tp=None, kv_len=None):
        return self.decode(params, batch, tp, kv_len)

    def prefill_step(self, params, batch, tp=None):
        """Prefill: full-sequence forward, last-position logits only.
        ``tp``: a model group (``params`` this rank's stored leaves); the
        layers split over heads and ``ff``, and a vocab-split head's parts
        are gathered, so every rank returns the whole logits."""
        logits, _ = self.forward(params, batch, last_only=True, tp=tp)
        logits = logits[:, -1]
        if tp is not None and logits.shape[-1] != self.cfg.vocab:
            logits = tp.gather_dim(logits, -1)
        return logits


def _dense_family(cfg: ModelConfig, dev: torch.device) -> Model:
    dtype = DTYPES[cfg.dtype]

    def fwd(params, batch, last_only=False, remat=False, dp=None, tp=None):
        return transformer.forward(params, batch["tokens"], cfg, last_only=last_only,
                                   remat=remat, dp=dp, tp=tp)

    def dec(params, batch, tp=None, kv_len=None):
        return transformer.decode_step(params, batch["token"], batch["cache"], batch["pos"],
                                       cfg, tp, kv_len)

    return Model(
        cfg=cfg,
        device=dev,
        init_fn=lambda gen, place=None: transformer.init_lm(gen, cfg, dtype, dev, place),
        forward=fwd,
        decode=dec,
        init_cache=lambda b, s, device=dev: transformer.init_cache(cfg, b, s, dtype, device),
        cache_axes=lambda: transformer.cache_axes(cfg),
    )


def _vlm_family(cfg: ModelConfig, dev: torch.device) -> Model:
    dtype = DTYPES[cfg.dtype]

    def init(gen, place=None):
        p = transformer.init_lm(gen, cfg, dtype, dev, place)
        p["img_proj"] = dense_init(gen, (cfg.img_dim, cfg.d_model), 0, dtype, dev)
        if place is not None:
            p["img_proj"] = place("img_proj", p["img_proj"])
        return p

    def fwd(params, batch, last_only=False, remat=False, dp=None, tp=None):
        img_proj = params["img_proj"]
        if tp is not None:  # split on embed only: every model rank projects the image
            img_proj = tp.take(img_proj, (None, "embed"), (cfg.img_dim, cfg.d_model), None,
                               partial=False)
        prefix = torch.matmul(batch["img_emb"].to(dtype), img_proj)
        return transformer.forward(params, batch["tokens"], cfg, prefix_emb=prefix,
                                   last_only=last_only, remat=remat, dp=dp, tp=tp)

    model = _dense_family(cfg, dev)
    return dataclasses.replace(model, init_fn=init, forward=fwd, prefix_len=cfg.img_tokens)


def clear_slot(cache, s: int):
    """Zero slot ``s`` of every leaf in place, as the reference's server does
    at admission (an xLSTM stabiliser ``m`` becomes 0, not init's -30)."""
    tree_map(lambda x: x[s].zero_(), cache)
    return cache


def restore_slots(new, old, s: int):
    """Slot ``s`` of ``new`` and every other slot of ``old``, written into ``old``."""
    def one(n, o):
        o[s] = n[s]
        return o

    return tree_map(one, new, old)


def _recurrent_family(cfg: ModelConfig, dev: torch.device, init, forward, decode,
                      init_cache, cache_axes, cache_fill=None) -> Model:
    def fwd(params, batch, last_only=False, remat=False, dp=None, tp=None):
        del dp  # no MoE block
        return forward(params, batch["tokens"], cfg, last_only=last_only, remat=remat, tp=tp)

    def dec(params, batch, tp=None, kv_len=None):
        return decode(params, batch["token"], batch["cache"], batch["pos"], cfg, tp, kv_len)

    return Model(cfg=cfg, device=dev, init_fn=init, forward=fwd, decode=dec,
                 init_cache=init_cache, cache_axes=lambda: cache_axes(cfg),
                 clear_slot=clear_slot, restore_slots=restore_slots,
                 cache_fill=cache_fill or {})


def _hybrid_family(cfg: ModelConfig, dev: torch.device) -> Model:
    dtype = DTYPES[cfg.dtype]
    return _recurrent_family(
        cfg, dev, lambda gen, place=None: zamba2.init_zamba2(gen, cfg, dtype, dev, place),
        zamba2.forward, zamba2.decode_step,
        lambda b, s, device=dev: zamba2.init_cache(cfg, b, s, dtype, device), zamba2.cache_axes)


def _xlstm_family(cfg: ModelConfig, dev: torch.device) -> Model:
    dtype = DTYPES[cfg.dtype]
    return _recurrent_family(
        cfg, dev, lambda gen, place=None: xlstm.init_xlstm_lm(gen, cfg, dtype, dev, place),
        xlstm.xlstm_forward, xlstm.xlstm_decode_step,
        lambda b, s, device=dev: xlstm.init_xlstm_cache(cfg, b, s, device),
        xlstm.xlstm_cache_axes, {"m": xlstm.M_INIT})


def _encdec_family(cfg: ModelConfig, dev: torch.device) -> Model:
    dtype = DTYPES[cfg.dtype]

    def fwd(params, batch, last_only=False, remat=False, dp=None, tp=None):
        # as in the reference, whisper's blocks are not rematerialized; no MoE block
        del remat, dp
        enc = whisper.encode(params, batch["frames"].to(dtype), cfg, tp)
        return whisper.decode_train(params, batch["tokens"], enc, cfg, last_only=last_only,
                                    tp=tp), {}

    def dec(params, batch, tp=None, kv_len=None):
        return whisper.decode_step(params, batch["token"], batch["cache"], batch["pos"], cfg,
                                   tp, kv_len)

    return Model(cfg=cfg, device=dev,
                 init_fn=lambda gen, place=None: whisper.init_whisper(gen, cfg, dtype, dev, place),
                 forward=fwd, decode=dec,
                 init_cache=lambda b, s, device=dev: whisper.init_cache(cfg, b, s, dtype, device),
                 cache_axes=lambda: whisper.cache_axes(cfg))


_FAMILIES = {
    "dense": _dense_family,
    "moe": _dense_family,  # MoE plugs into the transformer block
    "vlm": _vlm_family,
    "xlstm": _xlstm_family,
    "hybrid": _hybrid_family,
    "encdec": _encdec_family,
}


def param_shapes(cfg: ModelConfig) -> dict:
    """The shape of every leaf the family's ``init`` makes, in the same tree."""
    if cfg.family == "hybrid":
        return zamba2.param_shapes(cfg)
    if cfg.family == "xlstm":
        return xlstm.param_shapes(cfg)
    if cfg.family == "encdec":
        return whisper.param_shapes(cfg)
    out = transformer.param_shapes(cfg)
    if cfg.family == "vlm":
        out["img_proj"] = (cfg.img_dim, cfg.d_model)
    return out


def param_axes(cfg: ModelConfig) -> dict:
    """The logical sharding axes of every leaf, in :func:`param_shapes`' tree:
    the reference's ``model.axes()``, copied from its ``Px`` annotations."""
    if cfg.family == "hybrid":
        return zamba2.param_axes(cfg)
    if cfg.family == "xlstm":
        return xlstm.param_axes(cfg)
    if cfg.family == "encdec":
        return whisper.param_axes(cfg)
    out = transformer.param_axes(cfg)
    if cfg.family == "vlm":
        out["img_proj"] = (None, "embed")
    return out


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda") -> Model:
    return _FAMILIES[cfg.family](cfg, resolve_device(device))


def _shape_tree(tree) -> dict:
    """A dict tree of tensors as the same tree of their shapes."""
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    return tuple(tree.shape)


def shard_params(model: Model, rules, rank: int, params=None, seed: int = 0):
    """Rank ``rank``'s shards of the parameters under a serve table
    ``rules`` (whole on the data axes): of ``params`` (whole) when given,
    else of the seeded initialisation, drawn one top-level entry at a time
    and sharded as it comes, so the whole tree is never on the device.
    Without a model axis, the whole tree."""
    cfg = model.cfg
    shapes, axes = param_shapes(cfg), param_axes(cfg)
    if rules.sizes.get("model", 1) == 1:
        return model.init(seed) if params is None else params
    if params is not None:
        return Sharded(rules, rank, shapes, axes, None, None).shard(params)
    return model.init(seed, lambda key, tree: Sharded(
        rules, rank, shapes[key], axes[key], None, None).shard(tree))


def _names(tree, name=None):
    """A dict tree of tensors as the same tree of its leaves' keys."""
    if isinstance(tree, dict):
        return {k: _names(v, k) for k, v in tree.items()}
    return name


def shard_cache(model: Model, rules, rank: int, slots: int, max_len: int, cache=None):
    """Rank ``rank``'s shard of the decode cache of ``slots`` × ``max_len``
    under ``rules``: its block of slots (where the data axes divide them)
    and its part of every leaf the table splits over ``model``. Of
    ``cache`` (the whole cache, e.g. whisper's cross K/V filled by
    ``whisper.fill_cross_cache``), copied to the model's device, when
    given; else the family's initial cache (``Model.init_cache``: zeros,
    and xLSTM's stabilisers at ``M_INIT``) made at the rank's own shapes."""
    whole = model.init_cache(slots, max_len, "meta") if cache is None else cache
    fs = Sharded(rules, rank, _shape_tree(whole), model.cache_axes(), None, None)
    if cache is not None:
        return fs.shard(cache, model.device)
    leaves = [torch.full(shape, model.cache_fill.get(name, 0.0), dtype=x.dtype,
                         device=model.device)
              for x, shape, name in zip(tree_leaves(whole), fs.local_shapes(),
                                        tree_leaves(_names(whole)))]
    return tree_unflatten(whole, leaves)
