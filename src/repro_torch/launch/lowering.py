"""Cell building and tracing: (arch × shape × plan) → one rank's step, counted.

Port of ``repro/launch/lowering.py``. A *cell* is one ``(ModelConfig,
ShapeSpec, MeshPlan)`` triple seen from one rank: :func:`build_cell` holds
that rank's arguments and the step the port runs on them, and
:func:`trace_cell` runs the step once under the counters of
``launch/costs.py`` and the counting ranks of ``launch/dry_ranks.py``, the
counterpart of ``lower_cell``. On the ``meta`` device nothing is allocated
and nothing computed; the shapes, the ops and the collectives are the
ones a rank of the plan runs.

The arguments follow the reference's ``input_specs`` and rule tables:

  * train: the rank's parameter shards and AdamW moments under the train
    table (``dist/fsdp.py``: ``embed`` over the data axes, the
    tensor-parallel dimensions over ``model``) and its rows of the batch;
    the step is the trainer's (``launch/train.py::build_train_step``) over
    the counting data, model and world groups;
  * prefill: the rank's parameter shards under the serve table and its
    shard of the batch as that table lays it out (``seq`` over ``model``);
    the step gathers the sequence over the model ranks and runs
    ``Model.prefill_step(..., tp=)``, whose activations are split over
    heads and ``ff``, not over ``seq``;
  * decode: the rank's parameter and cache shards under the serve table
    (``models/api.py::shard_params``, ``shard_cache``) and its slots; the
    step is ``Model.serve_step(..., tp=, kv_len=)``, the split decode step.

Parameters cannot be drawn on ``meta`` (a generator there raises), so a
cell on ``meta`` takes the family's ``init`` on a model built for
``meta`` with a CPU generator: every leaf's shape and dtype, no values.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, RunConfig, ShapeSpec
from repro_torch.dist.fsdp import Sharded
from repro_torch.dist.sharding import Rules, make_rules
from repro_torch.launch import costs
from repro_torch.launch.dry_ranks import CollectiveLog, counting_groups
from repro_torch.launch.train import build_train_step
from repro_torch.models.api import (
    Model,
    build_model,
    param_axes,
    param_shapes,
    shard_cache,
    shard_params,
)
from repro_torch.optim import adamw_init
from repro_torch.runtime import MeshPlan, plan_mesh

#: the reference's production meshes: (ranks, pods)
MESHES = {"pod": (256, 1), "multipod": (512, 2)}


def production_plan(mesh_kind: str, global_batch: int) -> MeshPlan:
    """``(16, 16)`` as ``("data", "model")``, or ``(2, 16, 16)`` with a pod
    axis: the reference's ``make_production_mesh`` as a plan."""
    n, pods = MESHES[mesh_kind]
    return plan_mesh(n, global_batch=global_batch, want_model=16, want_pods=pods)


def input_specs(cfg: ModelConfig, sp: ShapeSpec, device="meta") -> dict:
    """The global inputs of the step for shape ``sp``, as the reference's
    ``input_specs`` gives them (int32 tokens, bfloat16 frames and image
    embeddings; the decode token, position and cache), zeros on ``device``
    (no allocation on ``meta``)."""
    b, s = sp.global_batch, sp.seq_len
    i32 = torch.int32
    if sp.kind in ("train", "prefill"):
        batch: dict = {}
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((b, cfg.enc_len, cfg.d_model), dtype=torch.bfloat16,
                                          device=device)
            batch["tokens"] = torch.zeros((b, s), dtype=i32, device=device)
        elif cfg.family == "vlm":
            batch["img_emb"] = torch.zeros((b, cfg.img_tokens, cfg.img_dim),
                                           dtype=torch.bfloat16, device=device)
            batch["tokens"] = torch.zeros((b, s - cfg.img_tokens), dtype=i32, device=device)
        else:
            batch["tokens"] = torch.zeros((b, s), dtype=i32, device=device)
        return batch
    return {"token": torch.zeros((b,), dtype=i32, device=device),
            "pos": torch.zeros((), dtype=i32, device=device),
            "cache": build_model(cfg, device).init_cache(b, s, device)}


def batch_axes(batch: dict) -> dict:
    """The reference's ``_batch_shardings``: ``("batch", "seq")`` for a 2-D
    leaf, ``("batch", "seq", None)`` for a 3-D one, else ``("batch",)``."""
    return {k: ("batch", "seq") if x.dim() == 2 else ("batch", "seq", None)
            if x.dim() == 3 else ("batch",) for k, x in batch.items()}


def init_params(model: Model, seed: int = 0):
    """The parameters of ``model``: seeded on a real device; on ``meta``
    the family's ``init`` drawing nothing (shapes and dtypes only)."""
    if model.device.type == "meta":
        return model.init_fn(torch.Generator())
    return model.init(seed)


@dataclasses.dataclass
class Cell:
    cfg: ModelConfig
    sp: ShapeSpec
    plan: MeshPlan
    rank: int
    rules: Rules
    model: Model
    step_fn: Callable  # step_fn(*args)
    args: tuple  # the rank's arguments, in the reference's order
    log: CollectiveLog
    notes: list  # what the port's step does differently from the reference's


def build_cell(cfg: ModelConfig, shape: str | ShapeSpec, plan: MeshPlan, rank: int = 0,
               remat: bool = True, rules: Rules | None = None, device="meta",
               seed: int = 0) -> Cell:
    """Rank ``rank``'s arguments and step for one cell (see the module
    docstring). ``rules``: the plan's table with the dry-run's overrides
    (default: the train table for a train shape, else the serve table)."""
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    mode = "train" if sp.kind == "train" else "serve"
    rules = rules or make_rules(plan, mode)
    dev = torch.device(device)
    model = build_model(cfg, dev)
    log = CollectiveLog()
    dp, tp, world = counting_groups(rules, rank, dev, log)
    shapes, axes = param_shapes(cfg), param_axes(cfg)
    params = init_params(model, seed)
    notes: list = []

    if sp.kind == "decode":
        spec = input_specs(cfg, sp, "meta")  # the rank's block of slots of each
        b0, b1 = rules.block(rank, "batch", sp.global_batch)
        args = (shard_params(model, rules, rank, params),
                {"token": torch.zeros((b1 - b0,), dtype=spec["token"].dtype, device=dev),
                 "pos": torch.zeros((), dtype=spec["pos"].dtype, device=dev),
                 "cache": shard_cache(model, rules, rank, sp.global_batch, sp.seq_len)})
        del params, spec
        split = tp if tp.size > 1 else None

        def step(p, b):
            return model.serve_step(p, b, split, sp.seq_len)

        return Cell(cfg, sp, plan, rank, rules, model, step, args, log, notes)

    batch = input_specs(cfg, sp, dev)
    b_axes = batch_axes(batch)
    layout = Sharded(rules, rank, {k: tuple(x.shape) for k, x in batch.items()}, b_axes,
                     None, None)
    local = layout.shard(batch, dev)
    del batch

    if sp.kind == "train":
        fs = Sharded(rules, rank, shapes, axes, dp, tp)
        shards = fs.shard(params, dev)
        del params
        opt = adamw_init(shards)
        shard = dp.shards(sp.global_batch, 1)
        if not shard and dp.size > 1:
            notes.append(f"the data ranks do not divide the batch of {sp.global_batch}: "
                         "every rank takes it whole")
        step_fn = build_train_step(model, RunConfig(remat=remat), 1, dp if shard else None,
                                   tp if tp.size > 1 else None, fs, world=world)

        def step(p, o, b):
            return step_fn(p, o, b, None)

        return Cell(cfg, sp, plan, rank, rules, model, step, (shards, opt, local), log, notes)

    # prefill: the serve table lays the sequence over the model ranks; the
    # port's forward splits heads and ff, so it gathers the sequence first
    shards = shard_params(model, rules, rank, params)
    del params
    seq_split = {k: layout.layouts[i].model_dim for i, k in enumerate(sorted(local))}
    if any(d is not None for d in seq_split.values()):
        notes.append("prefill: the batch is stored with seq over model (the serve table) "
                     "and gathered whole on each model rank; the activations split over "
                     "heads and ff, not over seq")
    split = tp if tp.size > 1 else None

    def step(p, b):
        b = {k: x if seq_split[k] is None else tp.gather_dim(x, seq_split[k])
             for k, x in b.items()}
        return model.prefill_step(p, b, tp=split)

    return Cell(cfg, sp, plan, rank, rules, model, step, (shards, local), log, notes)


def argument_leaves(cell: Cell) -> list[tuple[str, tuple, str]]:
    """``(path, shape, dtype)`` of every argument leaf, paths as
    ``params/layer_0/attn/wq``, ``opt/mu/...``, ``batch/tokens``: the order
    the reference's pytree of the same arguments flattens in."""
    names = ("params", "opt", "batch") if cell.sp.kind == "train" else ("params", "batch")
    out = []

    def walk(prefix, x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(f"{prefix}/{k}", x[k])
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for k in x._fields:
                walk(f"{prefix}/{k}", getattr(x, k))
        elif isinstance(x, torch.Tensor):
            out.append((prefix, tuple(x.shape), str(x.dtype).replace("torch.", "")))
    for name, arg in zip(names, cell.args):
        walk(name, arg)
    return out


def trace(fn: Callable, args: tuple, log: CollectiveLog) -> dict[str, Any]:
    """Run ``fn(*args)`` once under a :class:`~repro_torch.launch.costs.WorkCounter`:
    the record's ``memory``, ``cost`` and ``collectives`` keys, the calls
    grouped (``collective_log``), the hand kernels' calls and the wall."""
    counter = costs.WorkCounter(tree_leaves_any(args)[0].device.type)
    arg_bytes = counter.add_storages(tree_leaves_any(args))
    log.clear()
    # storages die by reference count alone while the step runs, so the
    # peak does not hang on when the cycle collector happens to run
    gc.collect()
    gc.disable()
    t0 = time.perf_counter()
    try:
        with counter:
            out = fn(*args)
    finally:
        gc.enable()
    wall = time.perf_counter() - t0
    seen, out_bytes = set(), 0
    for x in tree_leaves_any(out):
        st = x.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            out_bytes += int(st.nbytes())
    del out
    return {
        "memory": {"argument_bytes": int(arg_bytes), "output_bytes": int(out_bytes),
                   "temp_bytes": int(counter.peak - arg_bytes),
                   "peak_bytes": int(counter.peak)},
        "cost": {"flops": counter.flops, "bytes_accessed": counter.bytes,
                 "host_to_device_bytes": counter.h2d_bytes},
        "collectives": costs.collective_bytes(log.calls),
        "collective_log": log.grouped(),
        "reductions_as_gathers": log.reductions(),
        "kernel_calls": dict(counter.kernel_calls),
        "data_dependent_ops": counter.data_dependent,
        "folded_trips": counter.folded_trips,
        "trace_s": wall,
        "_calls": list(log.calls),
    }


def tree_leaves_any(tree) -> list:
    """Every tensor in a tree of dicts, lists, tuples, named tuples and
    dataclasses (``SummaryState``), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves_any(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves_any(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves_any(getattr(tree, f.name))]
    return []


def trace_cell(cell: Cell, hardware: costs.Hardware = costs.H100,
               remat: bool = True) -> dict[str, Any]:
    """Trace the cell's step once (the counterpart of ``lower_cell``) and
    assemble its record: the counts of :func:`trace` and the roofline on
    ``hardware``, the collective term priced link by link."""
    rec = trace(cell.step_fn, cell.args, cell.log)
    calls = rec.pop("_calls")
    n = cell.plan.n_devices
    rec["roofline"] = costs.roofline(
        hlo_flops_per_dev=rec["cost"]["flops"], hlo_bytes_per_dev=rec["cost"]["bytes_accessed"],
        coll_bytes_per_dev=rec["collectives"]["total"], cfg=cell.cfg, sp=cell.sp, n_chips=n,
        remat=remat, hardware=hardware,
        t_collective=costs.collective_seconds(calls, hardware))
    rec["hardware"] = hardware.name
    rec["notes"] = list(cell.notes)
    return rec
