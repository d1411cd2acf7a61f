"""The port's trainer: token pipeline → train loop → checkpoint/restart
→ straggler and preemption handling, on one device or across the ranks of
a ``torch.distributed`` group.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o_danube_1_8b --smoke \
        --steps 20 --batch 8 --seq 64 [--accum 2] [--compress int8|topk] \
        [--ckpt-dir DIR --ckpt-every 5 [--resume]] [--device cuda|cpu]
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --device cpu --arch granite_moe_3b_a800m --smoke --batch 8 --seq 32
    ... --coordinator HOST:PORT --num-processes P --process-id i   (each process)

Port of ``repro/launch/train.py``. It takes the reference's flags and
builds its ``RunConfig`` (warm-up a tenth of the steps). Each step takes the
gradients of ``Model.loss`` (``torch.autograd``; every block under
``torch.utils.checkpoint`` when ``RunConfig.remat``), averaged over
``--accum`` microbatches in float32, and applies AdamW at the cosine
schedule's rate for the step being taken.

Across ranks (a group the caller made, ``torchrun``'s, or the bootstrap's
flags and ``SSUMM_*`` environment; NCCL on the card, gloo with ``--device
cpu``) it gives the reference's step on a mesh of P data-parallel devices,
which is the single-device step on the global batch. It plans with
``plan_mesh(P, batch, want_model)`` and accumulates ``max(--accum,
plan.accum_steps)`` microbatches; each rank holds its part of every
microbatch (``dist/data_parallel.py``), the MoE blocks take the global
capacity, slots and load-balance loss, and the gradients are the exact
mean over the ranks in rank order. Where P does not divide a microbatch,
every rank takes the whole batch, as the reference's shape-aware sharding
replicates it. ``--want-model m`` plans a (data, model) mesh with a model
axis of up to ``m`` ranks: parameters and AdamW moments are stored by the
reference's train table (``dist/sharding.py``, ``dist/fsdp.py``) at every
``--want-model``, and every family computes tensor-parallel over the model
ranks (``dist/tensor_parallel.py``): the vocab-parallel embedding, head and
loss, head-parallel attention (whisper's cross attention too), MLPs over
``ff``, the MoE block over its experts or ``ff``, the Mamba2, mLSTM and
sLSTM blocks over their heads; a layer whose heads, ``ff`` or vocab the
model ranks do not divide is computed whole on every model rank, as the
table replicates it.

``--compress int8|topk`` sends the mean gradients through
``dist.compress.compressed_all_reduce`` over every rank, each contributing
``grads / P`` (the reference compresses its already reduced gradients);
the wire bytes it measures must equal ``P × payload_bytes``. Checkpoints
hold ``(params, AdamWState)``: rank 0 writes them, keep-N, asynchronously
every ``--ckpt-every`` steps, and at the step reached when the loop ends
unless that step was just saved (the reference saves again, at
``--steps``). The state reaches rank 0's host memory one leaf at a time
(``Sharded.full_to_host``), so no card holds more than its shards and one
leaf's parts. ``--resume`` maps rank 0's latest into host memory on every
rank, copies each rank's shard of each leaf to its card, and regenerates the
token stream from that step. SIGTERM/SIGINT on any rank
saves and stops every rank at the same step. Rank 0 prints the reference's
JSON keys plus ``device``, ``world``, the median step and the peak device
memory. It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time

import numpy as np
import torch

from repro_torch.configs import RunConfig, get_config, get_smoke_config
from repro_torch.core.engine import global_preempt
from repro_torch.core.query_engine import RankSet
from repro_torch.core.types import resolve_device
from repro_torch.data import SyntheticTokens, TokenDatasetConfig
from repro_torch.data.loader import to_device
from repro_torch.dist import CompressConfig, compressed_all_reduce, microbatch_grads
from repro_torch.dist.compress import init_error_buffers, payload_bytes, tree_map
from repro_torch.dist.data_parallel import DataParallel
from repro_torch.dist.fsdp import Sharded
from repro_torch.dist.sharding import make_rules
from repro_torch.dist.tensor_parallel import TensorParallel
from repro_torch.launch.mesh import join_process_group, mesh_groups
from repro_torch.models.api import build_model, param_axes, param_shapes
from repro_torch.optim import AdamWState, adamw_init, adamw_update, cosine_schedule, global_norm
from repro_torch.optim.adamw import sharded_global_norm
from repro_torch.runtime import CheckpointManager, PreemptionGuard, StragglerMonitor, plan_mesh


def build_train_step(model, run: RunConfig, accum: int, dp: DataParallel | None = None,
                     tp: TensorParallel | None = None, fs: Sharded | None = None,
                     world: DataParallel | None = None):
    """``step_fn(params, opt, batch, err) -> (params, opt, err, metrics)``.

    ``fs``: the sharded storage across ranks (``dist/fsdp.py``; None, or a
    world of one: every leaf whole); ``params`` and the moments are then
    this rank's shards, gathered over the data ranks before the forward,
    and the gradients reduced to shards after it. ``dp``: the data-parallel
    group when the ranks shard the batch (with ``fs``); then ``batch`` is
    this rank's rows (:meth:`DataParallel.rows`), the MoE blocks run under
    ``dp`` (the global capacity, slots and load-balance loss), and the
    float32 gradients and the loss are the exact means over the data
    ranks, added in rank order. ``tp``: the model group, over which the
    layers split (``dist/tensor_parallel.py``).
    ``--compress`` runs over every rank of the default group (a world of
    one without one) on the whole mean gradient: each contributes ``grads /
    P`` of it, as the reference's ``wire_allreduce`` does (its
    ``shard_map`` takes the replicated gradients, ``in_specs=P()``); the
    result is sharded again. ``world``: every rank (default: the default
    group), over which the sharded gradient norm is summed."""
    def loss_fn(p, b):
        return model.loss(p, b, remat=run.remat, dp=dp, tp=tp)

    compress = run.grad_compress
    ranks = RankSet(model.device) if compress != "none" else None
    ccfg = CompressConfig(compress, topk_ratio=run.topk_ratio)
    sharded = fs is not None and not fs.trivial
    # every rank computes the whole mean gradient: one model rank and a
    # batch the data ranks do not split (the single-device step)
    whole = not sharded or (dp is None and fs.model.size == 1)
    if sharded and world is None:
        world = DataParallel(model.device)

    def step_fn(params, opt, batch, err):
        views = fs.views(params) if sharded else params
        reduce = None if whole else functools.partial(fs.reduce, mean=dp is not None)
        loss, _aux, grads = microbatch_grads(loss_fn, views, batch, accum, reduce=reduce)
        if dp:
            loss = dp.mean(loss)
        wire_bytes = 0.0
        gnorm = None  # global_norm of the gradients, where they are whole
        if compress != "none":
            full = grads if whole else fs.full(grads)
            # each rank contributes grads / P
            n = torch.full((), ranks.size, dtype=torch.float32, device=model.device)
            contrib = tree_map(lambda x: x / n.to(x.dtype), full)
            grads, err, wire_bytes = compressed_all_reduce(contrib, err, ccfg, ranks)
        if sharded and (whole or compress != "none"):
            gnorm = global_norm(grads)
            grads = fs.shard(grads)
        elif sharded:
            gnorm = sharded_global_norm(grads, fs.owners(), world)
        lr = cosine_schedule(opt.step + 1, base_lr=run.lr, warmup=run.warmup_steps,
                             total=run.total_steps, min_ratio=run.lr_min_ratio)
        params, opt, om = adamw_update(grads, opt, params, lr=lr, weight_decay=run.weight_decay,
                                       grad_clip=run.grad_clip, gnorm=gnorm)
        return params, opt, err, {"loss": loss, "wire_bytes": float(wire_bytes), **om}

    return step_fn


@dataclasses.dataclass
class Trained:
    """A run's printed result, its final global state (across ranks in rank
    0's host memory and None on every other rank; in a world of one on its
    device; None where the caller asked for none), every step's loss and
    wall, the parameter shards this rank stored and the optimizer's step."""

    result: dict
    params: dict | None
    opt: object
    losses: list
    step_s: list
    rank: int = 0
    shards: dict | None = None  # this rank's stored parameter shards
    step: int = 0  # the optimizer's step at the end


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="xlstm_350m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", choices=("none", "topk", "int8"), default="none")
    ap.add_argument("--want-model", type=int, default=1, help="TP degree cap")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of process 0 (default: $SSUMM_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="ranks in the run (default: $SSUMM_NUM_PROCESSES, else one)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank (default: $SSUMM_PROCESS_ID)")
    return ap.parse_args(argv)


def train(args: argparse.Namespace, params=None, cfg=None, keep_state: bool = True) -> Trained:
    """The trainer's run; ``params`` (the port's parameter tree on the run's
    device) replaces the seeded initialisation, ``cfg`` the model config of
    ``--arch``/``--smoke``, when given. Across ranks every rank calls it
    with the same arguments; every rank returns the same losses and state.
    ``keep_state``: return the final global ``(params, AdamWState)``,
    gathered one leaf at a time into rank 0's host memory (every other rank
    gets None; the launcher's :func:`main` asks for none)."""
    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    run = RunConfig(lr=args.lr, total_steps=args.steps,
                    warmup_steps=max(args.steps // 10, 1),
                    checkpoint_every=args.ckpt_every, grad_compress=args.compress)
    own_group, dev = join_process_group(resolve_device(args.device), args.coordinator,
                                        args.num_processes, args.process_id)
    try:
        return _train(args, cfg, run, dev, params, keep_state)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _train(args, cfg, run: RunConfig, dev: torch.device, params,
           keep_state: bool = True) -> Trained:
    world = DataParallel(dev)
    main_rank = world.rank == 0
    plan = plan_mesh(world.size, global_batch=args.batch, want_model=args.want_model)
    rules = make_rules(plan, "train")
    dp, tp = mesh_groups(rules, dev)
    accum = max(args.accum, plan.accum_steps)
    shard = dp.shards(args.batch, accum)
    rows = dp.rows(args.batch, accum)
    model = build_model(cfg, dev)
    fs = Sharded(rules, world.rank, param_shapes(cfg), param_axes(cfg), dp, tp)
    if main_rank:
        print(f"world={world.size} mesh={dict(zip(plan.axes, plan.shape))} "
              f"per_rank_batch={plan.per_device_batch} accum={accum} device={dev}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(args.seed) if params is None else params

    ds = SyntheticTokens(TokenDatasetConfig(vocab=cfg.vocab, seq_len=args.seq,
                                            global_batch=args.batch, seed=args.seed))
    step_fn = build_train_step(model, run, accum, dp if shard else None,
                               tp if tp.size > 1 else None, fs)
    err = init_error_buffers(params) if args.compress == "topk" else None
    ccfg = CompressConfig(args.compress, topk_ratio=run.topk_ratio)
    if args.compress != "none" and main_rank:
        full = payload_bytes(params, CompressConfig("none"))
        wire = payload_bytes(params, ccfg)
        print(f"grad compression {args.compress}: {full / 2**20:.1f} MiB -> "
              f"{wire / 2**20:.1f} MiB per all-reduce payload (asserted against the "
              f"measured wire counter)")
    wire_expected = world.size * payload_bytes(params, ccfg)

    # checkpoints hold the global state: rank 0 writes them; every rank
    # restores rank 0's latest into host memory (the files mapped, not read
    # whole) and copies its shard of each leaf to its device, leaf by leaf
    start_step = 0
    ckpt = None
    restored = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=run.keep_checkpoints)
        if args.resume:
            latest = ckpt.latest_step() if main_rank else None
            step = int(world.gather(torch.tensor(-1 if latest is None else latest,
                                                 device=dev))[0])
            if step >= 0:
                restored, start_step, _ = ckpt.restore(_host_template(params), step=step,
                                                       device="cpu", mmap=True)
                if main_rank:
                    print(f"resumed from step {start_step}")
    if restored is None:
        shards = fs.shard(params)
        opt = adamw_init(shards)
    else:
        shards = fs.shard(restored[0], dev)
        opt = AdamWState(restored[1].step.to(dev), fs.shard(restored[1].mu, dev),
                         fs.shard(restored[1].nu, dev))
    del params, restored
    stored = fs.stored_bytes(shards)

    def global_state():
        """The global ``(params, AdamWState)`` (collective): in rank 0's host
        memory, gathered one leaf at a time, None on every other rank; in a
        world of one the state itself, on its device."""
        p = fs.full_to_host(shards)
        mu, nu = fs.full_to_host(opt.mu), fs.full_to_host(opt.nu)
        if p is None:
            return None
        return p, AdamWState(opt.step.cpu() if world.size > 1 else opt.step, mu, nu)

    guard = PreemptionGuard()
    monitor = StragglerMonitor()
    monitor.on_straggler(lambda ev: print(f"  [straggler] step {ev.step}: "
                                          f"{ev.step_time:.2f}s = {ev.ratio:.1f}x mean"))

    losses, step_s = [], []
    preempted = False
    wire_per_step = None
    t_begin = time.time()
    try:
        for step in range(start_step, args.steps):
            monitor.begin_step()
            batch = {"tokens": to_device(ds.batch(step)[rows].astype(np.int64), dev)}
            shards, opt, err, metrics = step_fn(shards, opt, batch, err)
            loss = float(metrics["loss"])  # the step's one host sync
            wire_per_step = metrics["wire_bytes"]
            losses.append(loss)
            step_s.append(monitor.end_step(step))
            if main_rank and (step % args.log_every == 0 or step == args.steps - 1):
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e}", flush=True)
            if ckpt and (step + 1) % run.checkpoint_every == 0:
                state = global_state()
                if main_rank:
                    ckpt.save_async(step + 1, state, copy=world.size == 1)
                del state
            # every rank stops at the same step (a signal lands on one rank)
            if global_preempt(guard.preempted):
                preempted = True
                # a step just queued for the writer thread is committed there;
                # saving it here too would race that write
                queued = (step + 1) % run.checkpoint_every == 0
                state = global_state() if ckpt and not queued else None
                if main_rank:
                    print("preemption signal: saving + exiting")
                    if ckpt:
                        ckpt.wait()
                        if state is not None:
                            ckpt.save(step + 1, state, copy=world.size == 1)
                del state
                break
        # the loop has saved the step it ended at, every --ckpt-every or on a signal
        end = start_step + len(losses)
        saved = bool(losses) and (preempted or end % run.checkpoint_every == 0)
        params = opt_state = None
        if keep_state or (ckpt and not saved):
            params, opt_state = global_state() or (None, None)
        if ckpt and main_rank:
            ckpt.wait()
            if not saved and ckpt.latest_step() != end:
                ckpt.save(end, (params, opt_state), copy=world.size == 1)
        world.barrier()  # the last commit is on disk before any rank returns
    finally:
        guard.restore()
    wall = time.time() - t_begin
    result = {
        "arch": cfg.name, "steps": len(losses), "wall_s": wall,
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "stragglers": len(monitor.events),
        "device": str(dev),
        "p50_step_s": float(np.median(step_s)) if step_s else None,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        "world": world.size,
        "mesh": dict(zip(plan.axes, plan.shape)),
        "stored_bytes_per_rank": stored,
    }
    if args.compress != "none" and losses:
        # the wire bytes the all-reduce measured must equal what payload_bytes
        # prices, a rank's payload (the whole gradient) times every rank
        if not np.isclose(wire_per_step, wire_expected, rtol=1e-6):
            raise AssertionError(f"wire accounting drift: measured {wire_per_step:.0f} B per "
                                 f"step, payload_bytes prices {wire_expected:.0f} B")
        result["wire_bytes_per_step"] = wire_per_step
        result["wire_bytes_expected"] = wire_expected
    return Trained(result=result, params=params, opt=opt_state, losses=losses, step_s=step_s,
                   rank=world.rank, shards=shards, step=int(opt.step))


def _host_template(params):
    """``(params, AdamWState)``'s shapes and dtypes as ``meta`` tensors: a
    restore template that allocates nothing."""
    def meta(x, dtype=None):
        return torch.empty(x.shape, dtype=dtype or x.dtype, device="meta")

    moment = functools.partial(tree_map, lambda x: meta(x, torch.float32))
    step = torch.empty((), dtype=torch.int32, device="meta")
    return tree_map(meta, params), AdamWState(step, moment(params), moment(params))


def main(argv=None, params=None) -> dict:
    """Run the trainer; rank 0 prints the JSON line (every rank returns it)."""
    out = train(parse_args(argv), params, keep_state=False)
    if out.rank == 0:
        print(json.dumps(out.result))
    return out.result


if __name__ == "__main__":
    main()
