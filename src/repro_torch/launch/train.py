"""The port's trainer: token pipeline → train loop → checkpoint/restart
→ straggler and preemption handling, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o_danube_1_8b --smoke \
        --steps 20 --batch 8 --seq 64 [--accum 2] [--compress int8|topk] \
        [--ckpt-dir DIR --ckpt-every 5 [--resume]] [--device cuda|cpu]

Port of ``repro/launch/train.py`` for a single device. It takes the
reference's flags and builds its ``RunConfig`` (warm-up a tenth of the
steps); the reference's mesh, shardings, TP cap (``--want-model``) and XLA
flags have no counterpart: the port trains on one device. Each step takes
the gradients of ``Model.loss`` (``torch.autograd``; every block under
``torch.utils.checkpoint`` when ``RunConfig.remat``), averaged over
``--accum`` microbatches in float32, and applies AdamW at the cosine
schedule's rate for the step being taken. ``--compress int8|topk`` sends
the gradients through ``dist.compress.compressed_all_reduce`` over a world
of one (the codec's round trip; the wire bytes it measures must equal
``payload_bytes``). Checkpoints hold ``(params, AdamWState)``: keep-N,
written asynchronously every ``--ckpt-every`` steps, and at the step
reached when the loop ends unless that step was just saved (the reference
saves again, at ``--steps``); ``--resume`` restores the latest and
regenerates the token stream from that step. SIGTERM/SIGINT saves and stops
at the next step. It prints the reference's JSON keys plus ``device``, the
median step and the peak device memory. It runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import RunConfig, get_config, get_smoke_config
from repro_torch.core.query_engine import RankSet
from repro_torch.data import SyntheticTokens, TokenDatasetConfig
from repro_torch.data.loader import to_device
from repro_torch.dist import CompressConfig, compressed_all_reduce, microbatch_grads
from repro_torch.dist.compress import init_error_buffers, payload_bytes, tree_map
from repro_torch.models.api import build_model
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.runtime import CheckpointManager, PreemptionGuard, StragglerMonitor


def build_train_step(model, run: RunConfig, accum: int):
    """``step_fn(params, opt, batch, err) -> (params, opt, err, metrics)``."""

    def loss_fn(p, b):
        return model.loss(p, b, remat=run.remat)

    compress = run.grad_compress
    ranks = RankSet(model.device, ranks=1) if compress != "none" else None
    ccfg = CompressConfig(compress, topk_ratio=run.topk_ratio)

    def step_fn(params, opt, batch, err):
        loss, _aux, grads = microbatch_grads(loss_fn, params, batch, accum)
        wire_bytes = 0.0
        if compress != "none":
            # each rank contributes grads / P; P = 1 here
            n = torch.full((), ranks.size, dtype=torch.float32, device=model.device)
            contrib = tree_map(lambda x: x / n.to(x.dtype), grads)
            grads, err, wire_bytes = compressed_all_reduce(contrib, err, ccfg, ranks)
        lr = cosine_schedule(opt.step + 1, base_lr=run.lr, warmup=run.warmup_steps,
                             total=run.total_steps, min_ratio=run.lr_min_ratio)
        params, opt, om = adamw_update(grads, opt, params, lr=lr,
                                       weight_decay=run.weight_decay, grad_clip=run.grad_clip)
        return params, opt, err, {"loss": loss, "wire_bytes": float(wire_bytes), **om}

    return step_fn


@dataclasses.dataclass
class Trained:
    """A run's printed result, its final state and every step's loss and wall."""

    result: dict
    params: dict
    opt: object
    losses: list
    step_s: list


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
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def train(args: argparse.Namespace, params=None, cfg=None) -> Trained:
    """The trainer's run; ``params`` (the port's parameter tree on the run's
    device) replaces the seeded initialisation, ``cfg`` the model config of
    ``--arch``/``--smoke``, when given."""
    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    run = RunConfig(lr=args.lr, total_steps=args.steps,
                    warmup_steps=max(args.steps // 10, 1),
                    checkpoint_every=args.ckpt_every, grad_compress=args.compress)
    model = build_model(cfg, args.device)
    dev = model.device
    print(f"device={dev} batch={args.batch} accum={args.accum}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(args.seed) if params is None else params
    opt = adamw_init(params)

    ds = SyntheticTokens(TokenDatasetConfig(vocab=cfg.vocab, seq_len=args.seq,
                                            global_batch=args.batch, seed=args.seed))
    step_fn = build_train_step(model, run, max(args.accum, 1))
    err = init_error_buffers(params) if args.compress == "topk" else None
    ccfg = CompressConfig(args.compress, topk_ratio=run.topk_ratio)
    if args.compress != "none":
        full = payload_bytes(params, CompressConfig("none"))
        wire = payload_bytes(params, ccfg)
        print(f"grad compression {args.compress}: {full / 2**20:.1f} MiB -> "
              f"{wire / 2**20:.1f} MiB per all-reduce payload (asserted against the "
              f"measured wire counter)")

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=run.keep_checkpoints)
        if args.resume and ckpt.latest_step() is not None:
            (params, opt), start_step, _ = ckpt.restore((params, opt))
            print(f"resumed from step {start_step}")
    guard = PreemptionGuard()
    monitor = StragglerMonitor()
    monitor.on_straggler(lambda ev: print(f"  [straggler] step {ev.step}: "
                                          f"{ev.step_time:.2f}s = {ev.ratio:.1f}x mean"))

    losses, step_s = [], []
    wire_per_step = None
    t_begin = time.time()
    try:
        for step in range(start_step, args.steps):
            monitor.begin_step()
            batch = {"tokens": to_device(ds.batch(step).astype(np.int64), dev)}
            params, opt, err, metrics = step_fn(params, opt, batch, err)
            loss = float(metrics["loss"])  # the step's one host sync
            wire_per_step = metrics["wire_bytes"]
            losses.append(loss)
            step_s.append(monitor.end_step(step))
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e}", flush=True)
            if ckpt and (step + 1) % run.checkpoint_every == 0:
                ckpt.save_async(step + 1, (params, opt))
            if guard.preempted:
                print("preemption signal: saving + exiting")
                if ckpt:
                    ckpt.save(step + 1, (params, opt))
                break
        if ckpt:
            ckpt.wait()
            if ckpt.latest_step() != start_step + len(losses):  # not saved by the loop
                ckpt.save(start_step + len(losses), (params, opt))
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
    }
    if args.compress != "none" and losses:
        # the wire bytes the all-reduce measured must equal what payload_bytes
        # prices, a rank's payload times every rank (one here)
        expected = payload_bytes(params, ccfg)
        if not np.isclose(wire_per_step, expected, rtol=1e-6):
            raise AssertionError(f"wire accounting drift: measured {wire_per_step:.0f} B per "
                                 f"step, payload_bytes prices {expected:.0f} B")
        result["wire_bytes_per_step"] = wire_per_step
        result["wire_bytes_expected"] = expected
    return Trained(result=result, params=params, opt=opt, losses=losses, step_s=step_s)


def main(argv=None, params=None) -> dict:
    out = train(parse_args(argv), params)
    print(json.dumps(out.result))
    return out.result


if __name__ == "__main__":
    main()
