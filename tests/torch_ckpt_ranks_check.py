"""Checkpoints of a sharded training state across gloo ranks: the helper of
``tests/test_torch_ckpt_ranks.py``.

:func:`case_save` runs the trainer on spawned gloo ranks
(``torch_train_dp_check.spawn``) with ``--ckpt-dir``, recording every
tensor each rank hands to ``torch.distributed.gather`` (the one-leaf
gather, ``Sharded.full_to_host``), then again with the gather the trainer
used before it (``Sharded.full`` on every rank, rank 0 writing), and resumes
the first run's checkpoint on the same plan and on another, with the host
restore and with the restore it replaced (the whole state restored onto each
rank's device, then sharded).
"""

from __future__ import annotations

import os
import shutil

DANUBE = "h2o_danube_1_8b"
STEPS, BATCH, SEQ = 4, 8, 16


def argv(want_model: int, ckpt: str, steps: int = STEPS, *extra) -> list:
    return ["--arch", DANUBE, "--smoke", "--steps", str(steps), "--batch", str(BATCH), "--seq",
            str(SEQ), "--want-model", str(want_model), "--device", "cpu", "--log-every", "100",
            "--ckpt-dir", ckpt, "--ckpt-every", "2", *extra]


def _pre_repair_gather(self, shards, dst: int = 0):
    """The trainer's gather before ``full_to_host``: every leaf whole on
    every rank, rank ``dst`` keeping them."""
    full = self.full(shards)
    return full if self.rank == dst else None


def _pre_repair_template(params):
    """The restore template before the host restore: the parameters and
    their zero moments, whole on the device."""
    from repro_torch.optim import adamw_init

    return params, adamw_init(params)


def case_save(rank: int, world: int, weights: dict, tmp: str, want_model: int,
              other_model: int) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.convert import lm_params_from_numpy
    from repro_torch.dist import fsdp
    from repro_torch.dist.compress import tree_leaves
    from repro_torch.launch import train
    from repro_torch.runtime import checkpoint

    cfg = get_smoke_config(DANUBE)
    sent = []
    gather = dist.gather

    def recording(tensor, gather_list=None, dst=0, **kw):
        sent.append((tuple(tensor.shape), gather_list is not None))
        return gather(tensor, gather_list, dst, **kw)

    def run(name, wm, steps=STEPS, *extra, old=False):
        params = lm_params_from_numpy(weights, cfg, "cpu")
        saved = (fsdp.Sharded.full_to_host, train._host_template, checkpoint.CheckpointManager
                 .restore)
        if old:
            fsdp.Sharded.full_to_host = _pre_repair_gather
            train._host_template = _pre_repair_template
            restore = saved[2]
            checkpoint.CheckpointManager.restore = (
                lambda self, t, step=None, device=None, mmap=False: restore(self, t, step))
        try:
            res = train.train(train.parse_args(argv(wm, os.path.join(tmp, name), steps,
                                                    *extra)), params)
        finally:
            (fsdp.Sharded.full_to_host, train._host_template,
             checkpoint.CheckpointManager.restore) = saved
        return {"losses": res.losses, "step": res.step,
                "params": [x.numpy().copy() for x in tree_leaves(res.params)],
                "on_host": res.params is not None and all(
                    x.device.type == "cpu" for x in tree_leaves((res.params, res.opt))),
                "shards": [tuple(x.shape) for x in tree_leaves(res.shards)]}

    dist.gather = recording
    try:
        out = {"new": run("new", want_model)}
    finally:
        dist.gather = gather
    out["sent"] = sent
    out["old"] = run("old", want_model, old=True)
    if rank == 0:  # the resumed runs start from the first run's step-2 checkpoint
        for name in ("same", "other", "other_old"):
            shutil.copytree(os.path.join(tmp, "new", "step_0000000002"),
                            os.path.join(tmp, name, "step_0000000002"))
    dist.barrier()
    out["same"] = run("same", want_model, STEPS, "--resume")
    out["other"] = run("other", other_model, STEPS, "--resume")
    out["other_old"] = run("other_old", other_model, STEPS, "--resume", old=True)
    out["world"] = world
    out["largest_shard"] = max(int(np.prod(s)) for s in out["new"]["shards"])
    return out
