"""The port's trainer (``repro_torch.launch.train``) against the
reference's on the CPU: per-step losses of ``train.train`` from the
reference's smoke weights against the reference trainer's loop
(``build_train_step``, jitted, on a one-device mesh) on the same batches,
with ``--accum 2`` and with ``--compress int8`` (the measured wire bytes
equal to the priced and to the reference's), the JSON line ``main`` prints,
and a run resumed from a checkpoint equal to an uninterrupted one bit for
bit. The losses are held to rtol 1e-5 (float32)."""

from __future__ import annotations

import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as RefRunConfig
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import SyntheticTokens as RefTokens
from repro.data import TokenDatasetConfig as RefTokenConfig
from repro.dist.compress import init_error_buffers as ref_init_error_buffers
from repro.dist.sharding import make_rules
from repro.launch.train import build_train_step as ref_build_train_step
from repro.models.api import build_model as ref_build_model
from repro.optim import adamw_init as ref_adamw_init
from repro.runtime import make_mesh_from_plan, plan_mesh

from repro_torch.configs import get_smoke_config
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.dist.compress import tree_leaves
from repro_torch.launch import train
from repro_torch.runtime import CheckpointManager

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
ARCH = "h2o_danube_1_8b"


@functools.lru_cache(maxsize=None)
def reference_run(steps, batch, seq, accum, compress):
    """The reference trainer's loop (``launch/train.py::main``) on its own
    weights: per-step losses, the wire bytes of the last step."""
    cfg = ref_smoke_config(ARCH)
    run = RefRunConfig(lr=3e-4, total_steps=steps, warmup_steps=max(steps // 10, 1),
                       grad_compress=compress)
    plan = plan_mesh(jax.device_count(), global_batch=batch, want_model=1)
    mesh = make_mesh_from_plan(plan)
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    opt = ref_adamw_init(params)
    ds = RefTokens(RefTokenConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0))
    step_fn = jax.jit(ref_build_train_step(model, make_rules(mesh, "train"), run,
                                           max(accum, plan.accum_steps), mesh))
    err = ref_init_error_buffers(params) if compress == "topk" else None
    losses, wire = [], None
    with mesh:
        for step in range(steps):
            params, opt, err, m = step_fn(params, opt, {"tokens": jnp.asarray(ds.batch(step))},
                                          err)
            losses.append(float(m["loss"]))
            wire = float(m["wire_bytes"])
    return losses, wire


def _argv(steps=6, batch=4, seq=16, *extra):
    return ["--arch", ARCH, "--smoke", "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--device", "cpu", "--log-every", "100", *extra]


def _ref_params():
    """The reference trainer's initial weights (``model.init(PRNGKey(0))``) as
    the port's tree."""
    params = ref_build_model(ref_smoke_config(ARCH)).init(jax.random.PRNGKey(0))
    return lm_params_from_numpy(jax.tree.map(np.asarray, params), get_smoke_config(ARCH), "cpu")


@pytest.mark.parametrize("accum,compress", [(1, "none"), (2, "none"), (1, "int8")])
def test_trainer_losses_track_the_reference(accum, compress):
    out = train.train(train.parse_args(_argv(6, 4, 16, "--accum", str(accum),
                                             "--compress", compress)), _ref_params())
    want, wire = reference_run(6, 4, 16, accum, compress)
    np.testing.assert_allclose(out.losses, want, rtol=LOSS_RTOL)
    assert out.result["steps"] == 6 and out.result["device"] == "cpu"
    if compress != "none":  # a world of one: the wire bytes of one rank's payload
        assert out.result["wire_bytes_per_step"] == out.result["wire_bytes_expected"] == wire


def test_trainer_main_prints_the_reference_keys(capsys):
    res = train.main(_argv(3, 2, 8, "--compress", "topk"))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == res
    assert {"arch", "steps", "wall_s", "loss_first", "loss_last", "stragglers",
            "wire_bytes_per_step", "wire_bytes_expected", "device", "p50_step_s",
            "peak_memory_bytes", "world", "mesh", "stored_bytes_per_rank"} == set(res)
    assert np.isfinite(res["loss_last"]) and res["peak_memory_bytes"] is None


def test_a_resumed_run_equals_an_uninterrupted_one(tmp_path):
    """Eight steps with checkpoints at 4 and 8; the step-8 checkpoint removed
    and the run resumed from step 4: steps 4-7 give the same losses and the
    same parameters and optimizer state, bit for bit."""
    whole = train.train(train.parse_args(_argv(8, 4, 16, "--ckpt-dir", str(tmp_path),
                                               "--ckpt-every", "4")), _ref_params())
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [4, 8]
    shutil.rmtree(tmp_path / "step_0000000008")
    resumed = train.train(train.parse_args(_argv(8, 4, 16, "--ckpt-dir", str(tmp_path),
                                                 "--ckpt-every", "4", "--resume")))
    assert resumed.losses == whole.losses[4:]
    assert int(resumed.opt.step) == int(whole.opt.step) == 8
    for a, b in zip(tree_leaves((resumed.params, resumed.opt)),
                    tree_leaves((whole.params, whole.opt))):
        assert torch.equal(a, b)
