"""Training with tensor parallelism and sharded storage, the port against the
reference on a (data, model) XLA host mesh: the helper of
``tests/test_torch_train_tp.py``.

    PYTHONPATH=src python tests/torch_train_tp_check.py reference PART OUT.pkl

runs part ``PART`` (0 or 1; the two run side by side) of the reference side
in a process of its own with 4 XLA host devices and writes a pickle: for
every case of the part's :data:`TRAIN_CASES`, the reference trainer's loop
(``build_train_step``, jitted, on the mesh of ``plan_mesh(4, 8,
want_model)``, the parameters placed by ``_tree_shardings(make_rules(mesh,
"train"), ...)`` and the batch sharded as its ``main`` shards it): per-step
losses, the final global parameters, and the index of every parameter
leaf's shard on the device at each position of the mesh (row-major, which is
the port's rank).

The port's side runs in spawned gloo ranks (``torch_train_dp_check.spawn``):
:func:`case_train` and :func:`case_reshard`.
"""

from __future__ import annotations

import os
import pickle
import shutil
import sys

import numpy as np

DANUBE, GRANITE, ZAMBA2 = "h2o_danube_1_8b", "granite_moe_3b_a800m", "zamba2_7b"
STEPS, BATCH, SEQ, WORLD = 3, 8, 16, 4
# (arch, want_model, accum, compress): want_model 2 plans (data 2, model 2),
# 4 plans (data 1, model 4). Each of danube and granite at both plans and
# both accumulation counts, int8 once, the hybrid once (the other families'
# cases are in tests/torch_train_tp_families_check.py); in two
# parts of about the same compile time
TRAIN_CASES = [
    [(DANUBE, 2, 1, "none"), (DANUBE, 4, 2, "none"), (DANUBE, 2, 1, "int8"),
     (ZAMBA2, 2, 1, "none")],
    [(GRANITE, 2, 1, "none"), (GRANITE, 4, 1, "none"), (GRANITE, 2, 2, "none"),
     (GRANITE, 4, 2, "none")],
]


# ---------------------------------------------------------------------------
# The reference side (a subprocess with 4 XLA host devices)
# ---------------------------------------------------------------------------


def reference(part: int, out_path: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import RunConfig, get_smoke_config
    from repro.data import SyntheticTokens, TokenDatasetConfig
    from repro.dist.sharding import make_rules
    from repro.launch.lowering import _tree_shardings
    from repro.launch.train import build_train_step
    from repro.models.api import build_model
    from repro.optim import adamw_init
    from repro.runtime import plan_mesh

    out = {}
    for arch, want_model, accum, compress in TRAIN_CASES[part]:
        cfg = get_smoke_config(arch)
        run = RunConfig(lr=3e-4, total_steps=STEPS, warmup_steps=max(STEPS // 10, 1),
                        grad_compress=compress)
        plan = plan_mesh(WORLD, global_batch=BATCH, want_model=want_model)
        mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(plan.shape), plan.axes)
        rules = make_rules(mesh, "train")
        model = build_model(cfg)
        key = jax.random.PRNGKey(0)
        structs = jax.eval_shape(model.init, key)
        p_shard = _tree_shardings(rules, structs, model.axes())
        ds = SyntheticTokens(TokenDatasetConfig(vocab=cfg.vocab, seq_len=SEQ,
                                                global_batch=BATCH, seed=0))
        step_fn = jax.jit(build_train_step(model, rules, run, max(accum, plan.accum_steps),
                                           mesh))
        b_shard = rules.sharding(("batch", "seq"), (BATCH, SEQ))
        losses = []
        with mesh:
            params = jax.device_put(model.init(key), p_shard)
            opt = adamw_init(params)
            err = None
            for step in range(STEPS):
                batch = {"tokens": jax.device_put(jnp.asarray(ds.batch(step)), b_shard)}
                params, opt, err, m = step_fn(params, opt, batch, err)
                losses.append(float(m["loss"]))
        devices = list(mesh.devices.flat)
        index = []
        for s, shard in zip(jax.tree.leaves(structs), jax.tree.leaves(p_shard)):
            by_dev = shard.devices_indices_map(s.shape)
            index.append([tuple(sl.indices(n)[:2] for sl, n in zip(by_dev[dv], s.shape))
                          for dv in devices])
        out[(arch, want_model, accum, compress)] = {
            "losses": losses, "wire": float(m["wire_bytes"]), "mesh": dict(mesh.shape),
            "params": [np.asarray(x) for x in jax.tree.leaves(params)], "index": index}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# The port's side (spawned gloo ranks)
# ---------------------------------------------------------------------------


def train_argv(arch: str, want_model: int, accum: int = 1, compress: str = "none",
               steps: int = STEPS, *extra) -> list:
    return ["--arch", arch, "--smoke", "--steps", str(steps), "--batch", str(BATCH), "--seq",
            str(SEQ), "--accum", str(accum), "--compress", compress, "--want-model",
            str(want_model), "--device", "cpu", "--log-every", "100", *extra]


def _leaves(tree) -> list:
    from repro_torch.dist.compress import tree_leaves

    return [x.numpy().copy() for x in tree_leaves(tree)]


def case_train(rank: int, world: int, runs: list, weights: dict) -> list:
    """``train.train`` for every ``(arch, argv)`` of ``runs`` from the
    reference's weights; each run's losses, result, rank, final global
    parameters and this rank's stored parameter shards (numpy)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.convert import lm_params_from_numpy
    from repro_torch.launch import train

    out = []
    for arch, argv in runs:
        params = lm_params_from_numpy(weights[arch], get_smoke_config(arch), "cpu")
        res = train.train(train.parse_args(argv), params)
        out.append({"losses": res.losses, "result": res.result, "rank": res.rank,
                    "params": _leaves(res.params), "shards": _leaves(res.shards)})
    return out


def case_reshard(rank: int, world: int, weights: dict, tmp: str) -> dict:
    """Danube smoke over 6 steps on ``(data 2, model 2)``, checkpointed at
    step 3; its step-3 checkpoint resumed on ``(2, 2)``, ``(1, 4)`` and
    ``(4, 1)``. Each run's losses and final global parameters."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.convert import lm_params_from_numpy
    from repro_torch.launch import train

    def run(name, want_model, *extra):
        params = lm_params_from_numpy(weights, get_smoke_config(DANUBE), "cpu")
        argv = train_argv(DANUBE, want_model, 1, "none", 6, "--ckpt-dir",
                          os.path.join(tmp, name), *extra)
        res = train.train(train.parse_args(argv), params)
        return {"losses": res.losses, "params": _leaves(res.params),
                "mesh": res.result["mesh"]}

    out = {"whole": run("whole", 2, "--ckpt-every", "3")}
    if rank == 0:
        for name in ("same", "model4", "data4"):
            shutil.copytree(os.path.join(tmp, "whole", "step_0000000003"),
                            os.path.join(tmp, name, "step_0000000003"))
    dist.barrier()
    for name, want_model in (("same", 2), ("model4", 4), ("data4", 1)):
        out[name] = run(name, want_model, "--ckpt-every", "100", "--resume")
    return out


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] != "reference" or sys.argv[2] not in ("0", "1"):
        raise SystemExit(f"usage: {sys.argv[0]} reference 0|1 OUT.pkl")
    reference(int(sys.argv[2]), sys.argv[3])
