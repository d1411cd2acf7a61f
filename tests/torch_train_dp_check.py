"""Multi-rank training of the port against the reference on an XLA host
mesh: the helper of ``tests/test_torch_train_dp.py``.

    PYTHONPATH=src python tests/torch_train_dp_check.py reference PART OUT.pkl

runs part ``PART`` (0 or 1; the two run side by side) of the reference side
in a process of its own with 4 XLA host devices (jax fixes its device count
when it starts) and writes a pickle:

  * for every case of the part's :data:`TRAIN_CASES`, the reference trainer's loop
    (``build_train_step``, jitted, on the mesh of ``plan_mesh(P,
    want_model=1)``, the batch sharded as its ``main`` shards it): per-step
    losses and the last step's measured wire bytes;
  * in part 1, for P in 2 and 4, its jitted ``apply_moe_gspmd(p, x, cfg,
    rules)`` on a ``(P, 1)`` data mesh with ``x`` sharded over the batch, at
    the default capacity factor (records drop): ``y``, ``moe_aux``,
    ``moe_drop_frac``.

The port's side runs in spawned gloo ranks: :func:`spawn` runs a case
function (:func:`case_train`, :func:`case_preempt_resume`,
:func:`case_moe_block`, or another test helper's) on P child processes joined through a ``file://`` store and
returns each rank's result in rank order.
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile

import numpy as np

DANUBE, GRANITE = "h2o_danube_1_8b", "granite_moe_3b_a800m"
STEPS, BATCH, SEQ = 3, 8, 16
# (arch, P, accum, compress): the reference trainer's runs, in two parts of
# about the same compile time. Each arch at both world sizes and both
# accumulation counts, each codec once (a compile is ~9 s of the reference's
# CPU time, so not the full cross product)
TRAIN_CASES = [
    [(DANUBE, 2, 1, "none"), (DANUBE, 4, 2, "none"), (DANUBE, 2, 1, "int8"),
     (DANUBE, 4, 1, "topk")],
    [(GRANITE, 2, 2, "none"), (GRANITE, 4, 1, "none"), (GRANITE, 4, 2, "none")],
]
BLOCK_SHAPE = (8, 8)  # the MoE block's [B, S]; B splits over 4 ranks


def block_inputs(d: int) -> np.ndarray:
    """Normal activations around one shared direction, as hidden states sit,
    so that the router favours some experts and the capacity binds."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((*BLOCK_SHAPE, d)) + rng.standard_normal(d)).astype(np.float32)


# ---------------------------------------------------------------------------
# The reference side (a subprocess with 4 XLA host devices)
# ---------------------------------------------------------------------------


def reference(part: int, out_path: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import RunConfig, get_smoke_config
    from repro.data import SyntheticTokens, TokenDatasetConfig
    from repro.dist.compress import init_error_buffers
    from repro.dist.sharding import make_rules
    from repro.launch.train import build_train_step
    from repro.models import moe as ref_moe
    from repro.models.api import build_model
    from repro.optim import adamw_init
    from repro.runtime import plan_mesh

    def mesh_of(shape, axes):
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)

    out = {"train": {}, "block": {}}
    for arch, n_dev, accum, compress in TRAIN_CASES[part]:
        cfg = get_smoke_config(arch)
        run = RunConfig(lr=3e-4, total_steps=STEPS, warmup_steps=max(STEPS // 10, 1),
                        grad_compress=compress)
        plan = plan_mesh(n_dev, global_batch=BATCH, want_model=1)
        mesh = mesh_of(plan.shape, plan.axes)
        rules = make_rules(mesh, "train")
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        opt = adamw_init(params)
        ds = SyntheticTokens(TokenDatasetConfig(vocab=cfg.vocab, seq_len=SEQ,
                                                global_batch=BATCH, seed=0))
        step_fn = jax.jit(build_train_step(model, rules, run, max(accum, plan.accum_steps),
                                           mesh))
        err = init_error_buffers(params) if compress == "topk" else None
        b_shard = rules.sharding(("batch", "seq"), (BATCH, SEQ))
        losses = []
        with mesh:
            for step in range(STEPS):
                batch = {"tokens": jax.device_put(jnp.asarray(ds.batch(step)), b_shard)}
                params, opt, err, m = step_fn(params, opt, batch, err)
                losses.append(float(m["loss"]))
        out["train"][(arch, n_dev, accum, compress)] = {"losses": losses,
                                                        "wire": float(m["wire_bytes"])}
    if part == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
        return

    cfg = get_smoke_config(GRANITE)
    p = {k: getattr(v, "value", v) for k, v in
         ref_moe.init_moe(jax.random.PRNGKey(1), cfg, jnp.float32).items()}
    x = block_inputs(cfg.d_model)
    out["block"]["params"] = {k: np.asarray(v) for k, v in p.items()}
    out["block"]["x"] = x
    for n_dev in (2, 4):
        mesh = mesh_of((n_dev, 1), ("data", "model"))
        rules = make_rules(mesh, "train")
        with mesh:
            xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
            y, aux = jax.jit(lambda p_, x_: ref_moe.apply_moe_gspmd(p_, x_, cfg, rules))(p, xs)
        out["block"][n_dev] = {"y": np.asarray(y), "moe_aux": float(aux["moe_aux"]),
                               "moe_drop_frac": float(aux["moe_drop_frac"])}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# The port's side (spawned gloo ranks)
# ---------------------------------------------------------------------------


def train_argv(arch: str, accum: int, compress: str = "none", batch: int = BATCH) -> list:
    return ["--arch", arch, "--smoke", "--steps", str(STEPS), "--batch", str(batch),
            "--seq", str(SEQ), "--accum", str(accum), "--compress", compress,
            "--device", "cpu", "--log-every", "100"]


def case_train(rank: int, world: int, runs: list, weights: dict) -> list:
    """``train.train`` for every ``(arch, argv)`` of ``runs`` from the
    reference's weights (``weights[arch]``, numpy); each run's losses,
    result, rank and final parameters (numpy)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.convert import lm_params_from_numpy
    from repro_torch.dist.compress import tree_leaves
    from repro_torch.launch import train

    out = []
    for arch, argv in runs:
        params = lm_params_from_numpy(weights[arch], get_smoke_config(arch), "cpu")
        res = train.train(train.parse_args(argv), params)
        out.append({"losses": res.losses, "result": res.result, "rank": res.rank,
                    "params": [x.numpy().copy() for x in tree_leaves(res.params)]})
    return out


def case_preempt_resume(rank: int, world: int, weights: dict, tmp: str) -> dict:
    """Granite smoke, 4 steps with checkpoints every 2, three ways: whole;
    with a preemption signal on the last rank only, seen at its second poll
    (after step 1); resumed from what that run saved. Each run's losses,
    steps and final parameters."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.convert import lm_params_from_numpy
    from repro_torch.dist.compress import tree_leaves
    from repro_torch.launch import train
    from repro_torch.runtime import PreemptionGuard

    class SignalledAtSecondPoll(PreemptionGuard):
        polls = 0

        @property
        def preempted(self) -> bool:
            self.polls += 1
            return rank == world - 1 and self.polls >= 2

    def argv(ckpt: str, *extra) -> list:
        return ["--arch", GRANITE, "--smoke", "--steps", "4", "--batch", str(BATCH), "--seq",
                str(SEQ), "--accum", "2", "--device", "cpu", "--log-every", "100",
                "--ckpt-dir", os.path.join(tmp, ckpt), "--ckpt-every", "2", *extra]

    out = {}
    for name, ckpt, extra in (("whole", "a", ()), ("preempted", "b", ()),
                              ("resumed", "b", ("--resume",))):
        params = lm_params_from_numpy(weights, get_smoke_config(GRANITE), "cpu")
        guard = train.PreemptionGuard
        if name == "preempted":
            train.PreemptionGuard = SignalledAtSecondPoll
        try:
            res = train.train(train.parse_args(argv(ckpt, *extra)), params)
        finally:
            train.PreemptionGuard = guard
        out[name] = {"losses": res.losses, "steps": res.step,
                     "params": [x.numpy().copy() for x in tree_leaves(res.params)]}
    return out


def case_moe_block(rank: int, world: int, params: dict, x: np.ndarray) -> dict:
    """Granite's smoke MoE block on this rank's rows of ``x``, under the
    data-parallel group and without it (rank-local)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.dist.data_parallel import DataParallel
    from repro_torch.models import moe

    cfg = get_smoke_config(GRANITE)
    dp = DataParallel("cpu")
    rows = dp.rows(x.shape[0], 1)
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    xl = torch.as_tensor(x[rows])
    out = {}
    for name, group in (("group", dp), ("local", None)):
        y, aux = moe.apply_moe_gspmd(p, xl, cfg, group=group)
        out[name] = {"y": y.numpy(), "moe_aux": float(aux["moe_aux"]),
                     "moe_drop_frac": float(aux["moe_drop_frac"])}
    return out


def spawn(world: int, case, **kw) -> list:
    """Run ``case(rank, world, **kw)`` (a module-level function) on
    ``world`` gloo ranks in child processes; returns each rank's result, in
    rank order."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="torch-train-dp-") as tmp:
        # the arguments go through a file: a child that dies before reading a
        # large launch payload would leave the parent blocked on its pipe,
        # where a small one lets the join report the dead child
        with open(os.path.join(tmp, "kw.pkl"), "wb") as f:
            pickle.dump(kw, f)
        mp.spawn(_child, args=(world, case, tmp), nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def _child(rank: int, world: int, case, tmp: str) -> None:
    import torch
    import torch.distributed as dist

    with open(os.path.join(tmp, "kw.pkl"), "rb") as f:
        kw = pickle.load(f)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        res = case(rank, world, **kw)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] != "reference" or sys.argv[2] not in ("0", "1"):
        raise SystemExit(f"usage: {sys.argv[0]} reference 0|1 OUT.pkl")
    reference(int(sys.argv[2]), sys.argv[3])
