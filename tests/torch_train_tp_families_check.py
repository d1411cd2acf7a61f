"""Tensor-parallel compute of the hybrid, xLSTM, encoder-decoder and VLM
families, the port against the reference on a (data, model) XLA host mesh:
the helper of ``tests/test_torch_train_tp_families.py``.

    PYTHONPATH=src python tests/torch_train_tp_families_check.py reference PART OUT.pkl

runs part ``PART`` (0 or 1; the two run side by side) of the reference side
in a process of its own with 4 XLA host devices and writes a pickle: for
every case of the part's :data:`CASES`, the reference's jitted
``build_train_step`` on the mesh of ``plan_mesh(4, 8, want_model)``, the
parameters placed by ``_tree_shardings(make_rules(mesh, "train"), ...)``:
per-step losses, the final global parameters and AdamW first moments, and
the index of every
parameter leaf's shard on the device at each position of the mesh
(row-major, the port's rank). zamba2 and xLSTM take the trainer's token
batches (``SyntheticTokens``); whisper and paligemma a batch dict made with
numpy from a seed (:func:`batch_of`), as the reference's ``input_specs``
shapes it.

The port's side runs in spawned gloo ranks (``torch_train_dp_check.spawn``):
:func:`case_train`.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys

import numpy as np

ZAMBA2, XLSTM, WHISPER, PALIGEMMA = ("zamba2_7b", "xlstm_350m", "whisper_large_v3",
                                     "paligemma_3b")
STEPS, BATCH, SEQ, WORLD = 3, 8, 16, 4
# (arch, want_model, heads): want_model 2 plans (data 2, model 2), 4 plans
# (data 1, model 4); heads None keeps the smoke config's, 4 gives the xLSTM
# smoke config 4 heads (its 2 do not split at model 4). zamba2 and xLSTM go
# through the trainer, whisper and paligemma through build_train_step with
# a batch dict; in two parts of about the same compile time
CASES = [
    [(ZAMBA2, 2, None), (ZAMBA2, 4, None), (XLSTM, 2, None), (XLSTM, 4, None), (XLSTM, 2, 4),
     (XLSTM, 4, 4)],
    [(WHISPER, 2, None), (WHISPER, 4, None), (PALIGEMMA, 2, None), (PALIGEMMA, 4, None)],
]
BATCH_DICT = (WHISPER, PALIGEMMA)


def config(get_smoke_config, arch: str, heads):
    """The smoke config of ``arch`` (either package's), with ``heads`` heads
    where given."""
    cfg = get_smoke_config(arch)
    return cfg if heads is None else dataclasses.replace(cfg, n_heads=heads, n_kv_heads=heads)


def batch_of(cfg, step: int) -> dict:
    """Step ``step``'s global batch of the whisper and paligemma cases,
    numpy: tokens and frames (``[B, enc_len, d]``), or tokens after the
    image prefix and the image embeddings (``[B, img_tokens, img_dim]``)."""
    rng = np.random.default_rng(1000 + step)
    if cfg.family == "encdec":
        return {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32),
                "frames": rng.standard_normal((BATCH, cfg.enc_len, cfg.d_model)).astype(
                    np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ - cfg.img_tokens)).astype(np.int32),
            "img_emb": rng.standard_normal((BATCH, cfg.img_tokens, cfg.img_dim)).astype(
                np.float32)}


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
    for arch, want_model, heads in CASES[part]:
        cfg = config(get_smoke_config, arch, heads)
        run = RunConfig(lr=3e-4, total_steps=STEPS, warmup_steps=max(STEPS // 10, 1))
        plan = plan_mesh(WORLD, global_batch=BATCH, want_model=want_model)
        mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(plan.shape), plan.axes)
        rules = make_rules(mesh, "train")
        model = build_model(cfg)
        key = jax.random.PRNGKey(0)
        structs = jax.eval_shape(model.init, key)
        p_shard = _tree_shardings(rules, structs, model.axes())
        ds = SyntheticTokens(TokenDatasetConfig(vocab=cfg.vocab, seq_len=SEQ,
                                                global_batch=BATCH, seed=0))
        step_fn = jax.jit(build_train_step(model, rules, run, max(1, plan.accum_steps), mesh))

        def batch(step):
            if arch not in BATCH_DICT:
                return {"tokens": ds.batch(step)}
            return batch_of(cfg, step)

        losses = []
        with mesh:
            params = jax.device_put(model.init(key), p_shard)
            opt = adamw_init(params)
            err = None
            for step in range(STEPS):
                b = {k: jax.device_put(jnp.asarray(v), rules.sharding(
                    ("batch",) + (None,) * (v.ndim - 1), v.shape)) for k, v in batch(step).items()}
                params, opt, err, m = step_fn(params, opt, b, err)
                losses.append(float(m["loss"]))
        devices = list(mesh.devices.flat)
        index = []
        for s, shard in zip(jax.tree.leaves(structs), jax.tree.leaves(p_shard)):
            by_dev = shard.devices_indices_map(s.shape)
            index.append([tuple(sl.indices(n)[:2] for sl, n in zip(by_dev[dv], s.shape))
                          for dv in devices])
        out[(arch, want_model, heads)] = {
            "losses": losses, "mesh": dict(mesh.shape),
            "params": [np.asarray(x) for x in jax.tree.leaves(params)],
            "mu": [np.asarray(x) for x in jax.tree.leaves(opt.mu)], "index": index}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# The port's side (spawned gloo ranks)
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    from repro_torch.dist.compress import tree_leaves

    return [x.detach().numpy().copy() for x in tree_leaves(tree)]


def _train_argv(arch: str, want_model: int) -> list:
    return ["--arch", arch, "--smoke", "--steps", str(STEPS), "--batch", str(BATCH), "--seq",
            str(SEQ), "--want-model", str(want_model), "--device", "cpu", "--log-every", "100"]


def _setup(cfg, want_model: int) -> dict:
    """What ``launch/train.py::_train`` sets up on this rank for ``cfg`` at
    ``--want-model want_model``: the plan, its groups, the accumulation
    count, this rank's rows, the model and the sharded storage."""
    import torch

    from repro_torch.dist.data_parallel import DataParallel
    from repro_torch.dist.fsdp import Sharded
    from repro_torch.dist.sharding import make_rules
    from repro_torch.launch.mesh import mesh_groups
    from repro_torch.models.api import build_model, param_axes, param_shapes
    from repro_torch.runtime import plan_mesh

    dev = torch.device("cpu")
    world = DataParallel(dev)
    plan = plan_mesh(world.size, global_batch=BATCH, want_model=want_model)
    rules = make_rules(plan, "train")
    dp, tp = mesh_groups(rules, dev)
    accum = max(1, plan.accum_steps)
    return {"plan": plan, "dp": dp, "tp": tp, "accum": accum, "rows": dp.rows(BATCH, accum),
            "model": build_model(cfg, dev),
            "fs": Sharded(rules, world.rank, param_shapes(cfg), param_axes(cfg), dp, tp)}


def _step_loop(cfg, want_model: int, params) -> dict:
    """The trainer's loop through ``train.build_train_step`` on the batch
    dicts of :func:`batch_of`: per-step losses, final global parameters and
    first moments, this rank's stored shards and bytes."""
    import torch

    from repro_torch.configs import RunConfig
    from repro_torch.launch import train
    from repro_torch.optim import adamw_init

    r = _setup(cfg, want_model)
    fs, dp, tp, accum = r["fs"], r["dp"], r["tp"], r["accum"]
    run = RunConfig(lr=3e-4, total_steps=STEPS, warmup_steps=max(STEPS // 10, 1))
    step_fn = train.build_train_step(r["model"], run, accum,
                                     dp if dp.shards(BATCH, accum) else None,
                                     tp if tp.size > 1 else None, fs)
    shards = fs.shard(params)
    opt = adamw_init(shards)
    losses = []
    for step in range(STEPS):
        batch = {k: torch.as_tensor(v[r["rows"]]) for k, v in batch_of(cfg, step).items()}
        batch["tokens"] = batch["tokens"].long()
        shards, opt, _, m = step_fn(shards, opt, batch, None)
        losses.append(float(m["loss"]))
    return {"losses": losses, "mesh": dict(zip(r["plan"].axes, r["plan"].shape)),
            "params": _leaves(fs.full(shards)), "mu": _leaves(fs.full(opt.mu)),
            "shards": _leaves(shards), "stored": fs.stored_bytes(shards)}


def matmul_shapes(cfg, want_model: int, params) -> list:
    """The shapes of the right operands of every ``torch.matmul`` of one
    forward and loss (no gradients) on this rank, on its views of the
    stored leaves and its rows of the first batch, in call order."""
    import torch

    from repro_torch.data import SyntheticTokens, TokenDatasetConfig

    r = _setup(cfg, want_model)
    if cfg.family in ("encdec", "vlm"):
        batch = {k: torch.as_tensor(v[r["rows"]]) for k, v in batch_of(cfg, 0).items()}
    else:
        ds = SyntheticTokens(TokenDatasetConfig(vocab=cfg.vocab, seq_len=SEQ,
                                                global_batch=BATCH, seed=0))
        batch = {"tokens": torch.as_tensor(ds.batch(0)[r["rows"]])}
    batch["tokens"] = batch["tokens"].long()
    views = r["fs"].views(r["fs"].shard(params))
    seen, matmul = [], torch.matmul

    def spy(a, b, *args, **kw):
        seen.append(tuple(b.shape))
        return matmul(a, b, *args, **kw)

    torch.matmul = spy
    try:
        with torch.no_grad():
            r["model"].loss(views, batch, dp=r["dp"], tp=r["tp"])
    finally:
        torch.matmul = matmul
    return seen


def case_train(rank: int, world: int, weights: dict) -> list:
    """Every case of :data:`CASES` from the reference's weights (``weights``
    by ``(arch, heads)``): zamba2 and xLSTM through ``train.train``, whisper
    and paligemma through :func:`_step_loop`. Each case's losses, mesh,
    final global parameters and first moments, this rank's stored shards
    and stored bytes,
    and the matmul operand shapes of one forward (:func:`matmul_shapes`)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.convert import lm_params_from_numpy
    from repro_torch.launch import train

    out = []
    for arch, want_model, heads in [c for part in CASES for c in part]:
        cfg = config(get_smoke_config, arch, heads)
        params = lm_params_from_numpy(weights[(arch, heads)], cfg, "cpu")
        shapes = matmul_shapes(cfg, want_model, params)
        if arch in BATCH_DICT:
            got = _step_loop(cfg, want_model, params)
        else:
            res = train.train(train.parse_args(_train_argv(arch, want_model)), params, cfg=cfg)
            got = {"losses": res.losses, "mesh": res.result["mesh"],
                   "params": _leaves(res.params),
                   "mu": _leaves(res.opt.mu if res.opt is not None else None),
                   "shards": _leaves(res.shards),
                   "stored": res.result["stored_bytes_per_rank"]}
        out.append(dict(got, shapes=shapes))
    return out


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] != "reference" or sys.argv[2] not in ("0", "1"):
        raise SystemExit(f"usage: {sys.argv[0]} reference 0|1 OUT.pkl")
    reference(int(sys.argv[2]), sys.argv[3])
