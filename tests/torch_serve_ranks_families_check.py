"""The split decode steps of the hybrid, xLSTM and encoder-decoder families
against the reference on XLA host meshes: the helper of
``tests/test_torch_serve_ranks_families.py``.

    PYTHONPATH=src python tests/torch_serve_ranks_families_check.py reference ARCH OUT.pkl

runs the reference side for one of :data:`ARCHS` in a process of its own
with 4 XLA host devices (the three run side by side) and writes a pickle,
for every ``(want_model, max_len)`` of :data:`PLANS`:

* its ``BatchServer`` under the serve table of ``plan_mesh(4, SLOTS,
  want_model)`` on the ragged stream of ``tests/torch_serve_ranks_check.py``:
  its token lists, the logits of every decode step, its final cache, and the
  index of every parameter and cache leaf's shard on the device at each
  position of the mesh (row-major, which is the port's rank);
* for whisper, :data:`CROSS_STEPS` decode steps of its ``serve_step`` under
  the same table from a cache whose cross K/V are projected from a seeded
  encoder output (:func:`enc_out`), its logits of each step and that cache;

and the token lists of its one-device ``BatchServer`` on the launcher's
request stream of ``tests/torch_serve_ranks_check.py`` at 4 slots.

The port's side runs in spawned gloo ranks (``torch_train_dp_check.spawn``):
:func:`case_families`.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np

import torch_serve_ranks_check as base

ZAMBA2, XLSTM, WHISPER = "zamba2_7b", "xlstm_350m", "whisper_large_v3"
ARCHS = (ZAMBA2, XLSTM, WHISPER)
SLOTS, WORLD = base.SLOTS, base.WORLD
# (want_model, max_len) on 4 ranks: the KV caches split on their positions
# at (1, 4) and (2, 2) (max_len 32); on their KV heads at (2, 2) with 31
# positions; at (1, 4) with 30 positions, on the 4 smoke KV heads of zamba2
# and whisper (the model axis divides them). xLSTM's states split on their 2
# smoke heads at (2, 2) and stay whole at (1, 4).
PLANS = ((4, 32), (2, 32), (2, 31), (4, 30))
CASES = [(a, m, t) for a in ARCHS for m, t in PLANS]
CROSS_STEPS = 3


def enc_out(cfg) -> np.ndarray:
    """The seeded encoder output [SLOTS, enc_len, d] the cross K/V come from."""
    rng = np.random.default_rng(7)
    return rng.standard_normal((SLOTS, cfg.enc_len, cfg.d_model)).astype(np.float32)


def cross_inputs(cfg, max_len: int) -> list:
    """Each cross-cache step's tokens and per-slot positions."""
    rng = np.random.default_rng(8)
    return [(rng.integers(0, cfg.vocab, SLOTS).astype(np.int32),
             np.array([t, t + 5, t + 11, max_len - 1 - t], np.int32))
            for t in range(CROSS_STEPS)]


# ---------------------------------------------------------------------------
# The reference side (a subprocess with 4 XLA host devices)
# ---------------------------------------------------------------------------


def reference(arch: str, out_path: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.dist.sharding import make_rules
    from repro.launch.serve import BatchServer, Request
    from repro.models import attention as ref_attn
    from repro.runtime import plan_mesh

    cfg = get_smoke_config(arch)
    out = {}
    for want_model, max_len in PLANS:
        mesh = base._mesh(jax, plan_mesh(WORLD, global_batch=SLOTS, want_model=want_model))
        rules = make_rules(mesh, "serve")
        server = BatchServer(cfg, slots=SLOTS, max_len=max_len, rules=rules, seed=base.SEED)
        logits, run = [], server._run

        def recorded(token, pos, run=run, logits=logits):
            lg = run(token, pos)
            logits.append(np.array(lg))
            return lg

        server._run = recorded
        with mesh:
            tokens = base.drain(server, base.ragged_stream(cfg.vocab, Request))
        devices = list(mesh.devices.flat)
        model = server.model
        p_axes = jax.tree.leaves(model.axes(), is_leaf=lambda x: isinstance(x, tuple))
        c_axes = jax.tree.leaves(model.cache_axes(), is_leaf=lambda x: isinstance(x, tuple))
        params, cache = jax.tree.leaves(server.params), jax.tree.leaves(server.cache)
        res = {"tokens": tokens, "logits": logits, "mesh": dict(mesh.shape),
               "cache": [np.asarray(x) for x in cache],
               "param_index": base._index([rules.sharding(a, x.shape) for a, x in
                                           zip(p_axes, params)], params, devices),
               "cache_index": base._index([rules.sharding(a, x.shape) for a, x in
                                           zip(c_axes, cache)], cache, devices)}
        if arch == WHISPER:  # decode steps from a non-zero cross cache
            filled = model.init_cache(SLOTS, max_len)
            enc = jnp.asarray(enc_out(cfg))
            for i in range(cfg.n_layers):
                k, v = ref_attn.project_cross_kv(server.params[f"dec_{i}"]["cross_attn"], enc)
                filled[f"dec_{i}"] = dict(filled[f"dec_{i}"], xk=k, xv=v)
            res["cross_cache"] = jax.tree.map(np.asarray, filled)
            step = jax.jit(lambda p, c, t, q: model.serve_step(
                p, {"token": t, "pos": q, "cache": c}, rules))
            cross = []
            with mesh:
                for token, pos in cross_inputs(cfg, max_len):
                    lg, filled = step(server.params, filled, jnp.asarray(token), jnp.asarray(pos))
                    cross.append(np.asarray(lg))
            res["cross_logits"] = cross
        out[(arch, want_model, max_len)] = res
    # the launcher's stream on one device: its tokens
    server = BatchServer(cfg, slots=SLOTS, max_len=base.MAX_LEN, seed=base.SEED)
    out[(arch, "launch")] = base.drain(server, base.launch_stream(cfg.vocab, Request))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# The port's side (spawned gloo ranks)
# ---------------------------------------------------------------------------


def case_families(rank: int, world: int, weights: dict) -> dict:
    """For every case of :data:`CASES`, from the reference's weights:
    ``BatchServer`` under the serve table of ``plan_mesh(4, SLOTS,
    want_model)`` on the ragged stream (its token lists, this rank's logits
    of every decode step, its slots, its parameter shards, its cache shards
    as made and after the stream, numpy); for whisper, this rank's logits
    of :data:`CROSS_STEPS` decode steps from its shard of a cache whose
    cross K/V ``whisper.fill_cross_cache`` filled from :func:`enc_out`; and
    the launcher's token lists and plan at ``--want-model`` 2 and 4."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.convert import lm_params_from_numpy
    from repro_torch.dist.sharding import make_rules
    from repro_torch.launch import serve
    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.models import whisper
    from repro_torch.models.api import shard_cache
    from repro_torch.runtime import plan_mesh

    out = {}
    for arch, want_model, max_len in CASES:
        cfg = get_smoke_config(arch)
        rules = make_rules(plan_mesh(world, global_batch=SLOTS, want_model=want_model), "serve")
        params = lm_params_from_numpy(weights[arch], cfg, "cpu")
        server = BatchServer(cfg, slots=SLOTS, max_len=max_len, device="cpu", rules=rules,
                             params=params)
        init_cache = base._numpy(server.cache)
        logits, decode = [], server.model.decode

        def recorded(*a, decode=decode, logits=logits):
            lg, cache = decode(*a)
            logits.append(lg.numpy().copy())
            return lg, cache

        server.model = dataclasses.replace(server.model, decode=recorded)
        tokens = base.drain(server, base.ragged_stream(cfg.vocab, Request))
        res = {"tokens": tokens, "logits": logits, "slot0": server.slot0,
               "local_slots": server.local_slots, "model_rank": rules.coords(rank)["model"],
               "params": base._numpy(server.params), "init_cache": init_cache,
               "cache": base._numpy(server.cache)}
        if arch == WHISPER:
            model = dataclasses.replace(server.model, decode=decode)  # not recorded
            filled = whisper.fill_cross_cache(params, model.init_cache(SLOTS, max_len),
                                              torch.from_numpy(enc_out(cfg)), cfg)
            cache = shard_cache(model, rules, rank, SLOTS, max_len, filled)
            res["cross_cache"] = base._numpy(cache)
            mine = slice(server.slot0, server.slot0 + server.local_slots)
            cross = []
            with torch.no_grad():
                for token, pos in cross_inputs(cfg, max_len):
                    lg, cache = model.serve_step(server.params, {
                        "token": torch.as_tensor(token[mine], dtype=torch.int64),
                        "pos": torch.as_tensor(pos[mine], dtype=torch.int64),
                        "cache": cache}, server.tp, max_len)
                    cross.append(lg.numpy().copy())
            res["cross_logits"] = cross
        out[(arch, want_model, max_len)] = res
    for arch in ARCHS:  # the launcher at --want-model 2 and 4
        params = lm_params_from_numpy(weights[arch], get_smoke_config(arch), "cpu")
        for want_model in (2, 4):
            argv = base.launch_argv(arch, SLOTS) + ["--want-model", str(want_model)]
            result, server = serve.serve(serve.parse_args(argv), params)
            out[(arch, "launch", want_model)] = {
                "tokens": {r.rid: list(r.out) for r in server.done}, "plan": result["plan"]}
    return out


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] != "reference" or sys.argv[2] not in ARCHS:
        raise SystemExit(f"usage: {sys.argv[0]} reference {'|'.join(ARCHS)} OUT.pkl")
    reference(sys.argv[2], sys.argv[3])
