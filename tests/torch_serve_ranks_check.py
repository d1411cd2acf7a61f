"""Serving across ranks, the port against the reference on XLA host meshes:
the helper of ``tests/test_torch_serve_ranks.py``.

    PYTHONPATH=src python tests/torch_serve_ranks_check.py reference PART OUT.pkl

runs part ``PART`` (0, 1 or 2; the three run side by side) of the reference
side in a process of its own with 4 XLA host devices and writes a pickle:

* parts 0 and 1, for each half of :data:`LAUNCH_CASES`: the reference's
  ``BatchServer`` as its launcher builds it (``plan_mesh(world, slots,
  want_model=1)``, ``make_rules(mesh, "serve")``, the launcher's request
  stream), its token lists;
* part 2, for every case of :data:`SPLIT_CASES`: its ``BatchServer`` under
  the serve table of ``plan_mesh(4, SLOTS, want_model)`` on a ragged stream,
  its token lists, the logits of every decode step, its final cache, and
  the index of every parameter and cache leaf's shard on the device at each
  position of the mesh (row-major, which is the port's rank).

The port's side runs in spawned gloo ranks (``torch_train_dp_check.spawn``):
:func:`case_launch` and :func:`case_split`.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np

QWEN, GRANITE, ZAMBA2 = "qwen2_5_14b", "granite_moe_3b_a800m", "zamba2_7b"
XLSTM, PALIGEMMA, WHISPER = "xlstm_350m", "paligemma_3b", "whisper_large_v3"
ARCHS = (QWEN, GRANITE, ZAMBA2, XLSTM, PALIGEMMA, WHISPER)
# the launcher's request stream: --requests 5 --prompt-len 3 --gen-len 5 --max-len 32
REQUESTS, PROMPT, GEN, MAX_LEN, SEED = 5, 3, 5, 32, 0
# (arch, slots, world): every family at 4 slots over 2 and 4 ranks (a block
# of slots a rank), and slots the data ranks do not divide (every rank
# serves every slot)
LAUNCH_CASES = [(a, 4, w) for a in ARCHS for w in (2, 4)] + [
    (QWEN, 3, 2), (GRANITE, 2, 4), (ZAMBA2, 3, 2), (WHISPER, 3, 4)]
# (arch, want_model, max_len) on 4 ranks, 4 slots: the cache split on its
# positions at (1, 4) and (2, 2); max_len 31 at (2, 2) moves the split to
# the KV heads; max_len 30 at (1, 4), which neither the positions nor the 2
# smoke KV heads divide, keeps the cache whole
SLOTS, WORLD = 4, 4
SPLIT_CASES = [(a, m, t) for a in (QWEN, GRANITE)
               for m, t in ((4, 32), (2, 32), (2, 31), (4, 30))]


def launch_argv(arch: str, slots: int) -> list:
    return ["--arch", arch, "--smoke", "--device", "cpu", "--requests", str(REQUESTS),
            "--slots", str(slots), "--prompt-len", str(PROMPT), "--gen-len", str(GEN),
            "--max-len", str(MAX_LEN), "--seed", str(SEED)]


def launch_stream(vocab: int, cls) -> list:
    """The launcher's requests (``launch/serve.py::_serve``)."""
    rng = np.random.default_rng(SEED)
    return [cls(rid=rid, prompt=rng.integers(0, vocab, PROMPT).astype(np.int32), max_new=GEN)
            for rid in range(REQUESTS)]


def ragged_stream(vocab: int, cls) -> list:
    """6 requests with prompts of 4-6 tokens, 22 new tokens each: admissions
    land mid-flight, and the positions reach 27, into every model rank's
    block of a 32-position cache split over 4."""
    rng = np.random.default_rng(1)
    return [cls(rid=rid, prompt=rng.integers(0, vocab, 4 + rid % 3).astype(np.int32),
                max_new=22) for rid in range(6)]


def drain(server, reqs) -> dict:
    for r in reqs:
        server.submit(r)
    while server.step():
        pass
    return {r.rid: list(r.out) for r in server.done}


# ---------------------------------------------------------------------------
# The reference side (a subprocess with 4 XLA host devices)
# ---------------------------------------------------------------------------


def _mesh(jax, plan):
    from jax.sharding import Mesh

    n = int(np.prod(plan.shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(plan.shape), plan.axes)


def _index(shardings, structs, devices) -> list:
    """Per leaf, per device (row-major), the ``(start, stop)`` of each dimension."""
    out = []
    for s, sh in zip(structs, shardings):
        by_dev = sh.devices_indices_map(tuple(s.shape))
        out.append([tuple(sl.indices(n)[:2] for sl, n in zip(by_dev[d], s.shape))
                    for d in devices])
    return out


def reference(part: int, out_path: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    from repro.configs import get_smoke_config
    from repro.dist.sharding import make_rules
    from repro.launch.serve import BatchServer, Request
    from repro.runtime import plan_mesh

    out = {}
    if part < 2:
        half = len(LAUNCH_CASES) // 2
        cases = LAUNCH_CASES[:half] if part == 0 else LAUNCH_CASES[half:]
        for arch, slots, world in cases:
            cfg = get_smoke_config(arch)
            mesh = _mesh(jax, plan_mesh(world, global_batch=slots, want_model=1))
            server = BatchServer(cfg, slots=slots, max_len=MAX_LEN,
                                 rules=make_rules(mesh, "serve"), seed=SEED)
            with mesh:
                out[(arch, slots, world)] = {"tokens": drain(server, launch_stream(
                    cfg.vocab, Request)), "mesh": dict(mesh.shape)}
    else:
        for arch, want_model, max_len in SPLIT_CASES:
            cfg = get_smoke_config(arch)
            mesh = _mesh(jax, plan_mesh(WORLD, global_batch=SLOTS, want_model=want_model))
            rules = make_rules(mesh, "serve")
            server = BatchServer(cfg, slots=SLOTS, max_len=max_len, rules=rules, seed=SEED)
            logits, run = [], server._run

            def recorded(token, pos, run=run, logits=logits):
                lg = run(token, pos)
                logits.append(np.array(lg))
                return lg

            server._run = recorded
            with mesh:
                tokens = drain(server, ragged_stream(cfg.vocab, Request))
            devices = list(mesh.devices.flat)
            model = server.model
            p_axes = jax.tree.leaves(model.axes(), is_leaf=lambda x: isinstance(x, tuple))
            c_axes = jax.tree.leaves(model.cache_axes(), is_leaf=lambda x: isinstance(x, tuple))
            params, cache = jax.tree.leaves(server.params), jax.tree.leaves(server.cache)
            out[(arch, want_model, max_len)] = {
                "tokens": tokens, "logits": logits, "mesh": dict(mesh.shape),
                "cache": [np.asarray(x) for x in cache],
                "param_index": _index([rules.sharding(a, x.shape) for a, x in
                                       zip(p_axes, params)], params, devices),
                "cache_index": _index([rules.sharding(a, x.shape) for a, x in
                                       zip(c_axes, cache)], cache, devices)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# The port's side (spawned gloo ranks)
# ---------------------------------------------------------------------------


def _numpy(tree) -> list:
    from repro_torch.dist.compress import tree_leaves

    return [x.numpy().copy() for x in tree_leaves(tree)]


def case_launch(rank: int, world: int, cases: list, weights: dict) -> dict:
    """The launcher (``serve.serve``) from the reference's weights for every
    ``(arch, slots)`` of ``cases``: its token lists and result line."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.convert import lm_params_from_numpy
    from repro_torch.launch import serve

    out = {}
    for arch, slots in cases:
        params = lm_params_from_numpy(weights[arch], get_smoke_config(arch), "cpu")
        result, server = serve.serve(serve.parse_args(launch_argv(arch, slots)), params)
        out[(arch, slots)] = {"tokens": {r.rid: list(r.out) for r in server.done},
                              "result": result, "local_slots": server.local_slots,
                              "slot0": server.slot0}
    return out


def case_split(rank: int, world: int, weights: dict) -> dict:
    """``BatchServer`` under the serve table of ``plan_mesh(4, SLOTS,
    want_model)`` for every case of :data:`SPLIT_CASES`, from the
    reference's weights, on the ragged stream: its token lists, this rank's
    logits of every decode step, its slots, and its parameter and cache
    shards (numpy)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.convert import lm_params_from_numpy
    from repro_torch.dist.sharding import make_rules
    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.runtime import plan_mesh

    out = {}
    for arch, want_model, max_len in SPLIT_CASES:
        cfg = get_smoke_config(arch)
        rules = make_rules(plan_mesh(world, global_batch=SLOTS, want_model=want_model), "serve")
        server = BatchServer(cfg, slots=SLOTS, max_len=max_len, device="cpu", rules=rules,
                             params=lm_params_from_numpy(weights[arch], cfg, "cpu"))
        logits, decode = [], server.model.decode

        def recorded(*a, decode=decode, logits=logits):
            lg, cache = decode(*a)
            logits.append(lg.numpy().copy())
            return lg, cache

        server.model = dataclasses.replace(server.model, decode=recorded)
        tokens = drain(server, ragged_stream(cfg.vocab, Request))
        out[(arch, want_model, max_len)] = {
            "tokens": tokens, "logits": logits, "slot0": server.slot0,
            "local_slots": server.local_slots, "model_rank": rules.coords(rank)["model"],
            "params": _numpy(server.params), "cache": _numpy(server.cache)}
    return out


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] != "reference" or sys.argv[2] not in ("0", "1", "2"):
        raise SystemExit(f"usage: {sys.argv[0]} reference 0|1|2 OUT.pkl")
    reference(int(sys.argv[2]), sys.argv[3])
