"""The expert-parallel MoE block of the port against the reference's
``apply_moe_a2a``: the helper of ``tests/test_torch_moe_a2a.py``.

    PYTHONPATH=src python tests/torch_moe_a2a_check.py reference OUT.pkl

runs the reference side in a process of its own with 8 XLA host devices,
in ``tests/moe_check.py``'s setup (granite smoke, experts padded to 8,
``init_moe(PRNGKey(0), ep=4)`` in float32, ``x = normal(PRNGKey(1), [4, 8,
d])``), at each capacity factor of :data:`CAPACITY_FACTORS` (8: nothing
drops; 1: records drop), and writes a pickle of, for each mesh of
:data:`MESHES`: the jitted ``apply_moe_a2a(p, x, cfg, rules, cf)``'s ``y``,
``moe_aux`` and ``moe_drop_frac``, and ``jax.grad`` of ``Σy²`` with respect
to the parameters. The ``(1, 4)`` meshes run each half of ``x``'s batch
(the token sets one expert group of the ``(2, 4)`` mesh holds).

The port's side, :func:`case_a2a`, runs on 4 gloo ranks (spawned through
``tests/torch_train_dp_check.py``'s :func:`spawn`) or with the 4 ranks in
one process (``hosted=True``).
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np

CAPACITY_FACTORS = (8.0, 1.0)
# (data, model) host meshes; "row0"/"row1": the (1, 4) mesh on one half of
# the batch
MESHES = ("2x4", "2x2", "row0", "row1")
EXPERTS_PADDED, EP_INIT = 8, 4


def shard(x: np.ndarray, dp: int, ep: int, i: int, j: int) -> np.ndarray:
    """Shard ``(i, j)`` of ``x`` [B, S, d] on a ``(dp, ep)`` mesh: the batch
    over ``data``, the sequence over ``model``."""
    b, s = x.shape[0] // dp, x.shape[1] // ep
    return x[i * b:(i + 1) * b, j * s:(j + 1) * s]


def reference(out_path: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_smoke_config
    from repro.dist.sharding import make_rules
    from repro.models import moe as ref_moe

    base = get_smoke_config("granite_moe_3b_a800m")
    px = ref_moe.init_moe(jax.random.PRNGKey(0), dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, padded_experts=EXPERTS_PADDED)),
        jnp.float32, ep=EP_INIT)
    params = {k: getattr(v, "value", v) for k, v in px.items()}
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, base.d_model), jnp.float32)
    out = {"params": {k: np.asarray(v) for k, v in params.items()}, "x": np.asarray(x)}
    meshes = {"2x4": ((2, 4), x), "2x2": ((2, 2), x), "row0": ((1, 4), x[:2]),
              "row1": ((1, 4), x[2:])}
    for cf in CAPACITY_FACTORS:
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=cf, padded_experts=EXPERTS_PADDED))
        for name, (shape, xm) in meshes.items():
            n = int(np.prod(shape))
            mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
            rules = make_rules(mesh, "train")

            def loss(p, xx):
                y, _ = ref_moe.apply_moe_a2a(p, xx, cfg, rules)
                return jnp.sum(y * y)

            with mesh:
                y, aux = jax.jit(lambda p, xx: ref_moe.apply_moe_a2a(p, xx, cfg, rules))(
                    params, xm)
                g = jax.jit(jax.grad(loss))(params, xm)
            out[(cf, name)] = {"y": np.asarray(y), "moe_aux": float(aux["moe_aux"]),
                               "moe_drop_frac": float(aux["moe_drop_frac"]),
                               "grads": {k: np.asarray(v) for k, v in g.items()}}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _config(cf: float):
    import dataclasses

    from repro_torch.configs import get_smoke_config

    base = get_smoke_config("granite_moe_3b_a800m")
    return dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf, padded_experts=EXPERTS_PADDED, impl="a2a"))


def _local(params: dict, ep: int, j: int) -> dict:
    """Expert rank ``j``'s parameters of ``ep``: the router and its experts,
    each a leaf that requires its gradient."""
    import torch

    e_local = params["wi"].shape[0] // ep
    out = {"router": params["router"]}
    for k in ("wi", "wg", "wo"):
        out[k] = params[k][j * e_local:(j + 1) * e_local]
    return {k: torch.as_tensor(np.array(v)).requires_grad_(True) for k, v in out.items()}


def _run(xs: list, ps: list, cfg, ep, dp=None) -> dict:
    """``apply_moe`` (the selector, which takes the a2a path) on the hosted
    ranks' shards, and the gradients of ``Σy²`` (over the hosted ranks) with
    respect to each one's parameters; numpy."""
    import torch

    from repro_torch.models import moe

    one = len(xs) == 1
    ys, auxes = moe.apply_moe(ps[0] if one else ps, xs[0] if one else xs, cfg, ep=ep, dp=dp)
    ys, auxes = ([ys], [auxes]) if one else (ys, auxes)
    loss = sum((y.float() ** 2).sum() for y in ys)
    leaves = [p[k] for p in ps for k in sorted(p)]
    gs = iter(torch.autograd.grad(loss, leaves))
    grads = [{k: next(gs).numpy() for k in sorted(p)} for p in ps]
    return {"y": [y.detach().numpy() for y in ys], "grads": grads,
            "moe_aux": [float(a["moe_aux"].detach()) for a in auxes],
            "moe_drop_frac": [float(a["moe_drop_frac"]) for a in auxes]}


def case_a2a(rank: int, world: int, params: dict, x: np.ndarray, hosted: bool = False) -> dict:
    """Every capacity factor on the port: ``"rows"``, one expert group of 4
    ranks running each half of the batch in turn (the ``(2, 4)`` mesh's two
    groups); ``"2x2"``, two expert groups of 2 with a data-parallel group
    across them (only over a process group). ``hosted``: the 4 ranks in
    this process (``rank`` is 0, ``world`` 1)."""
    import torch

    from repro_torch.core.query_engine import RankSet
    from repro_torch.dist.data_parallel import DataParallel

    dev = torch.device("cpu")
    out = {}
    for cf in CAPACITY_FACTORS:
        cfg = _config(cf)
        if hosted:
            ep = RankSet(dev, ranks=4)
            for i in (0, 1):
                out[(cf, f"row{i}")] = _run([torch.as_tensor(shard(x, 2, 4, i, j))
                                             for j in range(4)],
                                            [_local(params, 4, j) for j in range(4)], cfg, ep)
            continue
        ep = RankSet(dev)
        for i in (0, 1):
            out[(cf, f"row{i}")] = _run([torch.as_tensor(shard(x, 2, 4, i, rank))],
                                        [_local(params, 4, rank)], cfg, ep)
        # (2, 2): rank = 2·i + j; expert groups {0, 1}, {2, 3}; data groups
        # {0, 2}, {1, 3} (every rank makes every group, in one order)
        dist = torch.distributed
        eps = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        dps = [dist.new_group([0, 2]), dist.new_group([1, 3])]
        i, j = divmod(rank, 2)
        out[(cf, "2x2")] = _run([torch.as_tensor(shard(x, 2, 2, i, j))],
                                [_local(params, 2, j)], cfg, RankSet(dev, group=eps[i]),
                                DataParallel(dev, group=dps[j]))
    return out


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] != "reference":
        raise SystemExit(f"usage: {sys.argv[0]} reference OUT.pkl")
    reference(sys.argv[2])
