"""Wire accounting of the port's compressed all-reduce
(``repro_torch.dist.compress.compressed_all_reduce``) across processes.

    SSUMM_COORDINATOR=localhost:PORT SSUMM_NUM_PROCESSES=2 SSUMM_PROCESS_ID=i \
        PYTHONPATH=src python tests/torch_wire_check.py [--device cpu|cuda]

Port of ``tests/wire_check.py``. Each process joins the group through
``repro_torch.launch.mesh.bootstrap_distributed`` from the ``SSUMM_*``
environment (a world of one without it) and contributes rank r's slice of
one deterministic stack of the reference's ``SHAPES``. For every wire format
it asserts:

  * the measured wire bytes equal ``n_ranks × payload_bytes(tree, cfg)``,
    exactly;
  * the summed tree equals a host reference built from the same per-rank
    contributions (``none`` within ``rtol=1e-5, atol=1e-5``: the backend's
    all-reduce adds in its own order; the codecs within ``rtol=1e-5``);
  * top-k conservation: each rank's ``sent + residual`` equals its
    accumulated signal exactly;
  * the error-feedback residual is rank-local: this process gets back one
    residual, its own rank's, equal to the host reference for that rank.

Prints one JSON line a process, exit 0 when every check holds.
``tests/torch_multihost_check.py`` runs it as its wire leg.

The module also holds the spawned side of ``tests/test_torch_multihost.py``:
:func:`spawn` runs :func:`case_allreduce` on P gloo ranks in child
processes, and :func:`allreduce_record` is what each rank (or all P ranks
in one process) reports.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

# leaf shapes chosen to exercise ceil(ratio·n), scalar leaves and
# multi-dimensional reshapes (the reference's)
SHAPES = {"w": (33, 7), "b": (13,), "s": ()}
RATIO = 0.1
KINDS = ("none", "int8", "topk")


def stacked_contributions(n_ranks: int) -> dict:
    """Every rank's contribution, ``[n_ranks, *shape]`` float32 a leaf, drawn
    as the reference's wire check draws them (the same on every process)."""
    rng = np.random.default_rng(7)
    return {k: rng.normal(size=(n_ranks,) + shp).astype(np.float32)
            for k, shp in SHAPES.items()}


def host_topk_ref(g, err, ratio):
    """The exact per-leaf arithmetic of the collective's top-k path on the
    host: ``(sent, residual)``."""
    acc = g.astype(np.float32) + err
    flat = acc.ravel().copy()
    k = max(int(np.ceil(ratio * max(flat.size, 1))), 1)
    # jax.lax.top_k's ties: a stable order on descending |x|
    idx = np.argsort(-np.abs(flat), kind="stable")[:k]
    vals = flat[idx].astype(g.dtype)
    sent = np.zeros_like(flat)
    sent[idx] = vals
    res = flat.copy()
    res[idx] -= vals.astype(np.float32)
    return sent.reshape(g.shape), res.reshape(g.shape)


def check_wire(ranks, device) -> dict:
    """The four checks on this process's rank; a report with ``ok``."""
    import torch

    from repro_torch.dist.compress import (
        CompressConfig,
        compressed_all_reduce,
        decode_int8,
        encode_int8,
        payload_bytes,
    )

    n = ranks.size
    rank = ranks.hosted[0]
    stacked = stacked_contributions(n)
    tree = {k: torch.as_tensor(np.array(v[rank])).to(device) for k, v in stacked.items()}
    template = {k: torch.zeros(shp) for k, shp in SHAPES.items()}
    err0 = {k: np.zeros((n,) + shp, np.float32) for k, shp in SHAPES.items()}
    report = {"ok": True, "n_ranks": n, "errors": [], "wire_bytes": {}}

    def check(name, cond, detail=""):
        if not cond:
            report["ok"] = False
            report["errors"].append(f"{name}: {detail}")

    for kind in KINDS:
        cfg = CompressConfig(kind, topk_ratio=RATIO)
        err = {k: torch.as_tensor(np.array(v[rank])).to(device) for k, v in err0.items()}
        summed, new_err, wire = compressed_all_reduce(tree, err, cfg, ranks)
        summed = {k: x.cpu().numpy() for k, x in summed.items()}
        priced = n * payload_bytes(template, cfg)
        report["wire_bytes"][kind] = {"measured": wire, "priced": priced}
        check(f"{kind}/bytes", wire == priced, f"measured {wire} != priced {priced}")
        if kind == "none":
            for k, v in stacked.items():
                check(f"none/sum/{k}", np.allclose(summed[k], v.sum(axis=0, dtype=np.float32),
                                                   rtol=1e-5, atol=1e-5), "all-reduce mismatch")
        elif kind == "int8":
            for k, v in stacked.items():
                acc = np.zeros(SHAPES[k], np.float32)
                for i in range(n):
                    q, s = encode_int8(torch.as_tensor(np.array(v[i])))
                    acc = acc + decode_int8(q, s).numpy()
                check(f"int8/sum/{k}", np.allclose(summed[k], acc, rtol=1e-5, atol=1e-6),
                      "decoded sum mismatch")
        else:
            check("topk/err_local", isinstance(new_err, dict) and set(new_err) == set(SHAPES),
                  f"got {type(new_err).__name__} back, not this rank's residual tree")
            for k, v in stacked.items():
                sent_sum = np.zeros(SHAPES[k], np.float32)
                for i in range(n):
                    sent, res = host_topk_ref(v[i], err0[k][i], RATIO)
                    sent_sum += sent
                    check(f"topk/conserve/{k}/{i}", np.array_equal(sent + res, v[i]),
                          "sent + residual != acc")
                    if i == rank:
                        got = new_err[k].cpu().numpy()
                        check(f"topk/err_local/{k}/{i}", np.array_equal(got, res),
                              "the residual != this rank's host reference")
                check(f"topk/sum/{k}", np.allclose(summed[k], sent_sum, rtol=1e-5, atol=1e-6),
                      f"{summed[k]} vs {sent_sum}")
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description="compressed all-reduce wire check")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args()

    import torch

    from repro_torch.core.query_engine import RankSet
    from repro_torch.launch.mesh import bootstrap_distributed

    torch.set_num_threads(1)
    info = bootstrap_distributed(device=args.device)  # env-driven; no-op alone
    try:
        report = check_wire(RankSet(info.device), info.device)
    finally:
        if info.initialized:
            torch.distributed.destroy_process_group()
    report.update(process_count=info.process_count, process_index=info.process_index)
    print(json.dumps(report), flush=True)
    raise SystemExit(0 if report["ok"] else 1)


# ---------------------------------------------------------------------------
# The spawned side of tests/test_torch_multihost.py
# ---------------------------------------------------------------------------


def rank_trees(contribs: dict, dtypes: dict, device) -> list:
    """Each rank's tree of tensors from ``[P, *shape]`` float32 stacks;
    ``dtypes`` maps a leaf to ``"float32"`` or ``"bfloat16"``."""
    import torch

    p = next(iter(contribs.values())).shape[0]
    return [{k: torch.as_tensor(np.array(v[r])).to(device, getattr(torch, dtypes[k]))
             for k, v in contribs.items()} for r in range(p)]


def allreduce_record(ranks, trees: list, errs: list | None) -> dict:
    """Every kind of :func:`compressed_all_reduce` on the ranks this process
    runs: ``{kind: {"sum": {leaf: float32}, "residual": [{leaf: float32}, ...]
    (one a hosted rank, top-k only), "wire": int}}``."""
    from repro_torch.dist.compress import CompressConfig, compressed_all_reduce

    one = len(ranks.hosted) == 1
    out = {}
    for kind in KINDS:
        tree = trees[0] if one else trees
        err = None if errs is None else (errs[0] if one else errs)
        summed, new_err, wire = compressed_all_reduce(
            tree, err, CompressConfig(kind, topk_ratio=RATIO), ranks)
        rec = {"sum": {k: x.float().cpu().numpy() for k, x in summed.items()}, "wire": wire}
        if kind == "topk":
            rec["residual"] = [{k: x.cpu().numpy() for k, x in e.items()}
                               for e in ([new_err] if one else new_err)]
        out[kind] = rec
    return out


def case_allreduce(rank: int, world: int, contribs: dict, dtypes: dict,
                   errs: dict | None) -> dict:
    import torch

    from repro_torch.core.query_engine import RankSet

    trees = rank_trees(contribs, dtypes, "cpu")
    err = None if errs is None else [{k: torch.as_tensor(np.array(v[rank])) for k, v in errs.items()}]
    return allreduce_record(RankSet(torch.device("cpu")), [trees[rank]], err)


def spawn(world: int, case: str, **kw) -> list:
    """Run ``case`` (a function of this module) on ``world`` gloo ranks in
    child processes joined through a ``file://`` store; returns each rank's
    result, in rank order."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="torch-wire-") as tmp:
        mp.spawn(_child, args=(world, case, kw, tmp), nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def _child(rank: int, world: int, case: str, kw: dict, tmp: str) -> None:
    import pickle

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        res = globals()[case](rank, world, **kw)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main()
