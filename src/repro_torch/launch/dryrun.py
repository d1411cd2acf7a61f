"""The port's dry-run: trace one rank's step of every (architecture × input
shape) on the production plans and record the roofline inputs, with no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # everything
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma_7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh pod      # 16×16 only
    PYTHONPATH=src python -m repro_torch.launch.dryrun --ssumm web-uk-05
    PYTHONPATH=src python -m repro_torch.launch.dryrun --summary       # table only

Port of ``repro/launch/dryrun.py``. XLA's lowering has no PyTorch
counterpart: each cell is rank 0's real step (``launch/lowering.py``) run
once on the ``meta`` device, its collectives taken by ranks that count
(``launch/dry_ranks.py``), its work counted by ``launch/costs.py``. The
plans are the reference's meshes, ``(16, 16)`` as ``("data", "model")``
and ``(2, 16, 16)`` with a pod axis, as plans: no mesh is built and no
device is needed. The numbers are counted work over the data-sheet terms
of the H100 (``costs.H100``), not measurements.

Artifacts: one JSON per cell under ``artifacts/dryrun_torch/``, with the
reference's keys (``memory``, ``cost``, ``collectives``, ``roofline``) so
``scripts/emit_tables.py`` renders them, and the port's own:
``trace_s`` (the trace's wall), ``hardware``, ``collective_log`` (the
calls grouped by op, shape and axis), ``kernel_calls``, ``notes``. Cells
already done are skipped unless ``--force``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, get_config
from repro_torch.core.distributed import make_distributed_backend
from repro_torch.core.types import SummaryConfig, init_state
from repro_torch.dist.sharding import make_rules
from repro_torch.graphs.synthetic import DATASETS
from repro_torch.launch import costs
from repro_torch.launch.dry_ranks import CollectiveLog, CountingRankGroup
from repro_torch.launch.lowering import build_cell, production_plan, trace, trace_cell

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")
#: the rule-table names a ``--variant`` may remap
OVERRIDABLE = ("seq", "kvseq", "batch", "act_embed", "embed", "attn_embed", "heads",
               "kv_heads", "ff", "vocab", "experts")


def apply_variants(cfg, plan, shape, variants: dict):
    """Perf-iteration knobs: patch the config / the rule table.

    Supported keys, the reference's:
      moe_impl=a2a|gspmd      — MoE dispatch path (models/moe.py)
      seq=model|none          — activation sequence axis (serve)
      kvseq=model|none        — decode cache sharding axis
      batch=...               — e.g. batch=data+model
      remat=0|1
    """
    rules = None
    overrides = {}
    for key, val in variants.items():
        if key == "moe_impl" and cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl=val))
        elif key in OVERRIDABLE:
            if val == "none":
                overrides[key] = None
            else:
                parts = tuple(val.split("+"))
                overrides[key] = parts if len(parts) > 1 else parts[0]
    if overrides:
        sp = SHAPES[shape]
        mode = "train" if sp.kind == "train" else "serve"
        rules = make_rules(plan, mode, overrides=overrides)
    return cfg, rules


def _write(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str, force: bool = False,
             remat: bool = True, tag: str = "", variants: dict | None = None) -> dict:
    """Trace one cell; returns (and persists) the record."""
    suffix = f"_{tag}" if tag else ""
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}{suffix}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    sp = SHAPES[shape]
    plan = production_plan(mesh_kind, sp.global_batch)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "mesh_shape": dict(zip(plan.axes, plan.shape)), "n_devices": plan.n_devices,
           "status": "error", "tag": tag, "variants": variants or {}}
    try:
        rules = None
        if variants:
            cfg, rules = apply_variants(cfg, plan, shape, variants)
            rv = variants.get("remat")
            if rv is not None:
                remat = {"none": False, "full": True, "0": False, "1": True}.get(rv, rv)
        t0 = time.perf_counter()
        cell = build_cell(cfg, sp, plan, rank=0, remat=bool(remat), rules=rules)
        rec["build_s"] = time.perf_counter() - t0
        rec.update(trace_cell(cell, remat=bool(remat)))
        rec["status"] = "ok"
        del cell
    except Exception as e:  # recorded, not raised: the sweep continues
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    _write(path, rec)
    return rec


class ShapePermutations:
    """A permutation source that gives shapes only: two int64 ``[V]``
    tensors of no values on the round's device (``core/shingles.py``'s
    ``RoundPermutationSource``), for a round traced on ``meta``."""

    def draw_at(self, num_nodes, device, round, rank):
        del round, rank
        return (torch.empty(num_nodes, dtype=torch.int64, device=device),
                torch.empty(num_nodes, dtype=torch.int64, device=device))


@contextlib.contextmanager
def assume_all_nonzero():
    """``nonzero`` on ``meta`` returns its all-nonzero upper bound instead of
    raising (the round's boolean-mask indexing)."""
    from torch.fx.experimental import _config

    old = _config.meta_nonzero_assume_all_nonzero
    _config.meta_nonzero_assume_all_nonzero = True
    try:
        yield
    finally:
        _config.meta_nonzero_assume_all_nonzero = old


def build_ssumm_round(v: int, e: int, n_ranks: int, rank: int = 0, group_size: int = 64,
                      lean_sort: bool = False, external_groups: bool = False):
    """Rank ``rank``'s compact distributed round of ``make_distributed_backend``
    at ``V = v``, ``E = e`` over ``n_ranks`` counting ranks, on ``meta``:
    ``(backend, args, log)`` with ``args = (src_l, dst_l, state, θ, salt[,
    groups_all])``, the rank's ``-1``-padded int64 edge shard and the whole
    state."""
    log = CollectiveLog()
    dev = torch.device("meta")
    cfg = SummaryConfig(group_size=group_size)
    group = CountingRankGroup(dev, rank, n_ranks, log)
    backend = make_distributed_backend(cfg, v, e, grouping="compact", lean_sort=lean_sort,
                                       external_groups=external_groups, device=dev,
                                       perms=ShapePermutations(), group=group)
    e_loc = -(-e // n_ranks)
    src = torch.zeros(e_loc, dtype=torch.int64, device=dev)
    dst = torch.zeros(e_loc, dtype=torch.int64, device=dev)
    args = [src, dst, init_state(v, dev), torch.tensor(0.5, device=dev), 1]
    if external_groups:
        args.append(torch.zeros((backend.g_pad, group_size), dtype=torch.int64, device=dev))
    return backend, tuple(args), log


def _ssumm_roofline(cost: dict, t_l: float, useful: float, n: int,
                    hardware=costs.H100) -> dict:
    """The reference's SSumM roofline (``run_ssumm_cell``): a rank's terms
    (``t_l`` the collective one, priced link by link), the useful work the
    merge-gain scoring arithmetic, the float32 peak."""
    peak = hardware.fp32_flops
    flops, bts = cost["flops"], cost["bytes_accessed"]
    t_c, t_m = flops / peak, bts / hardware.hbm_bytes_per_s
    terms = {"compute": t_c, "memory": t_m, "collective": t_l}
    return {"t_compute": t_c, "t_memory": t_m, "t_collective": t_l,
            "bottleneck": max(terms, key=terms.get), "model_flops": useful,
            "hlo_flops_total": flops * n, "useful_ratio": useful / max(flops * n, 1.0),
            "roofline_fraction": (useful / (n * peak)) / max(max(terms.values()), 1e-12),
            "step_time_bound_s": max(terms.values())}


def run_ssumm_cell(dataset: str, mesh_kind: str, out_dir: str, force: bool = False,
                   group_size: int = 64, tag: str = "", lean_sort: bool = False,
                   regroup_every: int = 0) -> dict:
    """Trace one compact distributed SSumM round at a dataset's V and E on a
    production plan's ranks (as one flat group). MODEL_FLOPS is the merge-gain
    scoring arithmetic, ``G·C²·(14·U+10)`` a round; the count takes the
    merge gain's and the pair cost's own work at their calls."""
    suffix = f"_{tag}" if tag else ""
    path = os.path.join(out_dir, f"ssumm_{dataset}__iteration__{mesh_kind}{suffix}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    spec = DATASETS[dataset]
    v, e = spec.v, spec.e_target
    n = production_plan(mesh_kind, 1).n_devices
    cfg = SummaryConfig(group_size=group_size)
    rec = {"arch": f"ssumm_{dataset}", "shape": "iteration", "mesh": mesh_kind,
           "n_devices": n, "V": v, "E": e, "status": "error", "tag": tag,
           "variants": {"lean_sort": lean_sort, "regroup_every": regroup_every}}
    try:
        split = regroup_every > 1
        t0 = time.perf_counter()
        backend, args, log = build_ssumm_round(v, e, n, 0, group_size, lean_sort, split)
        rec["build_s"] = time.perf_counter() - t0
        with assume_all_nonzero():
            out = trace(backend.step, args, log)
        calls = out.pop("_calls")
        rec.update(out)
        t_coll = costs.collective_seconds(calls)
        flops, bts = rec["cost"]["flops"], rec["cost"]["bytes_accessed"]
        if split:  # the grouping program, amortised over regroup_every rounds
            g_back, g_args, g_log = build_ssumm_round(v, e, n, 0, group_size, lean_sort)
            with assume_all_nonzero():
                g = trace(g_back.grouping_fn, g_args[:3], g_log)
            g_calls = g.pop("_calls")
            rec["grouping_cost"] = {"flops": g["cost"]["flops"],
                                    "bytes_accessed": g["cost"]["bytes_accessed"],
                                    "collective_bytes": g["collectives"]["total"],
                                    "regroup_every": regroup_every}
            rec["cost"] = {"flops": flops + g["cost"]["flops"] / regroup_every,
                           "bytes_accessed": bts + g["cost"]["bytes_accessed"] / regroup_every}
            t_coll += costs.collective_seconds(g_calls) / regroup_every
        g_total = -(-v // group_size)
        useful = g_total * group_size ** 2 * (14.0 * cfg.union_size + 10.0)
        rec["merge_gain_flops"] = costs.merge_gain_flops(backend.g_pad // n, group_size,
                                                         cfg.union_size)
        rec["roofline"] = _ssumm_roofline(rec["cost"], t_coll, useful, n)
        rec["hardware"] = costs.H100.name
        rec["notes"] = [f"{rec['data_dependent_ops']} op(s) with a data-dependent shape "
                        "outside the hand kernels' plain versions: their sizes are the "
                        "all-nonzero upper bounds" if rec["data_dependent_ops"] else
                        "no data-dependent shape is counted (the boolean-mask index is "
                        "inside the merge gain's plain version, which the count replaces)"]
        rec["status"] = "ok"
    except Exception as exc:
        rec["error"] = f"{type(exc).__name__}: {exc}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    _write(path, rec)
    return rec


def iter_cells(archs, shapes_filter=None):
    for arch in archs:
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            if shapes_filter and shape not in shapes_filter:
                continue
            yield arch, shape


def summarize(out_dir: str) -> None:
    rows = []
    for fn in sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []:
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(out_dir, fn)) as f:
            r = json.load(f)
        if r.get("tag"):
            continue  # perf-iteration variants
        rows.append(r)
    hdr = (f"{'arch':<22} {'shape':<12} {'mesh':<9} {'status':<7} "
           f"{'trace_s':>9} {'t_comp':>9} {'t_mem':>9} {'t_coll':>9} "
           f"{'bottleneck':<11} {'roofline%':>9}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        if r["status"] == "ok":
            rf = r["roofline"]
            print(f"{r['arch']:<22} {r['shape']:<12} {r['mesh']:<9} ok      "
                  f"{r.get('trace_s', 0):>9.1f} {rf['t_compute']:>9.2e} "
                  f"{rf['t_memory']:>9.2e} {rf['t_collective']:>9.2e} "
                  f"{rf['bottleneck']:<11} {100 * rf['roofline_fraction']:>8.1f}%")
        else:
            print(f"{r['arch']:<22} {r['shape']:<12} {r['mesh']:<9} ERROR   "
                  f"{r.get('error', '')[:60]}")
    n_ok = sum(r["status"] == "ok" for r in rows)
    print(f"\n{n_ok}/{len(rows)} cells ok")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", action="append", help="architecture id(s)")
    ap.add_argument("--shape", action="append", help="input shape(s)")
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"), default="both")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACTS))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--summary", action="store_true", help="print table only")
    ap.add_argument("--tag", default="", help="variant tag for perf iterations")
    ap.add_argument("--variant", action="append", default=[],
                    help="perf knob key=value (see apply_variants)")
    ap.add_argument("--ssumm", default="",
                    help="dataset name: trace the distributed SSumM round instead of "
                         "LM cells (e.g. web-uk-05)")
    ap.add_argument("--ssumm-group-size", type=int, default=64)
    args = ap.parse_args(argv)
    variants = dict(v.split("=", 1) for v in args.variant)

    if args.summary:
        summarize(args.out)
        return
    archs = args.arch or ARCHS
    meshes = ("pod", "multipod") if args.mesh == "both" else (args.mesh,)
    failures = []
    if args.ssumm:
        for mesh_kind in meshes:
            t0 = time.time()
            rec = run_ssumm_cell(args.ssumm, mesh_kind, args.out, force=args.force,
                                 group_size=args.ssumm_group_size, tag=args.tag,
                                 lean_sort="lean_sort" in variants,
                                 regroup_every=int(variants.get("regroup_every", 0)))
            print(f"[{time.strftime('%H:%M:%S')}] ssumm_{args.ssumm} {mesh_kind}: "
                  f"{rec['status']} ({time.time() - t0:.1f}s)", flush=True)
            if rec["status"] != "ok":
                print(rec.get("error"))
                failures.append(("ssumm", args.ssumm, mesh_kind))
        if failures:
            raise SystemExit(1)
        return
    for arch, shape in iter_cells(archs, args.shape):
        for mesh_kind in meshes:
            t0 = time.time()
            rec = run_cell(arch, shape, mesh_kind, args.out, force=args.force,
                           remat=not args.no_remat, tag=args.tag, variants=variants)
            status = rec["status"]
            print(f"[{time.strftime('%H:%M:%S')}] {arch} {shape} {mesh_kind}: "
                  f"{status} ({time.time() - t0:.1f}s)", flush=True)
            if status != "ok":
                failures.append((arch, shape, mesh_kind, rec.get("error")))
    summarize(args.out)
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", *f)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
