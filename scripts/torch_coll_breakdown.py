"""The 12 largest collective groups of one dry-run cell (the port's
counterpart of ``scripts/coll_breakdown.py``): rank 0's step on the pod plan
traced on ``meta``, its calls grouped by op, shape, dtype and group.

    PYTHONPATH=src python scripts/torch_coll_breakdown.py ARCH SHAPE [key=value ...]
    PYTHONPATH=src python scripts/torch_coll_breakdown.py --record artifacts/dryrun_torch/X.json
    PYTHONPATH=src python scripts/torch_coll_breakdown.py --table artifacts/dryrun_torch

``key=value`` are the dry-run's ``--variant`` knobs; ``--record`` reads a
record's ``collective_log`` instead of tracing; ``--table`` prints one line
a record of a directory. Bytes are what each call
returns on the rank; the collective term prices each at the slowest link
its group crosses (``launch/costs.py``).
"""

from __future__ import annotations

import json
import sys

from repro_torch.launch import costs


def by_kind(log: list) -> dict:
    """Bytes and priced seconds by (axis, op, the reduction a gather stands
    for): ``{key: [calls, bytes, seconds]}``."""
    out: dict = {}
    for r in log:
        key = (r["axis"], r["op"], r.get("reduces", ""))
        row = out.setdefault(key, [0, 0, 0.0])
        row[0] += r["count"]
        row[1] += r["bytes"]
        row[2] += (r["bytes"] * costs.OP_FACTOR.get(r["op"], 0.0)
                   / costs.H100.link_bytes_per_s(r["ranks"]))
    return out


def show(rec: dict) -> None:
    log = rec["collective_log"]
    total = sum(r["bytes"] for r in log)
    print(f"total collective result bytes a rank (unweighted): {total / 2**30:.2f} GiB "
          f"in {sum(r['count'] for r in log)} calls")
    for r in log[:12]:
        link = costs.H100.link_bytes_per_s(r["ranks"])
        secs = r["bytes"] * costs.OP_FACTOR.get(r["op"], 0.0) / link
        print(f"  {r['bytes'] / 2**30:8.3f} GiB  x{r['count']:<5} {r['op']:<11} "
              f"{r['dtype']:<9} {str(tuple(r['shape'])):<28} over {r['axis']} "
              f"({len(r['ranks'])} ranks, {link / 1e9:.0f} GB/s): {secs:.4f} s")
    print("by axis and kind (calls, GiB, priced s):")
    for (axis, op, red), (n, b, secs) in sorted(by_kind(log).items(), key=lambda kv: -kv[1][2]):
        what = f"{op} for a {red}" if red else op
        print(f"  {axis:<6} {what:<22} x{n:<6} {b / 2**30:9.3f} GiB {secs:9.4f} s")
    red = rec.get("reductions_as_gathers")
    if red:
        print(f"sums and maxima as all-gathers: {red['calls']} calls, "
              f"{red['gathered_bytes'] / 2**30:.3f} GiB gathered against "
              f"{red['ring_all_reduce_bytes'] / 2**30:.3f} GiB for ring all-reduces")
    print("flops/rank:", rec["cost"]["flops"], "bytes/rank:", rec["cost"]["bytes_accessed"])


def table(out_dir: str) -> None:
    """One line a record of ``out_dir``: the collective term and its share
    by kind, and the sums written as all-gathers against ring all-reduces."""
    import os

    print("| cell | t_coll s | largest kind (axis, share of t_coll) | sums as gathers GiB "
          "| ring all-reduce GiB |")
    print("|---|---|---|---|---|")
    for fn in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, fn)) as f:
            rec = json.load(f)
        if rec.get("status") != "ok" or rec.get("tag"):
            continue
        kinds = by_kind(rec["collective_log"])
        t = sum(v[2] for v in kinds.values())
        top = max(kinds.items(), key=lambda kv: kv[1][2]) if kinds else None
        what = "-" if top is None else (f"{top[0][1]}{' for a ' + top[0][2] if top[0][2] else ''}"
                                        f" ({top[0][0]}, {100 * top[1][2] / max(t, 1e-30):.1f}%)")
        red = rec.get("reductions_as_gathers", {"gathered_bytes": 0, "ring_all_reduce_bytes": 0})
        print(f"| {rec['arch']} {rec['shape']} {rec['mesh']} | {t:.4g} | {what} | "
              f"{red['gathered_bytes'] / 2**30:.3f} | {red['ring_all_reduce_bytes'] / 2**30:.3f} |")


def main() -> None:
    if sys.argv[1] == "--record":
        with open(sys.argv[2]) as f:
            show(json.load(f))
        return
    if sys.argv[1] == "--table":
        table(sys.argv[2])
        return
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import apply_variants
    from repro_torch.launch.lowering import build_cell, production_plan, trace_cell

    arch, shape = sys.argv[1], sys.argv[2]
    variants = dict(kv.split("=", 1) for kv in sys.argv[3:])
    sp = SHAPES[shape]
    plan = production_plan("pod", sp.global_batch)
    cfg, rules = apply_variants(get_config(arch), plan, shape, variants)
    show(trace_cell(build_cell(cfg, sp, plan, rules=rules)))


if __name__ == "__main__":
    main()
