"""Trace one cell of the port's dry-run and print its raw record (no
artifact written): the port's counterpart of ``scripts/probe_dryrun.py``.

    PYTHONPATH=src python scripts/torch_probe_dryrun.py ARCH SHAPE [--multi-pod]
    PYTHONPATH=src python scripts/torch_probe_dryrun.py h2o_danube_1_8b train \\
        --layers 2 --seq 128 --batch 8 --one

SHAPE is one of ``configs.SHAPES`` (``train_4k``, ...), or a kind (``train``,
``prefill``, ``decode``) with ``--seq`` and ``--batch``. The cell is rank
0's on the pod plan (16, 16), the multipod plan (2, 16, 16), or with
``--one`` a world of one; ``--layers`` cuts the depth. Runs on the CPU
(the ``meta`` device); the numbers are counted work over the H100's
data-sheet terms, not measurements.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.lowering import build_cell, production_plan, trace_cell
from repro_torch.runtime import plan_mesh


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--one", action="store_true", help="a world of one")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this")
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    args = ap.parse_args()
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    sp = SHAPES.get(args.shape) or ShapeSpec(f"custom_{args.shape}", args.seq, args.batch,
                                             args.shape)
    if args.one:
        plan = plan_mesh(1, global_batch=sp.global_batch, want_model=1)
    else:
        plan = production_plan("multipod" if args.multi_pod else "pod", sp.global_batch)
    t0 = time.perf_counter()
    cell = build_cell(cfg, sp, plan)
    print(f"build: {time.perf_counter() - t0:.1f}s; plan {dict(zip(plan.axes, plan.shape))}")
    rec = trace_cell(cell)
    log = rec.pop("collective_log")
    print(f"trace: {rec['trace_s']:.1f}s; {sum(r['count'] for r in log)} collectives "
          f"in {len(log)} groups")
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
