"""Recompute the roofline block of the port's dry-run records from their
stored counts (no trace): ``cost``, ``collective_log`` (each group's
ranks, for the link it crosses) and the cell. The port's counterpart of
``scripts/rederive_roofline.py``; used when the card's table
(``launch/costs.py::H100``) or the pricing changes.

    PYTHONPATH=src python scripts/torch_rederive_roofline.py artifacts/dryrun_torch/*.json
"""

from __future__ import annotations

import json
import sys
import types

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import costs


def main() -> None:
    for path in sys.argv[1:]:
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok" or "cost" not in rec or rec["arch"].startswith("ssumm_"):
            print(f"skip {path}")
            continue
        calls = [types.SimpleNamespace(op=r["op"], bytes=r["bytes"], ranks=r["ranks"])
                 for r in rec["collective_log"]]
        rv = rec.get("variants", {}).get("remat")
        rec["roofline"] = costs.roofline(
            hlo_flops_per_dev=rec["cost"]["flops"],
            hlo_bytes_per_dev=rec["cost"]["bytes_accessed"],
            coll_bytes_per_dev=rec["collectives"]["total"], cfg=get_config(rec["arch"]),
            sp=SHAPES[rec["shape"]], n_chips=rec["n_devices"],
            remat=not rv or rv in ("full", "1"),
            t_collective=costs.collective_seconds(calls))
        rec["hardware"] = costs.H100.name
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        rf = rec["roofline"]
        print(f"{path}: comp={rf['t_compute']:.3f} mem={rf['t_memory']:.3f} "
              f"coll={rf['t_collective']:.3f} frac={rf['roofline_fraction']:.4f}")


if __name__ == "__main__":
    main()
