"""Single-device graph-summarization driver of the port.

    PYTHONPATH=src python -m repro_torch.launch.summarize --dataset dblp \
        --scale 0.05 --k-frac 0.3 --T 20 [--device cuda|cpu]

Port of the local mode of ``repro/launch/summarize.py``: runs SSumM on a
registry stand-in graph and prints one JSON object with the reference's keys
that this port fills (Eq. 2/4 metrics, iterations, chunk times), plus
``device`` and the hand kernels' launch counts. It runs on the card unless
``--device cpu`` is given; without CUDA the default raises. Real edge-list
files (``--edge-list``), checkpointing and the distributed mode are not
ported yet.
"""

from __future__ import annotations

import argparse
import json
import resource
import time

from repro_torch.core import SummaryConfig, summarize
from repro_torch.core.types import resolve_device
from repro_torch.graphs import DATASETS, generate
from repro_torch.kernels import ops


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", default="dblp", choices=sorted(DATASETS))
    ap.add_argument("--scale", type=float, default=0.05,
                    help="subsample factor for the synthetic registry |V|,|E|")
    ap.add_argument("--k-frac", type=float, default=0.3)
    ap.add_argument("--T", type=int, default=20)
    ap.add_argument("--group-size", type=int, default=32)
    ap.add_argument("--driver-chunk", type=int, default=None,
                    help="rounds per engine chunk (default: SummaryConfig.driver_chunk)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the summary runs (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises before any work without CUDA

    t_load = time.time()
    src, dst, v = generate(args.dataset, seed=args.seed, scale=args.scale)
    load_wall_s = time.time() - t_load
    cfg_kw = {} if args.driver_chunk is None else {"driver_chunk": args.driver_chunk}
    cfg = SummaryConfig(T=args.T, k_frac=args.k_frac, group_size=args.group_size,
                        seed=args.seed, **cfg_kw)

    before = ops.launch_counts()
    t0 = time.time()
    res = summarize(src, dst, v, cfg, device=device)
    after = ops.launch_counts()
    result = {
        "dataset": args.dataset, "V": v, "E": len(src),
        "mode": "local",
        "device": str(device),
        "size_bits": res.size_bits,
        "relative_size": res.size_bits / res.input_size_bits,
        "re1": res.re1, "re2": res.re2,
        "num_supernodes": res.num_supernodes,
        "num_superedges": res.num_superedges,
        "iterations": res.iterations_run,
        "chunk_wall_s": res.chunk_wall_s,
        "wall_s": time.time() - t0,
        "kernel_launches": {k: after[k] - before[k] for k in after},
        "source": "synthetic",
        "load_wall_s": load_wall_s,
        "peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0,
    }
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
