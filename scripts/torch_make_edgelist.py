"""Emit a deterministic synthetic graph as a SNAP-format edge-list file:
the PyTorch port's copy of ``scripts/make_edgelist.py``.

Fixture writer for the streaming loader (`repro_torch.graphs.io`): registry
stand-ins or explicit R-MAT sizes, written as `.txt`/`.csv` (gzip when the
path ends in `.gz`), with optional loader-hostile noise — shuffled order,
flipped directions, duplicates, self-loops, 1-indexing. The same flags
write the same bytes as the reference script. It touches no device.

    PYTHONPATH=src python scripts/torch_make_edgelist.py --dataset dblp \
        --scale 1.0 --shuffle --dup-frac 0.05 --out data/dblp.txt.gz

    PYTHONPATH=src python scripts/torch_make_edgelist.py --v 262144 --e 1200000 \
        --shuffle --out data/rmat_1m.txt.gz
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.graphs import DATASETS, generate, write_edge_list  # noqa: E402
from repro_torch.graphs.synthetic import rmat  # noqa: E402


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__)
    src_grp = ap.add_mutually_exclusive_group()
    src_grp.add_argument("--dataset", choices=sorted(DATASETS),
                         help="registry stand-in (with --scale)")
    src_grp.add_argument("--v", type=int, help="explicit R-MAT |V| "
                         "(rounded up to a power of two; use with --e)")
    ap.add_argument("--e", type=int, default=None, help="R-MAT edge target")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True, metavar="PATH",
                    help=".txt/.csv, gzip'd when ending in .gz")
    ap.add_argument("--shuffle", action="store_true",
                    help="permute edge order and flip random directions")
    ap.add_argument("--dup-frac", type=float, default=0.0)
    ap.add_argument("--self-loops", type=int, default=0)
    ap.add_argument("--one-indexed", action="store_true")
    ap.add_argument("--no-header", action="store_true",
                    help="omit the '# Nodes: V Edges: E' SNAP header")
    args = ap.parse_args(argv)

    if args.v is not None:
        if args.e is None:
            ap.error("--v requires --e")
        bits = int(np.ceil(np.log2(max(args.v, 2))))
        src, dst = rmat(bits, args.e, seed=args.seed)
        v = 1 << bits
    else:
        src, dst, v = generate(args.dataset or "dblp", seed=args.seed,
                               scale=args.scale)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    write_edge_list(args.out, src, dst, v, seed=args.seed,
                    shuffle=args.shuffle, one_indexed=args.one_indexed,
                    dup_frac=args.dup_frac, self_loops=args.self_loops,
                    header=not args.no_header,
                    comment=f"ssumm synthetic fixture seed={args.seed}")
    print(f"{args.out}: |V|={v} |E|={len(src)} "
          f"({os.path.getsize(args.out)} bytes)")
    return args.out


if __name__ == "__main__":
    main()
