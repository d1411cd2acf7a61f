"""Quickstart on the PyTorch port: summarize a graph within a bit budget
with SSumM, the port's copy of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py                # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Builds a community-structured graph, runs SSumM with a 30% budget, prints
the paper's metrics (Eq. 2 / Eq. 4), and answers a few node queries from
the summary to show the summary graph stays analyzable. The reference's
lines come first, then one JSON line with the same numbers. It runs on the
card unless ``--device cpu`` is given.
"""

import argparse
import json

import numpy as np

from repro_torch.core import SummaryConfig, resolve_device, summarize
from repro_torch.core.queries import expected_degree, pagerank_summary
from repro_torch.graphs import generate


def main(argv=None, perms=None) -> dict:
    """Run the example; ``perms`` is the summarizer's permutation source
    (default: the torch generator seeded from the config's seed)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # a small social-like graph (ego-facebook stand-in at 10% scale)
    src, dst, v = generate("ego-facebook", seed=0, scale=0.1)
    print(f"input graph: |V|={v} |E|={len(src)}")

    res = summarize(src, dst, v, SummaryConfig(T=20, k_frac=0.3, seed=0),
                    device=device, perms=perms)

    print(f"summary: |S|={res.num_supernodes} |P|={res.num_superedges}")
    print(f"size: {res.size_bits:,.0f} bits "
          f"({100 * res.size_bits / res.input_size_bits:.1f}% of input, "
          f"budget was 30%)")
    print(f"reconstruction error: RE1={res.re1:.2e} RE2={res.re2:.2e}")
    print(f"iterations: {res.iterations_run}")

    # --- analytics served from the summary (paper benefit (b)) ----------
    deg = np.zeros(v)
    np.add.at(deg, src, 1)
    np.add.at(deg, dst, 1)
    print("\nqueries from the summary (no reconstruction):")
    degrees = []
    for u in np.argsort(-deg)[:5]:
        est = expected_degree(res, int(u), device=device)
        degrees.append([int(u), int(deg[u]), est])
        print(f"  node {u:4d}: true degree {int(deg[u]):4d}, "
              f"summary estimate {est:7.1f}")

    pr = pagerank_summary(res, device=device).cpu().numpy()
    top = np.argsort(-pr)[:5]
    print("  top-PageRank nodes (block-space power iteration):",
          ", ".join(f"{int(u)} ({pr[u]:.2e})" for u in top))

    out = {"device": str(device), "V": v, "E": len(src),
           "num_supernodes": res.num_supernodes,
           "num_superedges": res.num_superedges,
           "size_bits": res.size_bits,
           "relative_size": res.size_bits / res.input_size_bits,
           "re1": res.re1, "re2": res.re2,
           "iterations": res.iterations_run,
           "degrees": degrees,
           "pagerank_top": [[int(u), float(pr[u])] for u in top]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
