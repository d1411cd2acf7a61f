#!/usr/bin/env python3
"""Whether summarization on one NVIDIA card repeats itself, bit for bit.

    python3 scripts/check_determinism.py [--other PATH]

Summarizes the skitter stand-in at full size (V = 2,097,152, E =
11,095,298, seed 0; T = 20, k_frac = 0.3, the default config) twice on the
card with this checkout's ``repro_torch`` and compares the two runs:
``node2super``, ``super_size``, ``edge_w`` (SHA-256 digests) and the
integer history (merges, supernodes, superedges per round), with the first
round that differs. On round 1's pair table it calls
``costs.supernode_total_costs`` five times and counts the distinct results,
and times it (CUDA events around 20 calls back to back). Then, on the pair
tables of round 1 and of this checkout's final partition, it runs three
ways of adding the per-pair costs into the per-supernode totals, five times
each, and times them: the ``index_add_`` pair (float atomics), one
``index_put_(accumulate=True)`` of the concatenated ``lo``/``hi`` lists
(PyTorch's sorted, fixed-order scatter-add) and ``costs.exact_index_sum``.

``PATH`` is another checkout (for example ``git archive`` of a parent
commit, unpacked): its ``src/repro_torch`` is imported beside this one as
``repro_torch_other`` (as ``scripts/compare_sums.py`` does), and the two
take turns on one card: other, this, this, other. Prints the card's name
and power limit, one line per turn, and a JSON summary as its last line.
Exits 1 if this checkout's runs differ from each other. Imports nothing of
the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT_KEYS = ("nmerges", "num_supernodes", "num_superedges")


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", default=None, help="another checkout of this repository")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("check_determinism: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    tmp = tempfile.mkdtemp(prefix="check-determinism-")
    try:
        packages = {"this": "repro_torch"}
        if args.other:
            sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
            from compare_sums import import_other
            import_other(os.path.abspath(args.other), tmp)
            packages["other"] = "repro_torch_other"
        return run(torch, packages)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(torch, packages: dict[str, str]) -> int:
    import importlib

    sides = {}
    for name, pkg in packages.items():
        sides[name] = {m: importlib.import_module(f"{pkg}.core.{m}")
                       for m in ("costs", "summarize", "types")}
    this = sides["this"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    from repro_torch.graphs import generate

    dev = torch.device("cuda")
    src, dst, v = generate("skitter", seed=0, scale=1.0)
    graph, _ = this["types"].make_graph(src, dst, v, dev)
    state = this["types"].init_state(v, dev)
    costs = this["costs"]
    pt = costs.build_pair_table(graph.src, graph.dst, state)
    met = costs.summary_metrics(pt, state, v, graph.num_edges)
    scal = torch.stack([met["cbar"], costs.log2_f32(v, dev)])
    pi = costs.pair_pi(pt, state.size)
    want_cpu = None

    def total_costs_ms(fn, launches=20, batches=5) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(batches):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(launches):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / launches)
        return float(np.median(times))

    turns = ["other", "this", "this", "other"] if "other" in sides else ["this", "this"]
    out: dict = {"card": card, "turns": turns, "runs": []}
    for turn in turns:
        side = sides[turn]
        cfg = side["types"].SummaryConfig(T=20, k_frac=0.3, seed=0)
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = side["summarize"].summarize(src, dst, v, cfg, device="cuda")
            wall = time.perf_counter() - t0
            runs.append(dict(
                digests={k: digest(getattr(res, k)) for k in
                         ("node2super", "super_size", "edge_w")},
                ints=[[h[k] for k in INT_KEYS] for h in res.history],
                size_bits=res.size_bits, re1=res.re1,
                median_round_ms=float(np.median([h["round_s"] for h in res.history])) * 1e3,
                wall_s=wall, node2super=res.node2super, super_size=res.super_size))
        a, b = runs
        if turn == "this":
            final = (a["node2super"], a["super_size"])
        diff_rounds = [i + 1 for i, (x, y) in enumerate(zip(a["ints"], b["ints"])) if x != y]
        fn = lambda: side["costs"].supernode_total_costs(pt, pi, scal, v)  # noqa: E731
        totals = [fn().cpu() for _ in range(5)]
        distinct = len({digest(t.numpy()) for t in totals})
        if want_cpu is None:
            pt_cpu = this["types"].PairTable(lo=pt.lo.cpu(), hi=pt.hi.cpu(),
                                             cnt=pt.cnt.cpu(), valid=pt.valid.cpu())
            want_cpu = this["costs"].supernode_total_costs(pt_cpu, pi.cpu(), scal.cpu(), v)
        vs_cpu = (totals[0] != want_cpu).sum().item()
        row = dict(
            turn=turn, runs_identical=a["digests"] == b["digests"] and a["ints"] == b["ints"],
            first_differing_round=diff_rounds[0] if diff_rounds else None,
            node2super_entries_differing=int((a["node2super"] != b["node2super"]).sum()),
            digests=[a["digests"], b["digests"]], size_bits=[a["size_bits"], b["size_bits"]],
            re1=[a["re1"], b["re1"]], rounds=[len(a["ints"]), len(b["ints"])],
            median_round_ms=[a["median_round_ms"], b["median_round_ms"]],
            wall_s=[a["wall_s"], b["wall_s"]], total_costs_distinct_of_5=distinct,
            total_costs_ids_differing_from_cpu=int(vs_cpu),
            total_costs_ms=total_costs_ms(fn))
        out["runs"].append(row)
        print(json.dumps(row), flush=True)
    out["variants"] = sum_variants(torch, this, graph, final, scal, v, total_costs_ms)
    mine = [r for r in out["runs"] if r["turn"] == "this"]
    out["this_repeats"] = all(r["runs_identical"] for r in mine) and \
        len({json.dumps(r["digests"]) for r in mine}) == 1
    print(json.dumps({k: out[k] for k in ("card", "turns", "this_repeats")}))
    return 0 if out["this_repeats"] else 1


def sum_variants(torch, this, graph, final, scal, v, timer) -> list[dict]:
    """The three sums of the per-pair costs, on round 1's pair table and on
    the final partition's: distinct results of five calls, and time."""
    costs, types = this["costs"], this["types"]
    dev = graph.src.device
    states = {"round 1": types.init_state(v, dev), "final": types.SummaryState(
        node2super=torch.as_tensor(final[0], device=dev).long(),
        size=torch.as_tensor(final[1], device=dev).long(), t=21)}
    rows = []
    for tag, state in states.items():
        pt = costs.build_pair_table(graph.src, graph.dst, state)
        pi = costs.pair_pi(pt, state.size)
        cost = torch.where(pt.valid, costs.ops.pair_cost(pt.cnt, pi, scal), 0.0)
        hi_cost = torch.where(pt.lo != pt.hi, cost, 0.0)
        bound = 2.0 * pt.capacity * np.log2(v)
        variants = {
            "index_add_": lambda: torch.zeros(v, device=dev).index_add_(
                0, pt.lo, cost).index_add_(0, pt.hi, hi_cost),
            "index_put_": lambda: torch.zeros(v, device=dev).index_put_(
                (torch.cat([pt.lo, pt.hi]),), torch.cat([cost, hi_cost]), accumulate=True),
            "exact_index_sum": lambda: costs.exact_index_sum(
                v, (pt.lo, pt.hi), (cost, hi_cost), bound)}
        for name, fn in variants.items():
            row = dict(table=tag, pairs=int(pt.valid.sum()), variant=name,
                       distinct_of_5=len({digest(fn().cpu().numpy()) for _ in range(5)}),
                       ms=timer(fn, launches=5, batches=3))
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(main())
