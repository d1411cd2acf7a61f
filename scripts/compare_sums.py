#!/usr/bin/env python3
"""Compare the port's fixed-order sums in two checkouts on one NVIDIA card.

    python3 scripts/compare_sums.py --other PATH [--out artifacts/compare_sums.json]

``PATH`` is another checkout of this repository (for example ``git archive``
of a parent commit, unpacked). Its ``src/repro_torch`` is copied into a
temporary directory under the name ``repro_torch_other`` and imported beside
this checkout's ``repro_torch``, so both run in one process, on one card, on
one summary: the skitter stand-in at full size (V = 2,097,152, E =
11,095,298, seed 0) with the default config, summarized once by this
checkout. In turns other, this, this, other, it times:

* the CSR row sums of a PageRank step (``segment_sum_cuda``), device time;
* ``queries.ordered_sum`` at ``[1, S]``, ``[9, S]``, ``[64, S]``, ``[9, nnz]``
  and ``[64, nnz]`` (the query path's shapes), device time of everything
  the call runs and host wall of one call, with ``x.sum(-1)`` beside;
* ``queries.pagerank_power`` (50 steps), host wall;
* a 64-slot batch of each query kind through ``QueryEngine.answer_batch``
  (packing excluded), host wall, as ``chip_smoke.py`` phase 7d times it;
* 1024 requests served through ``QueryServer`` in 64 slots, host wall.

It fails unless both checkouts give the same bits: the row sums, every
``ordered_sum``, the PageRank vector, every batch's answers and the served
digest. Device times are torch.profiler's (mean per recorded kernel event,
times how often a call runs that kernel); walls are medians between
synchronizes. Prints the card's name and power limit, and each number per
turn; writes them as JSON to ``--out``. Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1, "S"), (9, "S"), (64, "S"), (9, "nnz"), (64, "nnz"))
SLOTS = 64


def import_other(path: str, tmp: str):
    """``path``'s ``src/repro_torch`` as the package ``repro_torch_other``."""
    dst = os.path.join(tmp, "repro_torch_other")
    shutil.copytree(os.path.join(path, "src", "repro_torch"), dst)
    for dirpath, _, files in os.walk(dst):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(dirpath, f)
                with open(p) as fh:
                    text = fh.read()
                with open(p, "w") as fh:
                    fh.write(re.sub(r"\brepro_torch\b", "repro_torch_other", text))
    sys.path.insert(0, tmp)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="another checkout of this repository")
    ap.add_argument("--out", default=os.path.join(ROOT, "artifacts", "compare_sums.json"))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("compare_sums: needs an NVIDIA card", file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="compare-sums-")
    try:
        sys.path.insert(0, os.path.join(ROOT, "src"))
        import_other(os.path.abspath(args.other), tmp)
        return run(torch, args.out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(torch, out_path: str) -> int:
    import repro_torch.core.queries as q_this
    import repro_torch.core.query_engine as qe_this
    import repro_torch.launch.query_serve as qs_this
    import repro_torch_other.core.queries as q_other
    import repro_torch_other.core.query_engine as qe_other
    import repro_torch_other.launch.query_serve as qs_other
    from repro_torch.core import SummaryConfig, summarize
    from repro_torch.graphs import generate
    from repro_torch.kernels.segment_sum import segment_sum_cuda as seg_this
    from repro_torch_other.kernels.segment_sum import segment_sum_cuda as seg_other

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def device_ms(fn, launches=50):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total / e.count * max(1, round(e.count / launches))
                   for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and e.count) / 1e3

    def wall_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3

    src, dst, v = generate("skitter", seed=0, scale=1.0)
    res = summarize(src, dst, v, SummaryConfig(T=20, k_frac=0.3, seed=0), device="cuda")
    sides = {
        "other": dict(q=q_other, qe=qe_other, qs=qs_other,
                      bs=q_other.build_block_summary(dataclasses.replace(res), "cuda")),
        "this": dict(q=q_this, qe=qe_this, qs=qs_this,
                     bs=q_this.build_block_summary(dataclasses.replace(res), "cuda")),
    }
    bs = sides["this"]["bs"]
    s, nnz = bs.num_blocks, bs.nnz
    print(f"block summary: S={s} nnz={nnz} widest row {bs.max_row_nnz()}", flush=True)
    p = torch.full((s,), 1.0 / v, dtype=torch.float64, device=dev)
    share = torch.where(bs.deg > 0, p / torch.clamp(bs.deg, min=1e-300), 0.0)
    step = (bs.deg_w * share[bs.cols]).contiguous()
    csr = {"other": lambda: seg_other(sides["other"]["bs"].indptr, step),
           "this": lambda: seg_this(bs.indptr, step, bs.long_rows)}
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = {}
    for k, tag in SHAPES:
        n = s if tag == "S" else nnz
        x = torch.randn(k, n, dtype=torch.float64, device=dev, generator=gen)
        xs[f"[{k}, {tag}]"] = x * torch.exp(8 * torch.randn(k, n, dtype=torch.float64,
                                                            device=dev, generator=gen))
    for side in sides.values():
        side["engine"] = side["qe"].QueryEngine(dataclasses.replace(res), device="cuda")
    kinds = list(qe_this.KIND_NAMES.values())
    reqs = qs_this.random_workload(np.random.default_rng(0), v, 4096, kinds)

    seen: dict = {}

    def same(key, value):
        """Holds ``value`` to the first turn's, bit for bit."""
        if isinstance(value, torch.Tensor):
            value = value.cpu().numpy()
        first = seen.setdefault(key, value)
        if not np.array_equal(np.asarray(first), np.asarray(value)):
            raise AssertionError(f"{key}: the two checkouts give other bits")

    out: dict = {"card": card, "S": s, "nnz": nnz, "turns": ["other", "this", "this", "other"]}
    for turn in out["turns"]:
        side, row = sides[turn], out.setdefault(turn, {})
        q, eng, qs = side["q"], side["engine"], side["qs"]

        def put(key, value):
            row.setdefault(key, []).append(value)

        same("csr", csr[turn]())
        put("csr PageRank step device_ms", device_ms(csr[turn]))
        for tag, x in xs.items():
            same(tag, q.ordered_sum(x))
            put(f"ordered_sum {tag} device_ms", device_ms(lambda: q.ordered_sum(x)))
            put(f"ordered_sum {tag} wall_ms", wall_ms(lambda: q.ordered_sum(x)))
            put(f"x.sum(-1) {tag} device_ms", device_ms(lambda: x.sum(-1)))
        pr = q.pagerank_power(side["bs"])
        same("pagerank", pr[0])
        put("pagerank_power wall_ms", wall_ms(lambda: q.pagerank_power(side["bs"]), reps=5))
        eng.pagerank_blocks()
        eng.triangle_density()
        for name, kind in qe_this.KIND_NAMES.items():
            batch = [r for r in reqs if r.kind == kind][:SLOTS]
            kk = np.full(len(batch), kind, np.int32)
            u = np.array([r.u for r in batch])
            w = np.array([r.v for r in batch])
            counts = (None, None, None)
            if kind in qe_this.SET_KINDS:
                counts = side["qe"].pack_set_counts(eng.bs, kk, [r.a for r in batch],
                                                    [r.b for r in batch])
            same(f"batch {name}", eng.answer_batch(kk, u, w, *counts))
            put(f"batch {name} wall_ms", wall_ms(lambda: eng.answer_batch(kk, u, w, *counts),
                                                 reps=5))
        server = qs.QueryServer(eng, slots=SLOTS)
        chunk = [qs.QueryRequest(**{f.name: getattr(r, f.name)
                                    for f in dataclasses.fields(r)}) for r in reqs[:1024]]
        torch.cuda.synchronize()
        put("serve 1024 requests wall_s", qs.serve(server, chunk))
        same("digest", qs.answers_digest(server.done))
    for turn in ("other", "this"):
        print(turn)
        for key, vals in out[turn].items():
            print(f"  {key}: " + ", ".join(f"{x:.4f}" for x in vals))
    print("the two checkouts gave the same bits in every sum, batch and digest")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
