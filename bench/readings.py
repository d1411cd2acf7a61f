"""The readings that the comparison's limits are set from.

    python3 bench/readings.py --workload skitter.summarize --seeds 11,12,13 \\
        --controls 3 --out readings.jsonl

For each seed, in one process: the cell's graph made from the seed and its
degree figures, one summarization on the timed path's entry to count its
rounds, a second with the round captured as in a run, and every number
compared (the program's readings); for the first
``--controls`` seeds also the numbers of each control of
:mod:`bench.reference.control` in the program's place. One JSON line per
seed and source. The benchmark's own runs do not run this.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(root, workload: str, seeds: list[int], controls: int, device: str = "cuda",
             emit=print):
    import torch

    from bench import harness
    from bench.reference import check, control
    from repro_torch.core.summarize import summarize

    cell = harness.load_cell(root, workload)
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        job = harness.Job.make(cell, seed, device)
        seams = job.seams()
        with seams.installed():
            seams.begin_run()
            res = summarize(job.src, job.dst, job.num_nodes, job.cfg, device=device)
            captured = check.capture_round(seed, len(res.history))
            seams.begin_run(captured)
            res = summarize(job.src, job.dst, job.num_nodes, job.cfg, device=device)
            cap = seams.take()
        out = check.Summary.of(res)
        src, dst = torch.from_numpy(job.src), torch.from_numpy(job.dst)
        judged = {"program": (out, cap)}
        if i < controls:
            judged["bfloat16"] = control.bfloat16(src, dst, job.num_nodes, out, cap)
            judged["node_moved"] = (control.node_moved(job.src, job.dst, out, seed), cap)
            judged["weight_changed"] = (control.weight_changed(out, seed), cap)
        for source, (o, c) in judged.items():
            nums, _ = check.judge(src, dst, job.num_nodes, job.k_bits, job.cfg.max_neighbors,
                                  [o], [c] if c is not None else [])
            emit(json.dumps({"workload": workload, "seed": seed, "source": source,
                             "rounds": len(res.history), "captured_round": captured,
                             "graph": job.graph, "seconds": time.perf_counter() - t0,
                             **nums}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    harness.cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("readings: no card", file=sys.stderr)
        return 3
    with open(args.out, "a") as f:
        def emit(line):
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()
        readings(ROOT, args.workload, [int(s) for s in args.seeds.split(",")],
                 args.controls, emit=emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
