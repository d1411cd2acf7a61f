#!/usr/bin/env python3
"""Does this host keep a process's arithmetic intact while the process is
stopped and continued (SIGSTOP/SIGCONT) many times a second?

    python3 scripts/stop_storm_check.py [--period 0.01] [--runs 4] [--n 11095298]

A child makes a seeded int32 array of ``--n`` values and, ``--reps`` times,
digests it the way ``repro_torch.launch.chaos`` digests a loaded graph
(sha256 of its int64 cast) and digests a sorted copy (the sort a graph's
canonicalization runs), printing every digest. The child runs once
undisturbed, then ``--runs`` times stopped and continued every ``--period``
seconds from its start to its exit, as ``chaos`` disturbs the launcher.
The same data must give the same digests, rep after rep and run after run:
a difference is the host computing wrongly, since nothing else changes.
Imports numpy and the standard library only. Prints one JSON line; exits 1
on a difference.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import time


def child(n: int, reps: int) -> None:
    import numpy as np

    a = np.random.default_rng(0).integers(0, 2**31 - 1, n, dtype=np.int32)
    out = []
    for _ in range(reps):
        cast = hashlib.sha256(np.ascontiguousarray(a, dtype=np.int64).tobytes())
        sort = hashlib.sha256(np.sort(a).tobytes())
        out.append([cast.hexdigest()[:16], sort.hexdigest()[:16]])
    print(json.dumps(out), flush=True)


def run(cmd: list[str], period: float | None, timeout: float) -> dict:
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    t0, stops = time.perf_counter(), 0
    deadline = time.time() + timeout
    try:
        while period is not None and time.time() < deadline and proc.poll() is None:
            os.kill(proc.pid, signal.SIGSTOP)
            stops += 1
            os.kill(proc.pid, signal.SIGCONT)
            time.sleep(period)
        out, err = proc.communicate(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    rec = {"seconds": time.perf_counter() - t0, "stops": stops, "rc": proc.returncode}
    if proc.returncode == 0:
        rec["digests"] = json.loads(out.strip().splitlines()[-1])
    else:
        rec["stderr"] = err[-2000:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--period", type=float, default=0.01, help="seconds between two stops")
    ap.add_argument("--runs", type=int, default=4, help="disturbed runs")
    ap.add_argument("--n", type=int, default=11_095_298, help="values in the array")
    ap.add_argument("--reps", type=int, default=8, help="digests a run")
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds a run")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.n, args.reps)
        return 0
    cmd = [sys.executable, os.path.abspath(__file__), "--child", "--n", str(args.n),
           "--reps", str(args.reps)]
    want = run(cmd, None, args.timeout)
    runs = [run(cmd, args.period, args.timeout) for _ in range(args.runs)]
    first = want["digests"][0]
    wrong = [[i, j] for i, r in enumerate([want] + runs) if r["rc"] == 0
             for j, d in enumerate(r["digests"]) if d != first]
    ok = not wrong and all(r["rc"] == 0 for r in runs)
    print(json.dumps({"ok": ok, "period_s": args.period, "n": args.n, "reps": args.reps,
                      "undisturbed": want, "disturbed": runs,
                      "wrong_digests_at_run_rep": wrong}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
