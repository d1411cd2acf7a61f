"""Subprocess body of the port's preemption tests (run by
tests/test_torch_preemption.py, never imported by pytest); the port's copy
of tests/preempt_check.py.

Each mode exercises one leg of the PreemptionGuard contract against the
port's engine on a small random graph, on the CPU:

  golden  — uninterrupted run; prints the final metrics JSON.
  term    — SIGTERM already pending when the run starts: the flag must be
            seen at the *first* host-sync point, the state saved
            synchronously, and the process exit ``RESUMABLE_EXIT`` after
            printing ``{"preempted": true, "step": N}``.
  int     — the same, for SIGINT.
  double  — two SIGTERMs: the second must hard-exit from the handler with
            ``128 + SIGTERM``: no save, no traceback.
  resume  — continue from the latest committed checkpoint in ``--dir``;
            prints the metrics JSON plus ``resumed_from``.

Signalling its own pid makes delivery deterministic. Signals from a parent
are exercised against the real launcher by ``repro_torch.launch.chaos``.
"""

import argparse
import hashlib
import json
import os
import signal
import time

import numpy as np
import torch

from repro_torch.core import SummaryConfig, summarize
from repro_torch.core.engine import EngineCheckpointer
from repro_torch.runtime import (
    RESUMABLE_EXIT,
    CheckpointManager,
    Preempted,
    PreemptionGuard,
)

CFG = SummaryConfig(T=8, k_frac=0.2, seed=0, driver_chunk=2)


def _problem():
    rng = np.random.default_rng(0)
    v, e = 400, 1600
    return rng.integers(0, v, e), rng.integers(0, v, e), v


def _metrics(res) -> dict:
    return {
        "size_bits": res.size_bits,
        "re1": res.re1,
        "re2": res.re2,
        "num_supernodes": res.num_supernodes,
        "num_superedges": res.num_superedges,
        "iterations_run": res.iterations_run,
        "node2super": hashlib.sha256(res.node2super.tobytes()).hexdigest(),
        "edge_w": hashlib.sha256(res.edge_w.tobytes()).hexdigest(),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["golden", "term", "int", "double", "resume"])
    ap.add_argument("--dir", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    src, dst, v = _problem()

    if args.mode == "golden":
        print(json.dumps(_metrics(summarize(src, dst, v, CFG, device="cpu"))))
        return

    guard = PreemptionGuard()
    ck = EngineCheckpointer(manager=CheckpointManager(args.dir, keep=3), every=1,
                            guard=guard)

    if args.mode in ("term", "int"):
        os.kill(os.getpid(), signal.SIGTERM if args.mode == "term" else signal.SIGINT)
        try:
            summarize(src, dst, v, CFG, device="cpu", checkpointer=ck)
        except Preempted as p:
            print(json.dumps({"preempted": True, "step": p.step}))
            raise SystemExit(RESUMABLE_EXIT)
        raise SystemExit("pending signal was never observed at a sync point")

    if args.mode == "double":
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.2)  # the first handler sets the cooperative flag
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(2.0)  # the second handler must os._exit before this returns
        raise SystemExit("second signal did not hard-exit")

    res = summarize(src, dst, v, CFG, device="cpu", checkpointer=ck, resume=True)
    print(json.dumps(dict(_metrics(res), resumed_from=res.resumed_from)))


if __name__ == "__main__":
    main()
