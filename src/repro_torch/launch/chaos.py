"""Fault injection against the port's launcher: kill it at checkpoint steps,
resume, and hold the resumed result to an uninterrupted run's, bit for bit.

    PYTHONPATH=src python -m repro_torch.launch.chaos --edge-list g.txt \
        --T 20 --driver-chunk 2 --kill TERM:6 --kill KILL:12 [--device cpu]

Port of the local mode of ``tests/chaos_check.py``. It runs
``repro_torch.launch.summarize`` once without checkpoints (the golden), then,
per ``--kill SIG:STEP`` scenario, again with ``--checkpoint-dir``: once the
child's first checkpoint is committed it SIGSTOP-samples the child until
checkpoint ``STEP`` (or a later one) is, so the signal lands at a known
boundary instead of racing the round loop, delivers the signal, and reruns
the same command with ``--resume``.

Outcome contract per signal:

  TERM: cooperative. The launcher saves at the next host-sync point, prints
        ``{"preempted": true, ...}`` and exits ``RESUMABLE_EXIT`` (75). If
        the signal lands after the last sync point the run just finishes
        (exit 0), recorded as ``completed`` and compared to the golden.
  KILL: no grace. The process dies with ``-SIGKILL``; the latest committed
        checkpoint is the resume point and a ``.tmp-`` half-write is
        ignored.

Comparison: the :data:`EXACT_KEYS` of the launcher's JSON and the digests
line before it (``node2super``, ``super_size``, ``edge_w``) must equal the
golden's. Prints a JSON report as its last line; exits 1 if any scenario
failed.

``--stop-load N`` first holds the window the scenarios leave alone, the
launcher's graph load: the load runs once undisturbed and ``N`` times
stopped and continued every ``LOAD_SAMPLE_S`` from its first instruction
to its exit, and each must give the same edge counts and digests
(:data:`LOAD_KEYS`). Alone (no ``--kill``) it runs only that check.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

RESUMABLE_EXIT = 75  # repro_torch.runtime.RESUMABLE_EXIT (this module imports no torch)
SAMPLE_S = 0.01  # seconds between two looks at the checkpoint directory
LOAD_SAMPLE_S = 0.002  # seconds between two stops of a child loading its graph

#: launcher JSON keys that a resumed run must reproduce exactly
EXACT_KEYS = ("V", "E", "size_bits", "relative_size", "re1", "re2",
              "num_supernodes", "num_superedges", "iterations", "digests")
#: what a disturbed graph load must give as the undisturbed one did: the edge
#: counts and digests of the loaded arrays and of the canonical graph
LOAD_KEYS = ("loaded_E", "loaded", "E", "graph")


def launcher_cmd(args, ckdir: str | None = None, resume: bool = False) -> list[str]:
    cmd = [sys.executable, "-m", "repro_torch.launch.summarize",
           "--k-frac", str(args.k_frac), "--T", str(args.T), "--seed", str(args.seed),
           "--group-size", str(args.group_size), "--driver-chunk", str(args.driver_chunk),
           "--device", args.device]
    if args.edge_list:
        cmd += ["--edge-list", args.edge_list]
    else:
        cmd += ["--dataset", args.dataset, "--scale", str(args.scale)]
    if ckdir:
        cmd += ["--checkpoint-dir", ckdir, "--checkpoint-every", str(args.checkpoint_every),
                "--checkpoint-keep", str(args.checkpoint_keep)]
    if resume:
        cmd += ["--resume"]
    return cmd


def launcher_env() -> dict:
    """The environment with this checkout's ``src`` first on PYTHONPATH."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def committed_steps(ckdir: str) -> list[int]:
    if not os.path.isdir(ckdir):
        return []
    return sorted(int(name[len("step_"):]) for name in os.listdir(ckdir)
                  if name.startswith("step_")
                  and os.path.exists(os.path.join(ckdir, name, "COMMIT")))


def parse_output(stdout: str) -> dict:
    """The launcher's last JSON object, with its digests line (if any) under
    ``"digests"``."""
    start = stdout.rfind("\n{")
    start = 0 if start < 0 else start + 1
    rec = json.loads(stdout[start:])
    for line in stdout[:start].splitlines():
        if line.startswith("digests "):
            rec["digests"] = line[len("digests "):]
    return rec


def run_to_completion(cmd: list[str], env: dict, timeout: float) -> dict:
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"launcher failed rc={out.returncode}\ncmd: {' '.join(cmd)}\n"
                           f"stderr:\n{out.stderr[-4000:]}")
    return parse_output(out.stdout)


def kill_at_step(cmd: list[str], env: dict, ckdir: str, step: int, signame: str,
                 timeout: float):
    """Run ``cmd``; deliver ``signame`` once a checkpoint ≥ ``step`` commits.

    Until the child's first checkpoint commits (its graph loaded, its round
    loop running) the directory is polled with the child running. From then
    on the child is sampled while it is stopped (SIGSTOP), so "is step N
    committed while the run is still going" is decided on a frozen process,
    every ``SAMPLE_S`` seconds: long enough for the child to be scheduled
    between stops on a loaded host. Returns ``(returncode, delivered, step
    seen, stdout, stderr)``.
    """
    sig = {"TERM": signal.SIGTERM, "KILL": signal.SIGKILL}[signame]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    delivered, seen = False, None
    deadline = time.time() + timeout
    try:
        while time.time() < deadline and proc.poll() is None and not committed_steps(ckdir):
            time.sleep(SAMPLE_S)
        while time.time() < deadline and proc.poll() is None:
            os.kill(proc.pid, signal.SIGSTOP)
            try:
                steps = committed_steps(ckdir)
                if steps and steps[-1] >= step:
                    os.kill(proc.pid, sig)
                    delivered, seen = True, steps[-1]
            finally:
                if proc.poll() is None and not (delivered and sig == signal.SIGKILL):
                    os.kill(proc.pid, signal.SIGCONT)
            if delivered:
                break
            time.sleep(SAMPLE_S)
        try:
            out, err = proc.communicate(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            err += f"\n[chaos] no exit within the {timeout} s timeout: killed"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, delivered, seen, out, err


def load_child(args) -> None:
    """The launcher's graph load, and nothing after it: ``load_graph``, the
    edges as the launcher reads them (``LoadedGraph.edges``) and the
    canonical edge list the backend holds (``make_graph``), each with its
    edge count and a digest, printed as one JSON line. Device set-up comes
    first, as in the launcher, so the card's driver threads run meanwhile."""
    import faulthandler
    import hashlib

    import numpy as np

    faulthandler.register(signal.SIGUSR1, all_threads=True)

    from repro_torch.core.types import make_graph, resolve_device
    from repro_torch.graphs import load_graph

    def digest(*arrays) -> str:
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a, dtype=np.int64).tobytes())
        return h.hexdigest()[:16]

    resolve_device(args.device)
    g = load_graph(args.edge_list or args.dataset, scale=args.scale, seed=args.seed)
    src, dst = g.edges()
    graph, _ = make_graph(src, dst, g.num_nodes, "cpu")
    print(json.dumps({"source": g.source, "loaded_E": int(src.shape[0]),
                      "loaded": digest(src, dst), "E": graph.num_edges,
                      "graph": digest(graph.src.numpy(), graph.dst.numpy())}), flush=True)


def stop_load_check(args, env: dict, runs: int, workdir: str) -> dict:
    """Load the graph as the launcher does, once undisturbed and ``runs``
    times disturbed from the child's first instruction to its exit: stopped
    (SIGSTOP), a look at ``workdir``, continued, every ``args.stop_period``
    seconds. Every disturbed load
    must give the undisturbed one's edge counts and digests and exit within
    ``args.timeout``; one that does not has its threads' stacks printed
    (SIGUSR1) before it is killed. Its record, with ``errors`` (empty =
    pass)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.chaos", "--load-child",
           "--seed", str(args.seed), "--device", args.device]
    cmd += (["--edge-list", args.edge_list] if args.edge_list
            else ["--dataset", args.dataset, "--scale", str(args.scale)])
    t0 = time.perf_counter()
    want = run_to_completion(cmd, env, args.timeout)
    rec = {"undisturbed": want, "undisturbed_s": time.perf_counter() - t0,
           "period_s": args.stop_period, "disturbed": [], "errors": []}
    for _ in range(runs):
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        t0 = time.perf_counter()
        deadline, stops = time.time() + args.timeout, 0
        try:
            while time.time() < deadline and proc.poll() is None:
                os.kill(proc.pid, signal.SIGSTOP)
                try:
                    committed_steps(workdir)
                    stops += 1
                finally:
                    os.kill(proc.pid, signal.SIGCONT)
                time.sleep(args.stop_period)
            if proc.poll() is None:  # no exit in time: show where it is
                os.kill(proc.pid, signal.SIGUSR1)
                time.sleep(2.0)
                proc.kill()
            out, err = proc.communicate()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        run = {"seconds": time.perf_counter() - t0, "stops": stops, "rc": proc.returncode}
        rec["disturbed"].append(run)
        if proc.returncode != 0:
            rec["errors"].append(f"disturbed load rc={proc.returncode} after "
                                 f"{run['seconds']:.1f} s, {stops} stops\n{err[-6000:]}")
            continue
        run.update(parse_output(out))
        rec["errors"] += compare(run, want, LOAD_KEYS)
    return rec


def compare(got: dict, want: dict, keys=EXACT_KEYS) -> list[str]:
    """Mismatches of ``keys`` (empty = equal)."""
    return [f"{k}: got {got.get(k)!r} want {want.get(k)!r}"
            for k in keys if got.get(k) != want.get(k)]


def run_scenario(args, golden: dict, signame: str, step: int, workdir: str,
                 env: dict) -> dict:
    """One kill-and-resume scenario; its record, with ``errors`` (empty = pass)."""
    ckdir = os.path.join(workdir, f"ck_{signame}_{step}")
    shutil.rmtree(ckdir, ignore_errors=True)
    scen = {"signal": signame, "kill_step": step, "errors": []}
    t0 = time.perf_counter()
    rc, delivered, seen, out, err = kill_at_step(launcher_cmd(args, ckdir), env, ckdir,
                                                 step, signame, args.timeout)
    scen.update(kill_rc=rc, delivered=delivered, step_seen=seen,
                kill_wall_s=time.perf_counter() - t0)
    if not delivered:
        scen["errors"].append(f"run finished (rc={rc}) before step {step} committed: "
                              f"the kill step is too late for this workload\n{err[-2000:]}")
    elif signame == "KILL":
        if rc != -signal.SIGKILL:
            scen["errors"].append(f"SIGKILL rc {rc} != -9")
    elif rc == 0:  # TERM landed after the last sync point; the run completed
        scen["outcome"] = "completed"
        scen["errors"] += compare(parse_output(out), golden)
    elif rc != RESUMABLE_EXIT:
        scen["errors"].append(f"SIGTERM rc {rc} != {RESUMABLE_EXIT}\n{err[-2000:]}")
    else:
        rec = parse_output(out)
        if not rec.get("preempted"):
            scen["errors"].append(f"no preempted record: {rec}")
        scen["preempt_step"] = rec.get("checkpoint_step")
    if delivered and rc != 0 and not scen["errors"]:
        steps = committed_steps(ckdir)
        if not steps:
            scen["errors"].append("no committed checkpoint to resume")
            return scen
        scen["resume_from"] = steps[-1]
        out_r = subprocess.run(launcher_cmd(args, ckdir, resume=True), env=env,
                               capture_output=True, text=True, timeout=args.timeout)
        if out_r.returncode != 0:
            scen["errors"].append(f"resume rc={out_r.returncode}\n{out_r.stderr[-4000:]}")
            return scen
        resumed = parse_output(out_r.stdout)
        scen["resumed"] = resumed
        if resumed.get("resumed_from") != steps[-1]:
            scen["errors"].append(f"resumed from {resumed.get('resumed_from')}, the latest "
                                  f"committed step is {steps[-1]}")
        scen["errors"] += compare(resumed, golden)
        scen["outcome"] = "resumed"
    return scen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="dblp")
    ap.add_argument("--edge-list", default=None)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--k-frac", type=float, default=0.3)
    ap.add_argument("--T", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--group-size", type=int, default=32)
    ap.add_argument("--driver-chunk", type=int, default=1)
    ap.add_argument("--checkpoint-every", type=int, default=1)
    ap.add_argument("--checkpoint-keep", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--kill", action="append", default=[], metavar="SIG:STEP",
                    help="scenario: deliver SIG (TERM|KILL) once checkpoint STEP "
                         "is committed (repeatable; default TERM:2 and KILL:2, none "
                         "with --stop-load)")
    ap.add_argument("--workdir", default=None, help="scratch dir (default: a temp dir)")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--stop-load", type=int, default=0, metavar="N",
                    help="first load the graph as the launcher does, once undisturbed "
                         "and N times SIGSTOP/SIGCONT'd throughout, and compare")
    ap.add_argument("--stop-period", type=float, default=LOAD_SAMPLE_S, metavar="S",
                    help="--stop-load: seconds between two stops")
    ap.add_argument("--load-child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.load_child:
        load_child(args)
        return 0
    kills = args.kill or ([] if args.stop_load else ["TERM:2", "KILL:2"])

    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos-")
    os.makedirs(workdir, exist_ok=True)
    env = launcher_env()
    report = {"ok": True, "scenarios": []}
    if args.stop_load:
        report["stop_load"] = stop_load_check(args, env, args.stop_load, workdir)
        report["ok"] &= not report["stop_load"]["errors"]
    if kills:
        golden = run_to_completion(launcher_cmd(args), env, args.timeout)
        report["golden"] = golden
    for spec in kills:
        signame, step = spec.split(":")
        scen = run_scenario(args, golden, signame, int(step), workdir, env)
        report["ok"] &= not scen["errors"]
        report["scenarios"].append(scen)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
