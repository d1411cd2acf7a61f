"""Multi-host gate of the port: the launcher as N processes, each started
with the bootstrap's flags, must give what one ``torchrun`` of N ranks gives.

    PYTHONPATH=src python tests/torch_multihost_check.py \
        --edge-list g.txt --T 4 --num-processes 2 [--device cpu|cuda]

Port of ``tests/multihost_check.py``. Four legs, each a real
``repro_torch.launch.summarize --distributed`` invocation (this harness
imports neither package; every child owns its ranks):

  golden    ``torchrun --nproc-per-node N`` on this host; also ingests the
            edge list into the CSR cache the fleet feeds from. The rank
            count matches the fleet's: across rank counts ``node2super`` and
            ``size_bits`` are the same, but ``re1`` may move by one ulp.
  multihost N processes joined at a localhost coordinator
            (``--coordinator localhost:PORT --num-processes N --process-id
            i``), split over two "hosts" by ``LOCAL_RANK`` (0 … N/2 − 1 on
            each; with ``--device cuda`` one host of N cards). Every process
            prints its own digests and JSON, which must equal the golden's
            on every exact key and digest and its peers',
            report ``feed_path`` ``cache-mmap-multihost``, ``process_count``
            N and ``feed_local_shards`` 1, and prove host-local staging:
            ``feed_bytes_copied == 2 · feed_shard_bytes`` (both columns of its
            one shard), ``feed_peak_staging_bytes == feed_shard_bytes`` and,
            with ``--rss-budget-mb``, a peak RSS under the budget.
  resume    the fleet with ``--checkpoint-dir`` and ``--checkpoint-every 1``
            (``--driver-chunk 1`` in every leg); once step 2 has committed
            every process gets SIGTERM, must exit 75 and print a
            ``preempted`` record; the fleet relaunched with ``--resume`` must
            report ``resumed_from`` and equal the golden.
  wire      ``tests/torch_wire_check.py`` over the same N processes.

``--device cpu`` (the default) runs gloo; ``cuda`` runs NCCL, one card a
process, so it needs N cards on this host. Prints the report JSON last;
exit 0 when every leg holds.
"""

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESUMABLE_EXIT = 75  # repro_torch.runtime.RESUMABLE_EXIT (this harness imports no torch)
KILL_STEP = 2  # the resume leg's SIGTERM lands once this step has committed

#: launcher JSON keys that must be bit-identical across the launches
EXACT_KEYS = ("V", "E", "mode", "size_bits", "size_bits_before_sparsify",
              "relative_size", "re1", "re2", "num_supernodes",
              "num_superedges", "superedges_dropped", "digests")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launcher_args(args, extra=()) -> list[str]:
    cmd = ["-m", "repro_torch.launch.summarize", "--edge-list", args.edge_list,
           "--T", str(args.T), "--driver-chunk", "1", "--distributed", "--device",
           args.device]
    if args.rss_budget_mb is not None:
        cmd += ["--rss-budget-mb", str(args.rss_budget_mb)]
    return cmd + list(extra)


def child_env(**extra) -> dict:
    env = dict(os.environ)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT", "SSUMM_COORDINATOR", "SSUMM_NUM_PROCESSES", "SSUMM_PROCESS_ID"):
        env.pop(k, None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.setdefault("OMP_NUM_THREADS", "1")
    # gloo picks its interface from the host name, which a container may not
    # resolve; every rank of this check is on the loopback interface
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.update(extra)
    return env


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


def committed_steps(ckdir: str) -> list[int]:
    if not os.path.isdir(ckdir):
        return []
    return sorted(int(n[len("step_"):]) for n in os.listdir(ckdir)
                  if n.startswith("step_") and os.path.exists(os.path.join(ckdir, n, "COMMIT")))


def compare(got: dict, want: dict, exact=EXACT_KEYS) -> list[str]:
    return [f"{k}: got {got.get(k)!r} want {want.get(k)!r}" for k in exact
            if (k in got or k in want) and got.get(k) != want.get(k)]


class Fleet:
    """N processes of one command, process i with ``extra(i, port)``'s flags
    and environment; stdout and stderr go to files in ``workdir``."""

    def __init__(self, n: int, argv_env, workdir: str, tag: str):
        port = free_port()
        self.procs, self.files = [], []
        for i in range(n):
            argv, env = argv_env(i, port)
            out = open(os.path.join(workdir, f"{tag}_p{i}.out"), "w+")
            err = open(os.path.join(workdir, f"{tag}_p{i}.err"), "w+")
            self.procs.append(subprocess.Popen([sys.executable, *argv], env=env, cwd=ROOT,
                                               stdout=out, stderr=err))
            self.files.append((out, err))

    def poll_done(self) -> bool:
        return all(p.poll() is not None for p in self.procs)

    def signal_all(self, sig) -> None:
        for p in self.procs:
            if p.poll() is None:
                os.kill(p.pid, sig)

    def finish(self, timeout: float):
        """Wait (killing what outlives ``timeout``); ``(rcs, stdouts, stderrs)``."""
        deadline = time.time() + timeout
        try:
            for p in self.procs:
                try:
                    p.wait(timeout=max(deadline - time.time(), 1.0))
                except subprocess.TimeoutExpired:
                    break
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs, errs = [], []
        for out, err in self.files:
            for f, acc in ((out, outs), (err, errs)):
                f.flush()
                f.seek(0)
                acc.append(f.read())
                f.close()
        return [p.returncode for p in self.procs], outs, errs


def main() -> None:
    ap = argparse.ArgumentParser(description="the port's process-spanning bit-identity gate")
    ap.add_argument("--edge-list", required=True)
    ap.add_argument("--T", type=int, default=12)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="gloo on the CPU (default), or NCCL with one card a process")
    ap.add_argument("--rss-budget-mb", type=float, default=None,
                    help="per-process peak-RSS gate for every leg")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a leg may take before its processes are killed")
    args = ap.parse_args()
    n = args.num_processes
    if n < 2 or n % 2:
        ap.error("--num-processes must be even and at least 2 (two hosts)")
    args.edge_list = os.path.abspath(args.edge_list)

    workdir = args.workdir or os.path.join(os.environ.get("TMPDIR", "/tmp"),
                                           f"torch_multihost_{os.getpid()}")
    os.makedirs(workdir, exist_ok=True)
    report = {"ok": True, "device": args.device, "num_processes": n, "legs": {},
              "errors": []}
    walls = {}

    def fail(msg):
        report["ok"] = False
        report["errors"].append(msg)

    def local_rank(i: int) -> str:
        # on the CPU, two "hosts" of N/2 processes each; NCCL takes one card
        # a process, all on this host
        return str(i % (n // 2) if args.device == "cpu" else i)

    def fleet(extra, tag):
        def argv_env(i, port):
            argv = launcher_args(args, tuple(extra) + (
                "--coordinator", f"localhost:{port}", "--num-processes", str(n),
                "--process-id", str(i)))
            return argv, child_env(LOCAL_RANK=local_rank(i))
        return Fleet(n, argv_env, workdir, tag)

    # ---- golden: torchrun with N ranks on one host (warms the cache) -------
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(n), *launcher_args(args)], env=child_env(), cwd=ROOT, capture_output=True,
        text=True, timeout=args.timeout)
    walls["golden"] = time.time() - t0
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"golden run failed rc={out.returncode}")
    golden = parse_output(out.stdout)
    report["legs"]["golden"] = {k: golden.get(k) for k in EXACT_KEYS}
    report["legs"]["golden"]["peak_rss_mb"] = golden.get("peak_rss_mb")

    # ---- multihost: N processes through the bootstrap ----------------------
    t0 = time.time()
    rcs, outs, errs = fleet((), "mh").finish(args.timeout)
    walls["multihost"] = time.time() - t0
    leg = {"rcs": rcs, "procs": []}
    jsons = []
    for i, (rc, so, se) in enumerate(zip(rcs, outs, errs)):
        if rc != 0:
            fail(f"multihost p{i} rc={rc}: {se[-2000:]}")
            continue
        j = parse_output(so)
        jsons.append(j)
        for msg in compare(j, golden):
            fail(f"multihost p{i} vs golden: {msg}")
        if j.get("process_index") != i:
            fail(f"multihost p{i} process_index={j.get('process_index')}")
        if j.get("feed_path") != "cache-mmap-multihost":
            fail(f"multihost p{i} feed_path={j.get('feed_path')!r}")
        if j.get("process_count") != n:
            fail(f"multihost p{i} process_count={j.get('process_count')}")
        # host-local staging: this process staged its own shard alone, one
        # staging buffer at a time
        if j.get("feed_local_shards") != 1:
            fail(f"multihost p{i} feed_local_shards={j.get('feed_local_shards')} != 1")
        if j.get("feed_bytes_copied") != 2 * j["feed_shard_bytes"]:
            fail(f"multihost p{i} feed_bytes_copied={j.get('feed_bytes_copied')} != "
                 f"2 x {j['feed_shard_bytes']}")
        if j.get("feed_peak_staging_bytes") != j.get("feed_shard_bytes"):
            fail(f"multihost p{i} staged more than one shard: "
                 f"{j.get('feed_peak_staging_bytes')}")
        leg["procs"].append({k: j.get(k) for k in (
            "process_index", "peak_rss_mb", "feed_path", "feed_local_shards",
            "feed_shard_rows", "feed_shard_bytes", "feed_peak_staging_bytes",
            "feed_bytes_copied")})
    for j in jsons[1:]:
        for msg in compare(j, jsons[0]):
            fail(f"multihost peers disagree: {msg}")
    report["legs"]["multihost"] = leg

    # ---- resume: SIGTERM the whole fleet, then --resume --------------------
    ckdir = os.path.join(workdir, "ck")
    shutil.rmtree(ckdir, ignore_errors=True)
    ck_extra = ("--checkpoint-dir", ckdir, "--checkpoint-every", "1")
    t0 = time.time()
    kill = fleet(ck_extra, "kill")
    delivered = False
    deadline = time.time() + args.timeout
    while time.time() < deadline and not kill.poll_done():
        steps = committed_steps(ckdir)
        if steps and steps[-1] >= KILL_STEP:
            kill.signal_all(signal.SIGTERM)
            delivered = True
            break
        time.sleep(0.01)
    rcs, outs, errs = kill.finish(args.timeout)
    leg = {"delivered": delivered, "kill_rcs": rcs}
    errors_before = len(report["errors"])
    if not delivered:
        # the fleet finished before the kill step committed: compare the
        # completed runs (the kill step is too late for this workload)
        leg["outcome"] = "completed"
        for i, (rc, so) in enumerate(zip(rcs, outs)):
            if rc != 0:
                fail(f"resume-leg p{i} completed rc={rc}")
            else:
                for msg in compare(parse_output(so), golden):
                    fail(f"resume-leg completed p{i}: {msg}")
    else:
        for i, (rc, so, se) in enumerate(zip(rcs, outs, errs)):
            if rc != RESUMABLE_EXIT:
                fail(f"resume-leg p{i} SIGTERM rc={rc} != {RESUMABLE_EXIT}\n{se[-2000:]}")
            elif not parse_output(so).get("preempted"):
                fail(f"resume-leg p{i} printed no preempted record")
        if not committed_steps(ckdir):
            fail("resume-leg: no committed checkpoint to resume from")
        elif len(report["errors"]) == errors_before:
            leg["resume_from"] = committed_steps(ckdir)[-1]
            rcs, outs, errs = fleet(ck_extra + ("--resume",), "resume").finish(args.timeout)
            leg["resume_rcs"] = rcs
            for i, (rc, so, se) in enumerate(zip(rcs, outs, errs)):
                if rc != 0:
                    fail(f"resume p{i} rc={rc}: {se[-2000:]}")
                    continue
                j = parse_output(so)
                if j.get("resumed_from") is None:
                    fail(f"resume p{i} did not report resumed_from")
                for msg in compare(j, golden):
                    fail(f"resume p{i} vs golden: {msg}")
            leg["outcome"] = "resumed"
    walls["resume"] = time.time() - t0
    report["legs"]["resume"] = leg

    # ---- wire: the compressed all-reduce across the same processes ---------
    t0 = time.time()

    def wire_argv_env(i, port):
        return ([os.path.join(ROOT, "tests", "torch_wire_check.py"), "--device", args.device],
                child_env(SSUMM_COORDINATOR=f"localhost:{port}", SSUMM_NUM_PROCESSES=str(n),
                          SSUMM_PROCESS_ID=str(i), LOCAL_RANK=local_rank(i)))

    rcs, outs, errs = Fleet(n, wire_argv_env, workdir, "wire").finish(args.timeout)
    leg = {"rcs": rcs, "wire_bytes": []}
    for i, (rc, so, se) in enumerate(zip(rcs, outs, errs)):
        if rc != 0:
            fail(f"wire p{i} rc={rc}: {so[-1500:]} {se[-1500:]}")
        else:
            leg["wire_bytes"].append(json.loads(so.strip().splitlines()[-1])["wire_bytes"])
    walls["wire"] = time.time() - t0
    report["legs"]["wire"] = leg

    report["walls"] = walls
    print(json.dumps(report, indent=1))
    raise SystemExit(0 if report["ok"] else 1)


if __name__ == "__main__":
    main()
