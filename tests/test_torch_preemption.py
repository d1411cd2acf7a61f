"""Preemption of the port end to end, in subprocesses on the CPU: SIGTERM
and SIGINT save and exit ``RESUMABLE_EXIT``, the committed checkpoint
resumes bit-identically, a half-written ``.tmp-`` directory is ignored, a
second signal hard-exits; and the port's launcher, SIGTERM'd or SIGKILL'd
at a checkpoint step by ``repro_torch.launch.chaos``, resumes to the
uninterrupted run's result. The port's copy of tests/test_preemption.py
and tests/test_chaos.py (local mode)."""

import json
import os
import signal
import subprocess
import sys

import pytest

from repro_torch.runtime import RESUMABLE_EXIT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    # one intra-op thread: small graphs, a shared CPU
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")


def _run(mode, d, timeout=300):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "torch_preempt_check.py"), mode,
         "--dir", str(d)],
        capture_output=True, text=True, timeout=timeout, env=_env())


def _last_json(out):
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mode,signame", [("term", "SIGTERM"), ("int", "SIGINT")])
def test_signal_saves_and_resumes_bit_identical(tmp_path, mode, signame):
    d = tmp_path / mode
    out = _run(mode, d)
    assert out.returncode == RESUMABLE_EXIT, \
        f"{signame}: rc={out.returncode}\nstderr:\n{out.stderr}"
    rec = _last_json(out)
    assert rec["preempted"] and rec["step"] == 2  # the first chunk boundary
    step_dir = d / f"step_{rec['step']:010d}"
    assert (step_dir / "COMMIT").exists() and (step_dir / "manifest.json").exists()

    # a torn half-write beside it must not confuse the restore
    junk = d / ".tmp-99"
    junk.mkdir()
    (junk / "garbage.npy").write_bytes(b"\x00" * 16)

    golden = _last_json(_run("golden", tmp_path / "unused"))
    resumed = _run("resume", d)
    assert resumed.returncode == 0, resumed.stderr
    rec_r = _last_json(resumed)
    assert rec_r.pop("resumed_from") == rec["step"]
    assert rec_r == golden  # final metrics and partition, bit for bit
    assert not junk.exists()  # the next save's garbage collection removed it


def test_second_signal_hard_exits(tmp_path):
    out = _run("double", tmp_path / "double")
    assert out.returncode == 128 + signal.SIGTERM, \
        f"rc={out.returncode}\nstderr:\n{out.stderr}"


@pytest.mark.parametrize("kill", ["TERM:2", "KILL:4"])
def test_launcher_killed_at_a_step_resumes_to_the_golden(tmp_path, kill):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.chaos", "--dataset", "ego-facebook",
         "--scale", "0.05", "--T", "8", "--driver-chunk", "1", "--device", "cpu",
         "--kill", kill, "--workdir", str(tmp_path), "--timeout", "300"],
        capture_output=True, text=True, timeout=900, env=_env())
    assert out.returncode == 0, f"stdout:\n{out.stdout[-6000:]}\nstderr:\n{out.stderr[-3000:]}"
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    (scen,) = rep["scenarios"]
    assert rep["ok"] and scen["delivered"] and not scen["errors"]
    assert scen["outcome"] == "resumed"
    if kill.startswith("TERM"):
        assert scen["kill_rc"] == RESUMABLE_EXIT
        assert scen["resume_from"] == scen["preempt_step"] >= 2
    else:
        assert scen["kill_rc"] == -signal.SIGKILL and scen["resume_from"] >= 4
    resumed = scen["resumed"]
    assert resumed["resumed_from"] == scen["resume_from"]
    assert resumed["digests"] == rep["golden"]["digests"]
    assert resumed["iterations"] == rep["golden"]["iterations"] == 8


def test_launcher_resume_needs_a_checkpoint_dir():
    from repro_torch.launch import summarize as launch

    with pytest.raises(SystemExit) as ei:
        launch.main(["--dataset", "ego-facebook", "--scale", "0.02", "--resume",
                     "--device", "cpu"])
    assert ei.value.code == 2  # argparse's usage error


def test_graph_load_stopped_and_continued_gives_the_same_graph(tmp_path):
    """The launcher's graph load (an edge list's CSR cache, mmap'd, then
    canonicalized), SIGSTOP/SIGCONT'd every 2 ms from its first instruction
    to its exit, gives the undisturbed load's edge counts and digests."""
    from repro_torch.graphs import load_graph, write_edge_list
    from repro_torch.graphs.synthetic import generate

    src, dst, v = generate("ego-facebook", seed=0, scale=0.05)
    path = str(tmp_path / "g.txt")
    write_edge_list(path, src, dst, v, shuffle=True, dup_frac=0.01, self_loops=5)
    assert load_graph(path).source == "real"  # the cache the launcher then reads
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.chaos", "--edge-list", path,
         "--device", "cpu", "--stop-load", "2", "--workdir", str(tmp_path / "w"),
         "--timeout", "300"],
        capture_output=True, text=True, timeout=600, env=_env())
    assert out.returncode == 0, f"stdout:\n{out.stdout[-6000:]}\nstderr:\n{out.stderr[-3000:]}"
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    check = rep["stop_load"]
    assert rep["ok"] and not check["errors"] and not rep["scenarios"]
    assert check["undisturbed"]["source"] == "cache"
    assert check["undisturbed"]["E"] == check["undisturbed"]["loaded_E"] == len(src)
    assert [run["rc"] for run in check["disturbed"]] == [0, 0]
    assert min(run["stops"] for run in check["disturbed"]) >= 100
