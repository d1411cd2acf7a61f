"""The port's copies of the LM examples (``examples/torch_train_lm.py``,
``examples/torch_serve_lm.py``), each run as a script on the CPU at its
reduced size: training lowers the loss, serving answers every request."""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script: str, *args) -> tuple[dict, str]:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SSUMM_NUM_PROCESSES"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", script), *args],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1, proc.stdout[-3000:]
    return lines[0], proc.stdout


def test_the_training_example_lowers_the_loss_on_the_cpu():
    res, out = _run("torch_train_lm.py", "--tiny", "--steps", "8", "--device", "cpu")
    assert res["device"] == "cpu" and res["steps"] == 8
    assert res["loss_last"] < res["loss_first"]
    assert "first loss" in out


def test_the_serving_example_answers_every_request_on_the_cpu():
    res, out = _run("torch_serve_lm.py", "--device", "cpu")
    assert res["device"] == "cpu" and res["requests"] == 12
    assert res["tokens"] == 12 * 24 and "throughput" in out
