"""The port's benchmark: one run of one cell.

    python3 bench/run.py --workload skitter.summarize --seed 7 --seconds 10 --trace 0

Run from the root of a checkout on a machine with the card(s) the cell asks
for. Set-up (imports, CUDA, the hand kernels, the cell's graph made on the
card from ``--seed``, one warm-up summarization) is ``setup_s``; then whole
summarizations run back to back for ``--seconds``; then the plain reference
judges what they returned. The last line of standard output is the result as
one JSON object; the numbers compared, each beside its limit, are the last
lines of standard error. With ``--trace 1`` the window's first runs (12 s
of them) run under ``torch.profiler`` and the result carries the per-layer
metrics instead of the end-to-end ones. Exits non-zero, with no result, without the card(s), or
when a module of ``jax``, ``jaxlib``, ``flax`` or ``repro`` is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness, roofline

    harness.cache_dirs(ROOT)

    try:
        result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START)
    except harness.NoChip as exc:
        print(f"bench: no result: {exc}", file=sys.stderr)
        return 3
    card = _power_limit()
    result["device"]["power_limit"] = card
    print(f"card (name, power limit): {card}; yardstick: {roofline.H100_SXM}",
          file=sys.stderr)
    checks = result["checks"]
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
