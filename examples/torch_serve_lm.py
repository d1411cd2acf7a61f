"""Serving example: continuous-batching decode over the Model API, on the
PyTorch port.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

Submits a burst of requests against a reduced gemma-family model and
reports throughput / latency percentiles from the BatchServer scheduler
(the production shardings for this path are exercised by the decode_32k /
long_500k dry-run cells). It runs on the card unless ``--device cpu`` is
given.
"""

import argparse

from repro_torch.launch import serve as serve_launch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    res = serve_launch.main([
        "--arch", "gemma_7b", "--smoke",
        "--requests", "12", "--slots", "4",
        "--prompt-len", "16", "--gen-len", "24", "--max-len", "128",
        "--device", args.device,
    ])
    print(f"\nthroughput {res['tok_per_s']:.1f} tok/s | "
          f"p50 latency {res['p50_latency_s']*1e3:.0f} ms | "
          f"p50 TTFT {res['p50_ttft_s']*1e3:.0f} ms")


if __name__ == "__main__":
    main()
