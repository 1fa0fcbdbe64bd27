"""End-to-end LM training with checkpoint/restart (100M-class reduced
model) on the port (PyTorch/CUDA; twin of ``examples/train_lm.py``).

Trains a few hundred steps on the synthetic pipeline, checkpoints, then
simulates a failure + resume.

    PYTHONPATH=src python examples/torch/train_lm.py [--steps 300] [--device cuda|cpu]
"""

import argparse
import shutil
import tempfile

from repro_torch.launch.train import main as train_main

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--arch", default="granite-moe-1b-a400m")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

ckpt = tempfile.mkdtemp(prefix="repro_ckpt_")
half = args.steps // 2
common = ["--arch", args.arch, "--smoke", "--batch", "8", "--seq", "64",
          "--lr", "3e-3", "--ckpt-dir", ckpt, "--ckpt-every", "50",
          "--log-every", "25", "--device", args.device]
try:
    print(f"=== phase 1: train to step {half}, then 'fail' ===")
    train_main(common + ["--steps", str(half)])
    print("=== phase 2: restart from the last checkpoint and finish ===")
    losses = train_main(common + ["--steps", str(args.steps), "--resume"])
    print(f"=== final loss {losses[-1]:.4f} (log(V) ~ 5.5 at random) ===")
finally:
    shutil.rmtree(ckpt, ignore_errors=True)
