"""Batched serving on the port: prefill a prompt batch, decode with KV
caches (PyTorch/CUDA port; twin of ``examples/serve_lm.py``).

    PYTHONPATH=src python examples/torch/serve_lm.py [--device cuda|cpu]
"""

import argparse

from repro_torch.launch.serve import main

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

main(["--arch", "qwen2.5-3b", "--smoke", "--batch", "4", "--prompt-len", "32", "--gen", "16",
      "--device", args.device])
