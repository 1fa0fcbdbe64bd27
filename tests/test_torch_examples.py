"""The port's example twins (``examples/torch``) on the CPU: the five that
finish in seconds (``train_lm`` with 20 steps) run with ``--device cpu`` in
a subprocess, exit 0 and print the lines of their reference examples, or
for the LM twins the port's own seeded lines (the rest run on the card,
through ``chip_smoke.py`` phases 10-12 and by hand)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

CASES = {
    "quickstart": (
        "graph: n=8192 m=",
        "[ours/fast]  cut=38436  imbalance=0.0298 feasible=True",
        "[hash]       cut=48832  imbalance=0.0347",
        "block weights: [2109 1865 2109 2109]",
    ),
    "cluster_modularity": (
        "louvain modularity Q=0.7475 (random labels: -0.0001)",
        "clusters: 16, largest sizes: [512 512 512 512 512 512 512 512]",
    ),
    "autoshard_moe": (
        "cross-group co-activation per token: contiguous=1.925 partitioned=1.045",
        "group sizes: [8 8 8 8] (balanced = 8 per group)",
    ),
    "serve_lm": (
        "[prefill] 4x32 in ",
        "[decode] 15 steps in ",
        "[sample tokens] [196  66 120 122 220 220 220 220 220 220 220 220 220 220 220 220]",
    ),
    "train_lm": (
        "=== phase 1: train to step 10, then 'fail' ===",
        "step     0 loss   5.6068 ce   5.5635 gnorm   1.055 (",
        "[done] first loss 5.6068 -> last 5.2134",
        "[resume] restored step 9, continuing at 10",
        "step    19 loss   4.8405 ce   4.7991 gnorm   0.544 (",
        "=== final loss 4.8405 (log(V) ~ 5.5 at random) ===",
    ),
}
#: extra arguments of a twin: a short run
ARGS = {"train_lm": ["--steps", "20"]}


@pytest.mark.parametrize("name", list(CASES))
def test_twin_runs_on_cpu(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"),
         "--device", "cpu"] + ARGS.get(name, []),
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    for line in CASES[name]:
        assert line in out.stdout, (line, out.stdout)
