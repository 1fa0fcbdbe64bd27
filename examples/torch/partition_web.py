"""Distributed partitioning of a larger web-graph stand-in over 8 PEs
(PyTorch/CUDA port; twin of ``examples/partition_web.py``).

Runs the full multilevel system with the distributed LP engine on 8 PEs —
the laptop-scale replica of the paper's 512-core uk-2007 run.  On CUDA the
PEs sit on the visible cards in turn (PE p on card p mod count); with
``--device cpu`` all eight run on the CPU.

    PYTHONPATH=src python examples/torch/partition_web.py [--device cuda|cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import PartitionerConfig, partition
from repro_torch.core.distributed_lp import build_plan
from repro_torch.device import resolve_device
from repro_torch.graph import barabasi_albert

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = resolve_device(args.device)
devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
           if dev.type == "cuda" else [dev])

g = barabasi_albert(32768, 8, seed=1)
print(f"graph: n={g.n} m={g.m // 2} edges")
plan = build_plan(g, 8)
gf = float(plan.sg.n_ghost.sum()) / g.n
print(f"8 shards; ghost-node fraction {gf:.2%} (paper: 40% on del31, "
      f"<0.5% on rgg31)")

print(f"PEs on {len(devices)} {dev.type} device(s)")
t0 = time.time()
rep = partition(g, PartitionerConfig(k=16, preset="fast", coarsest_factor=20,
                                     seed=0, engine="dist", dist_shards=8),
                device=dev, devices=devices)
print(f"k=16 cut={rep.cut:.0f} imbalance={rep.imbalance:.4f} "
      f"feasible={rep.feasible} time={time.time() - t0:.1f}s")
