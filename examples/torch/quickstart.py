"""Quickstart: partition a synthetic web graph with the paper's system
(PyTorch/CUDA port; twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch/quickstart.py [--device cuda|cpu]
"""

import argparse

from repro_torch.core import PartitionerConfig, hash_partition, partition
from repro_torch.core.metrics import cut_np, imbalance_np, quotient_graph_np
from repro_torch.graph import rmat

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

g = rmat(13, 8, seed=2)  # 8k-node web-graph stand-in
print(f"graph: n={g.n} m={g.m // 2} edges, max degree {g.degrees().max()}")

k = 4
rep = partition(g, PartitionerConfig(k=k, preset="fast", coarsest_factor=50,
                                     seed=0), device=args.device)
print(f"[ours/fast]  cut={rep.cut:.0f}  imbalance={rep.imbalance:.4f} "
      f"feasible={rep.feasible}  time={rep.seconds:.1f}s")
print(f"  hierarchy levels: {rep.level_sizes}")
print(f"  first-contraction shrink: {rep.shrink_first:.3f}")

hb = hash_partition(g.n, k)
print(f"[hash]       cut={cut_np(g, hb):.0f}  imbalance={imbalance_np(g, hb, k):.4f}")

q, bw = quotient_graph_np(g, rep.labels, k)
print("quotient graph inter-block weights:\n", q.astype(int))
print("block weights:", bw.astype(int))
