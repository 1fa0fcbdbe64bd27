"""Modularity clustering of a social network — the paper's §VI
generalization, built on the same multilevel cluster-contraction machinery
as the partitioner (PyTorch/CUDA port; twin of
``examples/cluster_modularity.py``).  The clustering is host numpy, as in
the reference; ``--device`` is checked like every entry point's.

    PYTHONPATH=src python examples/torch/cluster_modularity.py [--device cuda|cpu]
"""

import argparse

import numpy as np

from repro_torch.core import louvain, modularity
from repro_torch.device import resolve_device
from repro_torch.graph import planted_partition

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
resolve_device(args.device)

g = planted_partition(8192, 16, p_in=0.03, p_out=0.0005, seed=0)
lab, q = louvain(g, seed=0)
sizes = np.sort(np.bincount(lab))[::-1]
print(f"graph: n={g.n} m={g.m // 2}")
print(f"louvain modularity Q={q:.4f} (random labels: "
      f"{modularity(g, np.random.default_rng(0).integers(0, 16, g.n)):.4f})")
print(f"clusters: {np.unique(lab).size}, largest sizes: {sizes[:8]}")
