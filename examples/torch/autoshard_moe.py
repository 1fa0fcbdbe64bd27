"""Partitioner-guided MoE expert placement (PyTorch/CUDA port; twin of
``examples/autoshard_moe.py``).

Builds an expert co-activation graph from router decisions with skewed
correlations, then compares cross-group all_to_all traffic under (a) the
default contiguous placement vs (b) SCLaP placement.

    PYTHONPATH=src python examples/torch/autoshard_moe.py [--device cuda|cpu]
"""

import argparse

import numpy as np

from repro_torch.core.autoshard import (
    crossgroup_traffic, expert_placement,
)

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

rng = np.random.default_rng(0)
E, k, groups, T = 32, 4, 4, 20000

# correlated router: experts come in "teams" that fire together, but teams
# are scattered across the default contiguous grouping
teams = rng.permutation(E).reshape(8, 4)
topi = np.zeros((T, k), dtype=np.int64)
for t in range(T):
    team = teams[rng.integers(8)]
    picks = rng.choice(team, size=min(k, 3), replace=False)
    rest = rng.integers(0, E, k - picks.size)
    topi[t] = np.concatenate([picks, rest])

contiguous = np.arange(E) // (E // groups)
ours = expert_placement(topi, E, groups, seed=0, device=args.device)
t_def = crossgroup_traffic(topi, contiguous)
t_ours = crossgroup_traffic(topi, ours)
print(f"experts={E} topk={k} ep_groups={groups} tokens={T}")
print(f"cross-group co-activation per token: contiguous={t_def:.3f} "
      f"partitioned={t_ours:.3f}  ({100 * (t_def - t_ours) / t_def:.1f}% less "
      f"all_to_all spread)")
sizes = np.bincount(ours, minlength=groups)
print("group sizes:", sizes, "(balanced =", E // groups, "per group)")
assert t_ours < t_def
