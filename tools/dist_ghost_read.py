#!/usr/bin/env python3
"""Cut cost of the reference's shifted ghost read in the distributed sweep.

The reference's ``_shard_sweep`` reads PE p's ghost j at ``maxN + j`` of
its local-ext labels, while the chunk heads address it as ``n_p + j``;
``repro_torch`` reads where the reference reads, for parity.  This script
partitions ``chip_smoke.py``'s phase-8b case (``rmat(scale, edge_factor,
seed=1)`` without its isolated nodes, k=16, ``engine="dist"``,
``dist_shards=8``, ``preset="minimal"``, ``coarsest_factor=100``, seed 0,
every PE on the card) twice: with the sweep as it is, and with each ghost
read at ``n_p + j``.  It prints one JSON line with the card, each run's
seconds, cut, cut over the hash partition's, level sizes and feasibility,
and the corrected cut over the parity cut:

    python3 tools/dist_ghost_read.py
    python3 tools/dist_ghost_read.py --scale 14     # quick
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def owned_ghost_read(st, ll, lg):
    """Local-ext labels with ghost j at ``n_p + j``, where the chunk heads
    address it (the slots past ``n_p + maxG`` hold the local pad labels)."""
    import torch

    maxN, maxG = ll.shape[0], lg.shape[0]
    n_p = st.local_valid.sum()
    idx = torch.arange(maxN + maxG, device=ll.device)
    src = torch.where(idx < n_p, idx,
                      torch.where(idx < n_p + maxG, idx - n_p + maxN, idx - maxG))
    return torch.cat([ll, lg])[src]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=19)
    ap.add_argument("--edge-factor", type=int, default=16)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("dist_ghost_read: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import repro_torch.core.distributed_lp as TD
    from chip_smoke import _card_line, _dist_cfg, make_graph
    from repro_torch.core import hash_partition, partition
    from repro_torch.core.metrics import cut_np

    k = 16
    g = make_graph(args.scale, args.edge_factor)
    hash_cut = cut_np(g, hash_partition(g.n, k))
    runs = {}
    parity_read = TD._labels_ext
    for name, read in (("reference_read", parity_read), ("owned_read", owned_ghost_read)):
        TD._labels_ext = read
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            rep = partition(g, _dist_cfg(k=k, coarsest_factor=100))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            TD._labels_ext = parity_read
        runs[name] = dict(wall_s=wall, cut=rep.cut, of_hash=rep.cut / hash_cut,
                          feasible=rep.feasible, imbalance=rep.imbalance,
                          level_sizes=rep.level_sizes, cycle_cuts=rep.cycle_cuts)
    print(json.dumps({
        "card": _card_line(),
        "graph": f"rmat({args.scale}, {args.edge_factor}) without isolated nodes, "
                 f"n={g.n}, m={g.m}",
        "hash_cut": hash_cut,
        "runs": runs,
        "owned_over_reference_cut": runs["owned_read"]["cut"] / runs["reference_read"]["cut"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
