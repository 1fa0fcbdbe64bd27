"""Streaming edge updates into a device-resident PartitionSession
(PyTorch/CUDA port; twin of ``examples/partition_stream.py``).

The serving workload the dynamic subsystem exists for: partition once, keep
the graph + labels resident on the device, absorb batched edge/node updates
with incremental h-hop repair, and let the quality guard escalate to a full
V-cycle only when local repair can no longer hold the cut.  The port
compiles nothing per shape, so the footer counts shape buckets only.

    PYTHONPATH=src python examples/torch/partition_stream.py [--device cuda|cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.dynamic import GraphUpdate, PartitionSession, SessionConfig
from repro_torch.graph import rmat

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

g = rmat(13, 8, seed=2)
k = 8
print(f"graph: rmat n={g.n} m={g.m // 2} edges, k={k}")

t0 = time.time()
sess = PartitionSession(g, SessionConfig(k=k, seed=0, escalate_cut_ratio=1.25),
                        device=args.device)
print(f"initial partition: cut={sess.cut:.0f} imbalance={sess.imbalance:.4f} "
      f"({time.time() - t0:.1f}s)\n")

rng = np.random.default_rng(7)
src0 = g.arc_sources()
removed = src0 >= g.indices               # sample each undirected edge once
nb = g.m // 2 // 100                      # ~1% churn per batch

print("step,cut,imbalance,region,escalated,seconds")
for step in range(12):
    au = rng.integers(0, sess.n, nb)
    av = (au + 1 + rng.integers(0, sess.n - 1, nb)) % sess.n
    cand = rng.permutation(np.flatnonzero(~removed))[: nb // 2]
    removed[cand] = True
    upd = GraphUpdate.add_edges(au, av).merged(
        GraphUpdate.remove_edges(src0[cand], g.indices[cand])
    )
    if step == 5:
        # mid-stream node churn: 64 fresh nodes, wired up next batch
        upd = upd.merged(GraphUpdate.add_nodes(np.ones(64, np.int64)))
    res = sess.update(upd)
    flag = " <-- escalated to full V-cycle" if res.escalated else ""
    print(f"{res.step},{res.cut:.0f},{res.imbalance:.4f},{res.region_size},"
          f"{res.escalated},{res.seconds:.2f}{flag}")

st = sess.stats()
print(f"\n{st['updates']} updates: {st['repair_calls']} repairs "
      f"({st['repair_bucket_count']} buckets), {st['compact_calls']} "
      f"compactions ({st['compact_bucket_count']} buckets), "
      f"{st['escalations']} escalations")
print(f"edges added {st['edges_added']}, removed {st['edges_removed']}, "
      f"nodes added {st['nodes_added']}")
print(f"engine traffic: h2d {st['h2d_bytes'] / 1e6:.1f} MB, "
      f"d2h {st['d2h_bytes'] / 1e6:.1f} MB")
