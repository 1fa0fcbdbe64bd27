"""Deploying a partition: extract per-block shards, stream updates, migrate
(PyTorch/CUDA port; twin of ``examples/partition_deploy.py``).

Partition once, materialize one device-extracted BlockShard per block
(block-local CSR + 1-ring ghost halo + exchange schedule), then stream edge
updates through the dynamic session while the deployment patches only the
affected shards — the artifacts a fleet of PEs would consume.  The port
compiles nothing per shape, so the footer counts shape buckets only.

    PYTHONPATH=src python examples/torch/partition_deploy.py [--device cuda|cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.deploy import (
    ShardDeployment,
    extract_blocks_numpy,
    ghost_exchange_numpy,
    shard_comm_metrics,
)
from repro_torch.dynamic import GraphUpdate, PartitionSession, SessionConfig
from repro_torch.graph import planted_partition

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

g = planted_partition(16384, 16, p_in=0.01, p_out=0.00002, seed=4)
k = 8
print(f"graph: planted-partition n={g.n} m={g.m // 2} edges, k={k}")

t0 = time.time()
sess = PartitionSession(g, SessionConfig(k=k, seed=0), device=args.device)
print(f"partition: cut={sess.cut:.0f} imbalance={sess.imbalance:.4f} "
      f"({time.time() - t0:.1f}s)")

# ---- deploy: one device-extracted shard per block -----------------------
t0 = time.time()
dep = ShardDeployment(sess, halo=1)
print(f"deployed {k} shards in {time.time() - t0:.1f}s")
for s in dep.shards:
    print(f"  block {s.block}: {s.n_own} owned + {s.n_ghost} ghosts, "
          f"{s.m_local} arcs, {s.iface_global.size} interface nodes, "
          f"{s.send_blocks.size} neighbour blocks")
m = shard_comm_metrics(dep.shards)
print(f"comm volume: total={m['total_volume']} max/block={m['max_volume']} "
      f"boundary: total={m['total_boundary']}")

# the artifacts are bit-identical to the numpy oracle...
oracle = extract_blocks_numpy(sess.store.csr_host(), sess.labels_np(), k)
assert all(
    np.array_equal(s.host().indices, o.indices)
    and np.array_equal(s.host().ghost_slot, o.ghost_slot)
    for s, o in zip(dep.shards, oracle)
)
# ...and one schedule-driven exchange fills every ghost table exactly
recv = ghost_exchange_numpy(dep.shards, sess.labels_np())
assert all(
    np.array_equal(r, s.ghost_block_np()) for s, r in zip(dep.shards, recv)
)
print("oracle parity + ghost-exchange round-trip: OK\n")

# ---- stream updates, migrate incrementally ------------------------------
rng = np.random.default_rng(7)
print("step,cut,moved,dirty,blocks_patched,full,migrate_s")
for step in range(8):
    lab = sess.labels_np()
    gh = sess.store.csr_host()
    src = gh.arc_sources()
    bnd = np.zeros(gh.n, bool)
    np.logical_or.at(bnd, src[lab[src] != lab[gh.indices]], True)
    b = int(np.argmax(np.bincount(lab[~bnd], minlength=k)))
    ids = np.flatnonzero((lab == b) & ~bnd)
    u, v = rng.choice(ids, 200), rng.choice(ids, 200)
    keep = u != v
    res, delta = dep.update(GraphUpdate.add_edges(u[keep], v[keep]))
    print(f"{res.step},{res.cut:.0f},{delta.moved.size},{delta.dirty.size},"
          f"{delta.blocks_patched.tolist()},{delta.full_rebuild},"
          f"{delta.seconds:.2f}")

st = dep.stats()
print(f"\n{st['migrate_calls']} migrations: "
      f"{st['blocks_patched_total']} shard patches "
      f"({st['full_rebuilds']} full rebuilds), "
      f"{st['extract_calls']} extractions, "
      f"{st['deploy_bucket_count']} buckets")
print(f"deploy traffic: h2d {st['deploy_h2d_bytes'] / 1e6:.1f} MB, "
      f"d2h {st['deploy_d2h_bytes'] / 1e6:.1f} MB")
