"""Fault-tolerant serving: a ResilientSession surviving an unreliable world
(PyTorch/CUDA port; twin of ``examples/partition_resilient.py``).

The resilience subsystem wraps the dynamic serving loop in a transaction
(validate -> snapshot -> apply -> audit -> commit-or-rollback) and backs it
with seeded fault injection, so every recovery path shown here is driven by
a real injected fault:

  * a malformed batch (out-of-range endpoint) is rejected atomically and
    quarantined with a structured reason;
  * a mangled stream (drops / duplicates / reorders) is straightened out by
    sequence numbers;
  * label corruption landing between batches is caught by the invariant
    auditor (stored-vs-recomputed cut) and healed by rolling back to the
    newest clean snapshot;
  * a corrupted + a lost deployed shard are caught by the reassembly
    checksum and re-extracted in place;
  * an escalation crash flips the session into explicit degraded mode
    (stale-but-served labels, flagged) until recover().

    PYTHONPATH=src python examples/torch/partition_resilient.py [--device cuda|cpu]
"""

import argparse
import numpy as np

from repro_torch.deploy import ShardDeployment
from repro_torch.dynamic import GraphUpdate, PartitionSession, SessionConfig
from repro_torch.graph import planted_partition
from repro_torch.resilience import FaultInjector, ResilientConfig, ResilientSession

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

g = planted_partition(4096, 8, p_in=0.02, p_out=0.001, seed=0)
k = 8
sess = PartitionSession(g, SessionConfig(k=k, seed=0), device=args.device)
dep = ShardDeployment(sess, halo=1)
rs = ResilientSession(sess, deployment=dep,
                      cfg=ResilientConfig(audit_cadence=4, reorder_window=2))
inj = FaultInjector(seed=42)
print(f"graph: planted-partition n={g.n} m={g.m // 2} edges, k={k}")
print(f"initial: cut={sess.cut:.0f} imbalance={sess.imbalance:.4f}, "
      f"{k} shards deployed\n")

rng = np.random.default_rng(7)


def batch(size=48):
    u = rng.integers(0, sess.n, size)
    v = (u + 1 + rng.integers(0, sess.n - 1, size)) % sess.n
    return GraphUpdate.add_edges(u, v)


# ---- 1. a malformed batch: rejected before any state moves --------------
print("== malformed batch ==")
bad = GraphUpdate(add_u=np.array([0]), add_v=np.array([10 ** 9]),
                  add_w=np.array([1]))
tx = rs.submit(bad)
q = rs.quarantine[-1]
print(f"quarantined: reason={q.reason!r} detail={q.detail!r} "
      f"(session untouched, still at step {sess._step})\n")

# ---- 2. a mangled stream: sequence numbers put it back together ---------
print("== mangled stream (drop/dup/reorder) ==")
stream = inj.mangle_stream([batch() for _ in range(6)],
                           drop=0.2, dup=0.2, swap=0.3)
for seq, b in stream:
    tx = rs.submit(b, seq=seq)
    state = ("committed" if tx.committed else
             "duplicate" if tx.duplicate else
             "parked" if tx.parked else tx.reason)
    extra = f" +{len(tx.followups)} drained" if tx.followups else ""
    print(f"  seq {seq}: {state}{extra}")
print(f"committed={rs.committed} duplicates_dropped={rs.duplicates_dropped} "
      f"parked={rs.parked_batches} lost={rs.lost_batches}\n")

# ---- 3. label corruption between batches: audit detects, heal rolls back
print("== label corruption (a flipped device page) ==")
f = inj.corrupt_labels(sess, count=4)
rep = rs.auditor.audit()
print(f"injected: {f.detail}; audit -> ok={rep.ok} failures={rep.failures}")
rep = rs.heal()
print(f"heal(): rolled back to a clean version -> ok={rep.ok} "
      f"(cut={sess.cut:.0f})\n")

# ---- 4. shard faults: checksum catches them, re-extraction recovers -----
print("== corrupted + lost shards ==")
fb = inj.corrupt_shard(dep)
b_corrupt = int(fb.detail.split()[1])
rep = rs.auditor.audit()
print(f"corrupt shard {b_corrupt}: audit -> ok={rep.ok} "
      f"failures={rep.failures}")
dep.recover_block(b_corrupt)
fb = inj.lose_shard(dep)
b_lost = int(fb.detail.split()[1])
rep = rs.auditor.audit()
print(f"lost shard {b_lost}: audit -> ok={rep.ok} failures={rep.failures}")
dep.recover_block(b_lost)
print(f"recovered blocks {b_corrupt} and {b_lost}: "
      f"audit -> ok={rs.auditor.audit().ok}\n")

# ---- 5. escalation crash: degraded mode, then recover -------------------
print("== escalation crash ==")
sess.cfg.escalate_cut_ratio = 1.0001          # hair-trigger quality guard
inj.fail_next_escalation(sess)
tx = rs.submit(batch(200))
print(f"committed={tx.committed} retries={tx.retries} "
      f"rolled_back={tx.rolled_back} degraded={rs.degraded} "
      f"stale={tx.result.stale}")
sess.cfg.escalate_cut_ratio = 1.25
rep = rs.recover()
print(f"recover(): degraded={rs.degraded} audit ok={rep.ok}\n")

st = rs.stats()
print(f"{st['tx_committed']} commits, {st['tx_rollbacks']} rollbacks, "
      f"{st['tx_retries']} retries, {st['tx_quarantined']} quarantined")
print(f"{st['audits']} audits ({st['failed_audits']} failed, "
      f"{st['audit_bucket_count']} buckets)")
print(f"{st['snapshots_taken']} snapshots taken, "
      f"{st['shard_recoveries']} shard recoveries, "
      f"{len(inj.log)} faults injected")
