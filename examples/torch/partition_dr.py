"""Disaster recovery: a durable serving stack surviving process death
(PyTorch/CUDA port; twin of ``examples/partition_dr.py``).

The transactional session is wrapped in durable state — atomic checkpoints
at a configurable cadence plus a per-commit fsynced write-ahead log — and
the deployment is backed with standby shard replicas.  This demo drives
every recovery path:

  * committed batches are WAL-logged before submit returns (RPO 0), and
    a "fresh process" restore replays them to a BIT-IDENTICAL session
    digest (checkpoint + WAL replay, no re-partition);
  * a crash injected mid-checkpoint-write leaves a torn .tmp behind but
    never touches the latest restorable step;
  * a corrupted primary shard fails over to a checksum-audited standby
    while background recovery restores the replica count — the read
    never sees a hole;
  * a heal that rolls committed batches away truncates the durable
    timeline so restores land on the healed state.

    PYTHONPATH=src python examples/torch/partition_dr.py [--device cuda|cpu]
"""

import argparse
import os
import shutil
import tempfile

import numpy as np

from repro_torch.deploy import ReplicatedDeployment
from repro_torch.dynamic import GraphUpdate, PartitionSession, SessionConfig
from repro_torch.graph import planted_partition
from repro_torch.resilience import (
    DurableConfig,
    DurableSession,
    FaultInjector,
    ResilientConfig,
    ResilientSession,
    host_digest,
)

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

workdir = tempfile.mkdtemp(prefix="partition_dr_")
g = planted_partition(4096, 8, p_in=0.02, p_out=0.001, seed=0)
k = 8
sess = PartitionSession(g, SessionConfig(k=k, seed=0), device=args.device)
dep = ReplicatedDeployment(sess, replicas=2)
rs = ResilientSession(sess, deployment=dep,
                      cfg=ResilientConfig(audit_cadence=4))
ds = DurableSession(rs, DurableConfig(directory=workdir,
                                      checkpoint_every=4))
inj = FaultInjector(seed=42)
rng = np.random.default_rng(7)
print(f"graph: planted-partition n={g.n} m={g.m // 2} edges, k={k}")
print(f"durable dir: {workdir} (checkpoint_every=4, wal_fsync=True)\n")


def batch(size=48):
    u = rng.integers(0, sess.n, size)
    v = (u + 1 + rng.integers(0, sess.n - 1, size)) % sess.n
    return GraphUpdate.add_edges(u, v)


# ---- 1. durable commits: checkpoint rotation + WAL past the anchor ------
print("== durable commits ==")
for i in range(10):
    ds.submit(batch(), seq=i)
st = ds.stats()
print(f"10 commits -> {st['dr_checkpoints_written']} checkpoints, anchor "
      f"step {st['dr_anchor_step']}, {st['dr_wal_records']} WAL records "
      f"past it")

# ---- 2. kill-and-restart: bit-identical restore -------------------------
print("\n== kill-and-restart restore ==")
pre = host_digest(ds.session)
ds2, rep = DurableSession.restore(workdir, device=args.device)
same = all(np.array_equal(pre[key], host_digest(ds2.session)[key])
           for key in pre)
print(f"restored from step {rep.checkpoint_step}, replayed "
      f"{rep.records_replayed} WAL records in {rep.seconds:.2f}s")
print(f"digest bit-identical to pre-crash: {same}; audit ok="
      f"{ds2.rs.auditor.audit().ok}")

# ---- 3. crash mid-checkpoint: latest restorable step survives -----------
print("\n== crash mid-checkpoint-write ==")
anchor = ds.anchor_step
inj.fail_mid_checkpoint(ds)
assert ds.checkpoint() is None
torn = [d for d in os.listdir(workdir) if d.endswith(".tmp")]
print(f"checkpoint died mid-write (torn {torn[0]} left behind); "
      f"failed_checkpoints={ds.failed_checkpoints}")
_, rep = DurableSession.restore(workdir, device=args.device)
print(f"restore still lands on step {rep.checkpoint_step} "
      f"(anchor was {anchor}) + {rep.records_replayed} replayed records")
step = ds.checkpoint()
print(f"retry (hook consumed) checkpoints step {step}")

# ---- 4. shard failover: standby serves while recovery runs --------------
print("\n== replica failover ==")
f = inj.corrupt_shard(dep)
b = int(f.detail.split()[1])
shard = dep.read_block(b)               # checksum audit -> failover
print(f"corrupt primary shard {b}: read served a verified standby "
      f"(failovers={dep.failovers}, recovery_pending={sorted(dep.recovery_pending)})")
dep.run_recovery()
print(f"background recovery done: recovery_pending="
      f"{sorted(dep.recovery_pending)}, audit ok={rs.auditor.audit().ok}")

# ---- 5. heal fork: durable timeline follows the rollback ----------------
print("\n== heal() timeline fork ==")
inj.corrupt_base_csr(sess.store)
before = sess._step
ds.submit(batch(), seq=10)              # a commit on the corrupt base
rep = ds.heal()
print(f"corrupt base healed: rolled {before + 1 - sess._step} committed "
      f"step(s) away (ok={rep.ok}), WAL truncated to step {sess._step}")
_, rrep = DurableSession.restore(workdir, device=args.device)
print(f"restore lands on the healed timeline: step "
      f"{rrep.checkpoint_step} + {rrep.records_replayed} records")

st = ds.stats()
print(f"\n{st['tx_committed']} commits, {st['dr_checkpoints_written']} "
      f"checkpoints ({st['dr_failed_checkpoints']} failed), "
      f"{st['failovers']} failovers, {len(inj.log)} faults injected")
shutil.rmtree(workdir)
