"""Standby shard replicas: serve-through-recovery (deployment, layer 4) —
the torch twin of ``repro.deploy.replicate``.

The :class:`~repro_torch.deploy.migrate.ShardDeployment` can *re-extract* a
lost or corrupted :class:`BlockShard` (``recover_block``), but between the
auditor flagging the fault and the re-extraction finishing, reads of that
block would see a hole.  :class:`ReplicatedDeployment` closes the gap with
an R-way replica set per block:

* every time a block's shard is (re)extracted consistently (initial
  deployment, incremental migration, recovery), ``R - 1`` **standby
  copies** are refreshed alongside the primary, and the shard's owned-row
  wrap-sum checksum (the same :func:`~repro_torch.resilience.audit` hash the
  reassembly audit uses) is recorded as the block's expected content;
* :meth:`read_block` hands out the primary after a checksum verification;
  a lost (``None``) or corrupt (checksum-mismatched) primary **fails
  over**: the first standby that passes the same audit is promoted, the
  global exchange schedule is re-assembled (a promoted standby may carry a
  stale slot ordering — schedule state is globally coupled, content is
  not), and the block is queued for background re-extraction
  (:meth:`run_recovery`) to restore the replica count.  Reads never see a
  hole: if every standby is also corrupt, the fallback is an immediate
  synchronous ``recover_block``.

Replica copies are dataclass-level: no code writes into a shard's tensors
(fault injection corrupts by *rebinding* a field of the primary object to
a modified clone), so a standby holding its own field slots stays pristine
by construction.  On a single device the copies therefore cost O(1)
handles; on a multi-host serving tier each standby is a physical copy and
memory scales as ``R x shard bytes`` — the ``replicas`` knob trades that
memory for failover availability.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Set

from ..dynamic.session import PartitionSession, UpdateResult, _reg_counter
from ..dynamic.store import GraphUpdate
from ..obs import span as _obs_span
from ..resilience.audit import shard_checksum, shard_key
from .extract import BlockShard, assemble_schedule
from .migrate import MigrationDelta, ShardDeployment

__all__ = ["ReplicaMiss", "ReplicatedDeployment"]


class ReplicaMiss(RuntimeError):
    """No consistent replica existed for a block (surfaced in stats; the
    read path falls back to synchronous re-extraction instead of raising
    this to callers)."""


class ReplicatedDeployment(ShardDeployment):
    """R-way replicated shard set tracking a :class:`PartitionSession`.

    ``replicas`` counts total copies per block (primary + standbys);
    ``replicas=1`` degrades to plain :class:`ShardDeployment` behavior
    with checksum-verified reads.
    """

    failovers = _reg_counter("failovers")
    failover_misses = _reg_counter("failover_misses")
    replica_refreshes = _reg_counter("replica_refreshes")
    reads = _reg_counter("replica_reads")

    def __init__(self, session: PartitionSession, halo: int = 1,
                 escalate_fraction: float = 0.5, replicas: int = 2):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self.replicas = int(replicas)
        # initialized before super(): super().__init__ extracts the first
        # shard set and our migrate() override fires during later calls
        # (metrics too — the registry-backed counters write through it)
        self.metrics = session.metrics
        self._standbys: List[List[BlockShard]] = []
        self._expected_chk: List[int] = []
        self.recovery_pending: Set[int] = set()
        self.failovers = 0
        self.failover_misses = 0
        self.replica_refreshes = 0
        self.reads = 0
        self.last_failover_seconds = 0.0
        self._replicas_ready = False
        super().__init__(session, halo=halo,
                         escalate_fraction=escalate_fraction)
        self._standbys = [[] for _ in range(self.k)]
        self._expected_chk = [0] * self.k
        self._replicas_ready = True
        self._refresh_replicas(range(self.k))

    # ------------------------------------------------------------- internals

    def _chk(self, s: BlockShard) -> int:
        """Owned-row wrap-sum checksum of one shard (the reassembly-audit
        hash, so expected values are comparable with the base audit)."""
        chk = shard_checksum(s)
        st = self.session.engine.stats
        st.audit_calls += 1
        st.note_audit_key(shard_key(s))
        st.d2h_bytes += 4
        return int(chk)

    def _refresh_replicas(self, blocks) -> None:
        """Record the expected checksum and rebuild the standby copies of
        freshly-extracted blocks (the shard is consistent by construction
        at every call site: post-migrate, post-recover)."""
        if not self._replicas_ready:
            return
        for b in blocks:
            b = int(b)
            s = self.shards[b]
            self._expected_chk[b] = self._chk(s)
            self._standbys[b] = [
                dataclasses.replace(s) for _ in range(self.replicas - 1)
            ]
            self.recovery_pending.discard(b)
            self.replica_refreshes += 1

    def verify_shard(self, b: int, s: Optional[BlockShard]) -> bool:
        """Content audit of one copy: present and checksum-identical to the
        block's last consistent extraction."""
        return s is not None and self._chk(s) == self._expected_chk[b]

    # --------------------------------------------------------------- serving

    def read_block(self, b: int) -> BlockShard:
        """The serving read path: a checksum-audited shard for block ``b``.

        A healthy primary is returned directly.  A lost/corrupt primary
        fails over to the first standby that passes the same audit — the
        standby is promoted (removed from the standby set, installed as
        primary, schedule re-assembled) and the block is queued for
        :meth:`run_recovery`.  If no copy survives, falls back to an
        immediate synchronous re-extraction.  Reads never see a hole."""
        if not 0 <= b < self.k:
            raise ValueError(f"block id {b} outside [0, {self.k})")
        self.reads += 1
        if self.verify_shard(b, self.shards[b]):
            return self.shards[b]
        return self.failover(b)

    def failover(self, b: int) -> BlockShard:
        """Promote an audited standby over a lost/corrupt primary."""
        t0 = time.time()
        with _obs_span("deploy.failover", cat="deploy", block=int(b)) as sp:
            while self._standbys[b]:
                cand = self._standbys[b].pop(0)
                if self.verify_shard(b, cand):
                    self.shards[b] = cand
                    # a standby captured before later migrations carries a
                    # stale slot ordering; content is pristine (checksummed),
                    # the schedule is host-cheap to re-couple globally
                    assemble_schedule(self.shards)
                    self._refresh_member_rows([b], self.session.n)
                    self.recovery_pending.add(b)
                    self.failovers += 1
                    self.last_failover_seconds = time.time() - t0
                    self.metrics.observe(
                        "failover_seconds", self.last_failover_seconds
                    )
                    return self.shards[b]
            # every copy gone: recover synchronously (read still succeeds)
            sp.set(miss=True)
            self.failover_misses += 1
            shard = self.recover_block(b)
            self.last_failover_seconds = time.time() - t0
            self.metrics.observe(
                "failover_seconds", self.last_failover_seconds
            )
            return shard

    def run_recovery(self) -> List[int]:
        """Drain the background-recovery queue: re-extract every block that
        failed over (restoring its replica count) — the work a real
        deployment would run off the serving path while standbys serve."""
        done = []
        for b in sorted(self.recovery_pending):
            self.recover_block(b)
            done.append(b)
        return done

    # ------------------------------------------------- ShardDeployment hooks

    def migrate(self, upd: Optional[GraphUpdate],
                res: Optional[UpdateResult] = None) -> MigrationDelta:
        delta = super().migrate(upd, res)
        if not delta.failed and delta.blocks_patched.size:
            with _obs_span("deploy.replicas", cat="deploy",
                           blocks=int(delta.blocks_patched.size)):
                self._refresh_replicas(delta.blocks_patched)
        return delta

    def recover_block(self, b: int) -> BlockShard:
        shard = super().recover_block(b)
        self._refresh_replicas([b])
        return shard

    def stats(self) -> dict:
        d = super().stats()
        d.update(
            replicas=self.replicas,
            failovers=self.failovers,
            failover_misses=self.failover_misses,
            replica_refreshes=self.replica_refreshes,
            replica_reads=self.reads,
            recovery_pending=len(self.recovery_pending),
            last_failover_seconds=self.last_failover_seconds,
        )
        return d
