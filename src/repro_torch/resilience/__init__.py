"""Fault-tolerance layer around the dynamic session and deploy subsystems
of the port (the torch twin of ``repro.resilience``).

The serving stack (the :class:`~repro_torch.dynamic.session.PartitionSession`,
the :class:`~repro_torch.deploy.migrate.ShardDeployment`) keeps partition
state resident on device across an unbounded update stream — which means a
single malformed batch, a repeatedly-failing repair, or a corrupted shard
would poison that state forever.  This package makes the partition a
transactional, auditable artifact:

* :mod:`~repro_torch.resilience.snapshot` — versioned O(delta) snapshots of the
  full session state with bit-identical rollback;
* :mod:`~repro_torch.resilience.audit` — device-side invariant auditor (CSR
  well-formedness, partition health, shard health) at configurable cadence;
* :mod:`~repro_torch.resilience.faults` — seeded deterministic fault injection,
  so every recovery path is exercised in tests rather than claimed;
* :mod:`~repro_torch.resilience.transact` — the transactional serving loop:
  validate -> apply -> audit -> commit-or-rollback, with quarantine,
  bounded retry, an escalation watchdog, and explicit degraded mode;
* :mod:`~repro_torch.resilience.durable` — disaster recovery: atomic durable
  checkpoints + a per-commit fsynced write-ahead log, with fresh-process
  ``restore()`` replaying the WAL to a bit-identical session;
* :mod:`~repro_torch.resilience.fuzz` — the end-to-end fault fuzzer: seeded
  episodes interleaving every fault class against mangled concurrent
  update streams, asserting the stack heals or restores to the oracle.
"""

from .audit import AuditReport, InvariantAuditor
from .faults import FaultInjector, InjectedFault
from .snapshot import SessionSnapshot, SnapshotManager, host_digest
from .transact import (
    QuarantinedBatch,
    ResilientConfig,
    ResilientSession,
    TxResult,
)
from .durable import (
    DurableConfig,
    DurableSession,
    RestoreReport,
    WalRecord,
    read_wal,
)
from .fuzz import EpisodeResult, FuzzConfig, FuzzReport, run_fuzz

__all__ = [
    "AuditReport",
    "DurableConfig",
    "DurableSession",
    "EpisodeResult",
    "FaultInjector",
    "FuzzConfig",
    "FuzzReport",
    "InjectedFault",
    "InvariantAuditor",
    "QuarantinedBatch",
    "ResilientConfig",
    "ResilientSession",
    "RestoreReport",
    "SessionSnapshot",
    "SnapshotManager",
    "TxResult",
    "WalRecord",
    "host_digest",
    "read_wal",
    "run_fuzz",
]
