"""Transactional serving (resilience, layer 4) — the torch twin of
``repro.resilience.transact``.

:class:`ResilientSession` wraps a :class:`~repro_torch.dynamic.session.
PartitionSession` (and optionally a :class:`~repro_torch.deploy.migrate.
ShardDeployment`) in the commit protocol a production deployment
demands:

    validate -> snapshot -> apply -> audit -> commit-or-rollback

* **validate** — structural validation (:meth:`GraphUpdate.validate`)
  rejects malformed batches before any state moves; rejection is atomic
  by construction (the session validates again before its step counter).
* **snapshot** — every transaction opens with an O(delta) snapshot
  (:class:`~repro_torch.resilience.snapshot.SnapshotManager`), so abort is a
  reference rebind, not a recovery procedure.
* **apply + audit** — the batch runs through the session's repair path;
  at the configured cadence (and always after a retry) the invariant
  auditor checks the committed-to-be state.
* **commit-or-rollback** — an audit failure or a raised error rolls the
  session back bit-identically and retries up to ``max_retries`` times
  (state-corruption faults are healed by the rollback itself, so a clean
  retry usually commits); a batch that keeps failing is **quarantined**
  with a structured error and the session keeps serving the last
  committed state.
* **watchdog / degraded mode** — ``max_consecutive_escalations`` bounds
  V-cycle retries; past the bound (or after an escalation crash) the
  session enters explicit degraded mode: quality-guard escalations are
  suppressed, steps serve repaired-but-stale labels flagged ``stale`` in
  the trajectory and ``degraded`` in ``stats()``.  ``recover()`` exits.
* **sequence numbers** — ``submit(upd, seq=...)`` detects duplicates
  (dropped), reorders (parked until the gap fills), and losses
  (surfaced after ``reorder_window`` newer batches) on a mangled stream.

Shard serving rides the session's transactions: migration runs inside
the transaction, BEFORE the audit, so shard health is checked against
the batch's own base; a rollback re-syncs the shard set with one more
incremental migrate.  A failed migration (or a lost/corrupt shard found
by audit) falls back to serving the stale-but-consistent set until
:meth:`ShardDeployment.recover_block` or the next successful migrate
catches up.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..dynamic.session import PartitionSession, UpdateResult, _reg_counter
from ..dynamic.store import GraphUpdate, UpdateValidationError
from .audit import AuditReport, InvariantAuditor
from .snapshot import SnapshotManager

__all__ = ["QuarantinedBatch", "ResilientConfig", "ResilientSession", "TxResult"]


@dataclass
class ResilientConfig:
    audit_cadence: int = 8          # full invariant pass every N commits
    max_retries: int = 2            # rollback+retry budget per batch
    snapshot_keep: int = 8          # retained rollback points
    max_consecutive_escalations: int = 3  # watchdog bound before degraded
    reorder_window: int = 4         # parked batches tolerated before a gap
                                    # is declared lost
    audit_after_retry: bool = True  # always audit a retried commit


@dataclass
class QuarantinedBatch:
    """A batch the session refused (with why) — the poison queue."""

    seq: int
    upd: GraphUpdate
    reason: str
    detail: str
    attempts: int = 1


@dataclass
class TxResult:
    """Outcome of one ``submit``."""

    seq: int
    committed: bool
    result: Optional[UpdateResult] = None
    audit: Optional[AuditReport] = None
    retries: int = 0
    rolled_back: bool = False
    quarantined: bool = False
    duplicate: bool = False
    parked: bool = False            # out-of-order: held for its turn
    reason: str = ""
    migration_failed: bool = False
    seconds: float = 0.0
    followups: List["TxResult"] = field(default_factory=list)


class ResilientSession:
    """Fault-tolerant wrapper: transactional updates over a live session."""

    # transactional counters ride in the session stack's registry so the
    # whole stack resets/snapshots/exports through one path
    committed = _reg_counter("tx_committed")
    rollbacks = _reg_counter("tx_rollbacks")
    retries = _reg_counter("tx_retries")
    duplicates_dropped = _reg_counter("tx_duplicates_dropped")
    parked_batches = _reg_counter("tx_parked")
    lost_batches = _reg_counter("tx_lost")

    def __init__(self, session: PartitionSession, deployment=None,
                 cfg: Optional[ResilientConfig] = None):
        self.cfg = cfg or ResilientConfig()
        self.session = session
        self.metrics = session.metrics
        self.deployment = deployment
        self.snapshots = SnapshotManager(session, keep=self.cfg.snapshot_keep)
        self.auditor = InvariantAuditor(
            session, deployment=deployment, cadence=self.cfg.audit_cadence
        )
        self.quarantine: List[QuarantinedBatch] = []
        self.results: List[TxResult] = []
        self.committed = 0
        self.rollbacks = 0
        self.retries = 0
        self.duplicates_dropped = 0
        self.parked_batches = 0
        self.lost_batches = 0
        self.degraded = False
        self._consecutive_escalations = 0
        self._expected_seq = 0
        self._parked: Dict[int, GraphUpdate] = {}
        # durable-logging attach point: called as on_commit(tx, upd, sup)
        # at the instant a transaction commits, BEFORE the watchdog can
        # flip degraded mode — ``sup`` is the suppress_escalation state the
        # committed apply actually ran under, which is what a WAL replay
        # must reproduce to stay bit-identical
        self.on_commit: Optional[
            Callable[[TxResult, GraphUpdate, bool], None]
        ] = None

    # ------------------------------------------------------------- internals

    def _quarantine(self, seq: int, upd: GraphUpdate, reason: str,
                    detail: str, attempts: int = 1) -> None:
        self.quarantine.append(QuarantinedBatch(
            seq=seq, upd=upd, reason=reason, detail=detail, attempts=attempts,
        ))

    def _enter_degraded(self) -> None:
        if not self.degraded:
            self.degraded = True
            self.session.suppress_escalation = True

    def _watchdog(self, res: UpdateResult) -> None:
        """Bound consecutive V-cycle escalations; past the bound the
        session stops escalating and serves (flagged) stale quality."""
        if res.escalated:
            self._consecutive_escalations += 1
            if (self._consecutive_escalations
                    >= self.cfg.max_consecutive_escalations):
                self._enter_degraded()
        elif not res.noop:
            self._consecutive_escalations = 0

    def _rollback(self, version: int, tx: TxResult,
                  upd: Optional[GraphUpdate] = None) -> None:
        self.snapshots.rollback(version)
        self.rollbacks += 1
        tx.rolled_back = True
        if self.deployment is not None:
            # re-sync the shard set to the restored state (migration ran
            # before the audit so shard health could be checked against the
            # new base); the undone batch's endpoints mark which blocks'
            # halo content has to be re-extracted
            self.deployment.resync(upd)

    def _transact(self, seq: int, upd: GraphUpdate) -> TxResult:
        t0 = time.time()
        tx = TxResult(seq=seq, committed=False)
        # ---- validate (before ANY state moves) ----
        try:
            upd.validate(self.session.store.n)
        except UpdateValidationError as e:
            self._quarantine(seq, upd, e.reason, e.detail)
            tx.quarantined = True
            tx.reason = e.reason
            tx.seconds = time.time() - t0
            return tx
        # ---- snapshot -> apply (+migrate) -> audit -> commit-or-rollback
        version = self.snapshots.take()
        attempts = 0
        while True:
            sup = self.session.suppress_escalation
            try:
                res = self.session.update(upd)
            except Exception as e:  # apply crashed (e.g. escalation failure)
                self._rollback(version, tx, upd)
                # an escalation crash means the quality guard cannot be
                # satisfied right now: degrade rather than retry forever
                self._enter_degraded()
                if attempts >= self.cfg.max_retries:
                    self._quarantine(
                        seq, upd, "apply_failed", repr(e), attempts + 1
                    )
                    tx.quarantined = True
                    tx.reason = "apply_failed"
                    tx.retries = attempts
                    tx.seconds = time.time() - t0
                    return tx
                attempts += 1
                self.retries += 1
                continue
            # migration precedes the audit so shard health is checked
            # against the batch's base; a failed migration leaves the set
            # stale (the auditor skips content checks on a stale set)
            if self.deployment is not None:
                delta = self.deployment.migrate(upd, res)
                tx.migration_failed = delta.failed
            if attempts > 0 and self.cfg.audit_after_retry:
                rep = self.auditor.audit()
            else:
                rep = self.auditor.maybe_audit(self.committed + 1)
            if rep is not None and not rep.ok:
                self._rollback(version, tx, upd)
                if attempts >= self.cfg.max_retries:
                    self._quarantine(
                        seq, upd, "audit_failed",
                        ";".join(rep.failures), attempts + 1,
                    )
                    tx.quarantined = True
                    tx.reason = "audit_failed"
                    tx.audit = rep
                    tx.retries = attempts
                    tx.seconds = time.time() - t0
                    return tx
                attempts += 1
                self.retries += 1
                continue
            break
        # ---- committed ----
        self.committed += 1
        tx.committed = True
        tx.result = res
        tx.audit = rep
        tx.retries = attempts
        if self.on_commit is not None:
            # before the watchdog: ``sup`` must be the state the committed
            # apply ran under, not whatever the watchdog flips it to next
            self.on_commit(tx, upd, sup)
        self._watchdog(res)
        tx.seconds = time.time() - t0
        return tx

    # ---------------------------------------------------------------- public

    def submit(self, upd: GraphUpdate, seq: Optional[int] = None) -> TxResult:
        """Transactionally absorb one batch.

        With ``seq`` (a sender-assigned sequence number), duplicates are
        dropped, early arrivals are parked until the gap fills, and a gap
        older than ``reorder_window`` parked batches is declared lost (the
        stream advances past it).  Without ``seq``, batches apply in
        arrival order."""
        if seq is None:
            tx = self._transact(self._expected_seq, upd)
            self._expected_seq += 1
            self.results.append(tx)
            return tx
        seq = int(seq)
        if seq < self._expected_seq or seq in self._parked:
            self.duplicates_dropped += 1
            tx = TxResult(seq=seq, committed=False, duplicate=True,
                          reason="duplicate")
            self.results.append(tx)
            return tx
        if seq > self._expected_seq:
            self._parked[seq] = upd
            self.parked_batches += 1
            tx = TxResult(seq=seq, committed=False, parked=True,
                          reason="out_of_order")
            if len(self._parked) > self.cfg.reorder_window:
                # the gap is declared lost: advance to the oldest parked
                # batch and drain everything that became in-order
                lost_upto = min(self._parked)
                self.lost_batches += lost_upto - self._expected_seq
                self._expected_seq = lost_upto
                tx.followups.extend(self._drain())
            self.results.append(tx)
            return tx
        tx = self._transact(seq, upd)
        self._expected_seq = seq + 1
        tx.followups.extend(self._drain())
        self.results.append(tx)
        return tx

    def _drain(self) -> List[TxResult]:
        """Apply parked batches that are now in order."""
        out: List[TxResult] = []
        while self._expected_seq in self._parked:
            upd = self._parked.pop(self._expected_seq)
            sub = self._transact(self._expected_seq, upd)
            self._expected_seq += 1
            out.append(sub)
        return out

    def heal(self) -> AuditReport:
        """Audit the serving state and, if corrupted, roll back through the
        retained versions (newest first) until a version passes — the
        recovery path for corruption that arrived OUTSIDE a transaction
        (a flipped device page, a corrupted served artifact).  Returns the
        final report; ``ok=False`` means no retained version was clean.

        Healing in degraded mode exits it — but ONLY when the final audit
        passes: a clean bill of health supersedes the watchdog's stale
        verdict, while an unhealed session must keep escalations
        suppressed (they were the failure mode that degraded it).  When a
        deployment rode through heal in a stale state (a failed migration
        preceded the corruption), the shard set is caught up before the
        final audit so shard health is actually re-checked, not skipped."""
        rep = self.auditor.audit()
        for v in sorted(self.snapshots.versions, reverse=True):
            if rep.ok:
                break
            self.snapshots.rollback(v)
            self.rollbacks += 1
            if self.deployment is not None:
                # the set of undone batches is unknown here, so the shard
                # set follows with a full re-extraction (heal is the rare
                # path; correctness beats incrementality)
                self.deployment.resync(full=True)
            rep = self.auditor.audit()
        if rep.ok and self.deployment is not None and self.deployment.stale:
            # a stale set passed only because the auditor skips stale
            # content checks — resync and prove shard health for real
            self.deployment.migrate(None)
            rep = self.auditor.audit()
        if rep.ok and self.degraded:
            self.degraded = False
            self.session.suppress_escalation = False
            self._consecutive_escalations = 0
        return rep

    def recover(self) -> Optional[AuditReport]:
        """Exit degraded mode: re-enable escalation, run one full audit,
        and (when deployed) catch the shard set up if it went stale."""
        self.degraded = False
        self.session.suppress_escalation = False
        self._consecutive_escalations = 0
        if self.deployment is not None and self.deployment.stale:
            self.deployment.migrate(None)
        return self.auditor.audit()

    def stats(self) -> dict:
        """Serving dashboard row: session/deployment counters + the
        transactional layer's."""
        d = (self.deployment.stats() if self.deployment is not None
             else self.session.stats())
        d.update(
            tx_committed=self.committed,
            tx_rollbacks=self.rollbacks,
            tx_retries=self.retries,
            tx_quarantined=len(self.quarantine),
            tx_duplicates_dropped=self.duplicates_dropped,
            tx_parked=self.parked_batches,
            tx_lost=self.lost_batches,
            degraded=self.degraded,
            snapshots_taken=self.snapshots.takes,
            snapshot_versions=len(self.snapshots.versions),
        )
        d.update(self.auditor.stats())
        return d
