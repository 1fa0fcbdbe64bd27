"""Durable disaster recovery: checkpoint + write-ahead log (resilience,
layer 5) — the torch twin of ``repro.resilience.durable``, writing
byte-identical WAL records and the same checkpoint arrays, so a directory
written by either package restores in the other.

The :class:`~repro_torch.resilience.transact.ResilientSession` survives
in-process faults through reference-capture snapshots — but those versions
die with the host.  This module makes the serving state durable:

* **Checkpoints** — the full session state (labels, base CSR, node
  weights, pending overlay, quality-guard references, step counter,
  trajectory, transactional bookkeeping, deployment shape) is serialized
  through the atomic manifest-driven :mod:`repro_torch.ckpt` layer (tmp dir +
  fsync + rename + parent-dir fsync).  A crash mid-checkpoint can never
  corrupt the latest restorable step: recovery reads the newest COMPLETE
  manifest and ignores torn ``.tmp`` writes.
* **Write-ahead log** — every *committed* transaction appends its
  :class:`~repro_torch.dynamic.store.GraphUpdate` (in the length + crc32 framed
  wire format) to ``wal_<step>.log``, fsynced before ``submit`` returns.
  Each record also carries the session step after the commit, the
  transaction's sequence number, and the ``suppress_escalation`` state the
  committed apply ran under — exactly what a deterministic replay needs.
* **Restore** — on a fresh process, :meth:`DurableSession.restore` loads
  the newest complete checkpoint, rebuilds the session WITHOUT the initial
  V-cycle (:meth:`~repro_torch.dynamic.session.PartitionSession.from_restored`),
  replays the WAL through the same ``update`` path, re-extracts the shard
  deployment from the restored labels, and returns a serving
  :class:`DurableSession` whose :func:`~repro_torch.resilience.snapshot.
  host_digest` is **bit-identical** to the pre-crash session: every repair
  seed derives from the step counter, and the WAL's suppress flags replay
  degraded-mode decisions faithfully.  The restored stack runs on the
  device the caller names (CUDA by default).

RPO/RTO: at the default ``wal_group_commit_n = 1`` committed batches are
never lost (RPO 0 — the WAL append is fsynced inside the commit path);
group commit (``wal_group_commit_n > 1``) coalesces fsyncs over a bounded
commit window, trading RPO <= ``wal_group_commit_n - 1`` batches for the
per-commit fsync latency.  Recovery time is one checkpoint load plus
the replay of at most ``checkpoint_every`` batches (RTO bounded by the
cadence knob), instead of a full re-partition.  A torn WAL tail (the
record being written when the host died) is detected by the crc framing,
dropped, and surfaced in the restore report — it was never acknowledged as
committed.  ``heal()`` timeline forks (rollback past committed batches)
truncate the WAL and drop newer checkpoints so durable state always
describes the surviving timeline.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import struct
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .. import ckpt
from ..dynamic.session import PartitionSession, SessionConfig, UpdateResult
from ..dynamic.store import GraphUpdate, UpdateValidationError
from ..graph.csr import GraphNP
from ..obs import MetricsRegistry, span as _obs_span
from .transact import ResilientConfig, ResilientSession, TxResult

__all__ = [
    "DurableConfig",
    "DurableSession",
    "RestoreReport",
    "WalRecord",
    "read_wal",
    "wal_path",
]

# WAL record framing: a fixed prefix in front of the GraphUpdate wire
# record (which is itself length + crc framed, so the reader can both skip
# and verify it):  magic | step-after-commit u64 | tx seq u64 | flags u8
# (bit 0: suppress_escalation during the committed apply) | 3 pad bytes.
_WAL_MAGIC = b"WALR"
_WAL_PREFIX = struct.Struct("<4sQQB3x")
_FLAG_SUPPRESS = 1


@dataclass(frozen=True)
class WalRecord:
    """One committed transaction as durably logged."""

    step: int                   # session step AFTER the commit
    seq: int                    # transaction sequence number
    suppress: bool              # escalation suppressed during the apply
    upd: GraphUpdate


@dataclass
class RestoreReport:
    """What a restore did — the operator-facing recovery record."""

    checkpoint_step: int
    records_replayed: int
    wal_tail_error: Optional[str] = None   # torn/corrupt tail reason (if any)
    wal_bytes_dropped: int = 0
    seconds: float = 0.0


def wal_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"wal_{step:08d}.log")


def _pack_record(rec: WalRecord) -> bytes:
    flags = _FLAG_SUPPRESS if rec.suppress else 0
    return _WAL_PREFIX.pack(_WAL_MAGIC, rec.step, rec.seq, flags) \
        + rec.upd.to_bytes()


def read_wal(path: str) -> Tuple[List[WalRecord], int, Optional[str]]:
    """Parse a WAL file up to the first torn/corrupt record.

    Returns ``(records, valid_bytes, tail_error)``: everything before the
    first framing violation parses into records; ``valid_bytes`` is the
    clean prefix length (restore truncates the file there before
    appending), and ``tail_error`` names why parsing stopped (None at a
    clean EOF).  A record that fails its crc is NEVER partially applied —
    the wire format rejects it atomically."""
    records: List[WalRecord] = []
    if not os.path.exists(path):
        return records, 0, None
    with open(path, "rb") as f:
        data = f.read()
    off, tail_error = 0, None
    while off < len(data):
        if len(data) - off < _WAL_PREFIX.size:
            tail_error = "wal_truncated"
            break
        magic, step, seq, flags = _WAL_PREFIX.unpack_from(data, off)
        if magic != _WAL_MAGIC:
            tail_error = "wal_bad_magic"
            break
        body = data[off + _WAL_PREFIX.size:]
        try:
            size = GraphUpdate.wire_size(body)
            upd = GraphUpdate.from_bytes(body[:size])
        except UpdateValidationError as e:
            tail_error = e.reason
            break
        records.append(WalRecord(
            step=int(step), seq=int(seq),
            suppress=bool(flags & _FLAG_SUPPRESS), upd=upd,
        ))
        off += _WAL_PREFIX.size + size
    return records, off, tail_error


class WriteAheadLog:
    """Append-only fsynced log of committed update batches.

    **Group commit**: with ``group_n > 1``, appends buffer in
    memory and the physical write + flush + fsync happens once per batch —
    when ``group_n`` records have accumulated, or when the oldest buffered
    record has waited ``group_timeout`` seconds (checked at append time),
    or on :meth:`flush`/:meth:`close`.  One fsync then covers the whole
    window, amortizing the dominant cost of durable logging.  The trade is
    explicit:
    a crash loses at most the ``group_n - 1`` records still buffered
    (RPO <= group_n - 1 commits instead of 0).  Buffered records are
    written in append order in a single contiguous write, so the on-disk
    prefix property read_wal() depends on is preserved — a torn batch
    tail drops only the *newest* records, never reorders them.

    ``group_n = 1`` (the default) is the historical fsync-per-append
    behavior, bit-for-bit.
    """

    def __init__(self, path: str, fsync: bool = True, fresh: bool = False,
                 group_n: int = 1, group_timeout: float = 0.0,
                 registry: Optional[MetricsRegistry] = None):
        self.path = path
        self.fsync = fsync
        self.group_n = max(int(group_n), 1)
        self.group_timeout = float(group_timeout)
        # fsync-latency histogram sink; the per-WAL counters below stay
        # plain ints (a WAL rotates per checkpoint — merging rotations
        # into one registry counter would misreport the current log)
        self.metrics = registry
        self._f = open(path, "wb" if fresh else "ab")
        self._buf: List[bytes] = []
        self._buf_t0 = 0.0
        self.records_appended = 0
        self.flushes = 0            # physical write+fsync batches

    @property
    def buffered(self) -> int:
        """Records appended but not yet durable (lost if the host dies)."""
        return len(self._buf)

    def append(self, rec: WalRecord) -> None:
        if not self._buf:
            self._buf_t0 = time.monotonic()
        self._buf.append(_pack_record(rec))
        self.records_appended += 1
        if len(self._buf) >= self.group_n or (
            self.group_timeout > 0.0
            and time.monotonic() - self._buf_t0 >= self.group_timeout
        ):
            self.flush()

    def flush(self) -> None:
        """Make every buffered record durable (one write, one fsync)."""
        if not self._buf:
            return
        payload = b"".join(self._buf)
        # records are handed to the OS exactly once: a failed fsync leaves
        # their durability unknown (the caller sees the exception), but a
        # retry must never re-write them — duplicate records would corrupt
        # the replay stream, which is worse than an honest unknown tail
        n_rec = len(self._buf)
        self._buf = []
        t0 = time.perf_counter()
        with _obs_span("wal.fsync", cat="resilience",
                       records=n_rec, bytes=len(payload)):
            self._f.write(payload)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
        if self.metrics is not None:
            self.metrics.observe(
                "wal_fsync_seconds", time.perf_counter() - t0
            )
        self.flushes += 1

    def close(self) -> None:
        if not self._f.closed:
            self.flush()
            self._f.close()


def _truncate_wal(path: str, max_step: int, fsync: bool = True) -> int:
    """Rewrite a WAL keeping records with ``step <= max_step`` (the
    timeline-fork path); returns the number of records kept."""
    records, _, _ = read_wal(path)
    keep = [r for r in records if r.step <= max_step]
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for r in keep:
            f.write(_pack_record(r))
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(keep)


@dataclass
class DurableConfig:
    directory: str
    checkpoint_every: int = 16      # commits between checkpoints (RTO knob:
                                    # bounds WAL replay length on restore)
    keep_checkpoints: int = 3       # retained restore points
    wal_fsync: bool = True          # fsync per commit (RPO 0); False trades
                                    # the last few batches for latency
    # WAL group commit: coalesce fsyncs over a commit window of
    # up to this many records / this many seconds since the first buffered
    # record (timeout 0 = count-only window).  1 = fsync per commit (RPO
    # 0, the historical behavior); n > 1 bounds loss at n - 1 committed
    # batches if the host dies with the window open (checkpoint() and
    # heal() close the WAL first, so rotation/fork points are always
    # durable).
    wal_group_commit_n: int = 1
    wal_group_commit_timeout: float = 0.0


def _json_safe(x):
    """Recursively convert numpy scalars/arrays to JSON-native types."""
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, np.ndarray):
        return [_json_safe(v) for v in x.tolist()]
    if isinstance(x, (np.bool_,)):
        return bool(x)
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


class DurableSession:
    """Durably-logged transactional serving: the disaster-recovery wrapper.

    Wraps a :class:`ResilientSession` (which wraps the
    :class:`PartitionSession` and optional deployment).  Every committed
    transaction is WAL-appended before ``submit`` returns; every
    ``checkpoint_every`` commits the full state checkpoints and the WAL
    rotates.  :meth:`restore` rebuilds the whole stack on a fresh process.
    """

    def __init__(self, rs: ResilientSession, cfg: DurableConfig,
                 _resume_step: Optional[int] = None):
        self.rs = rs
        self.cfg = cfg
        os.makedirs(cfg.directory, exist_ok=True)
        # share the serving stack's registry (WAL fsync + checkpoint
        # latency histograms land next to the session's update metrics)
        self.metrics = rs.session.metrics
        self.checkpoints_written = 0
        self.failed_checkpoints = 0
        self.last_checkpoint_error: Optional[BaseException] = None
        self.last_checkpoint_seconds = 0.0
        self.last_restore_seconds = 0.0
        self._commits_since_ckpt = 0
        rs.on_commit = self._on_commit
        if _resume_step is None:
            step = self.checkpoint()
            if step is None:     # initial durability anchor must exist
                raise self.last_checkpoint_error
        else:
            # resuming after restore(): the anchor checkpoint + WAL already
            # exist on disk; keep appending to the (truncated-clean) WAL
            self._anchor_step = int(_resume_step)
            self._wal = self._open_wal(self._anchor_step, fresh=False)

    # ------------------------------------------------------------- internals

    def _open_wal(self, step: int, fresh: bool) -> WriteAheadLog:
        return WriteAheadLog(
            wal_path(self.cfg.directory, step),
            fsync=self.cfg.wal_fsync, fresh=fresh,
            group_n=self.cfg.wal_group_commit_n,
            group_timeout=self.cfg.wal_group_commit_timeout,
            registry=self.metrics,
        )

    def _on_commit(self, tx: TxResult, upd: GraphUpdate, sup: bool) -> None:
        self._wal.append(WalRecord(
            step=self.rs.session._step, seq=tx.seq, suppress=sup, upd=upd,
        ))
        self._commits_since_ckpt += 1

    def _checkpoint_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.cfg.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def _capture(self) -> Tuple[dict, dict]:
        """Serialize the full serving state (host arrays + JSON metadata).

        Runs at transaction boundaries; the store's pending overlay is
        captured as-is (base + delta), so nothing is compacted or mutated
        by taking a checkpoint."""
        sess = self.rs.session
        store = sess.store
        gh = store.base.to_host()
        # the port's overlay chunks are int64: the checkpoint keeps the
        # reference's dtypes (int32 ids, int64 indptr, float32 weights)
        cat = (lambda ch, dt: np.concatenate(ch).astype(dt) if ch
               else np.zeros(0, dt))
        tree = dict(
            ew=np.asarray(gh.ew, np.float32),
            indices=np.asarray(gh.indices, np.int32),
            indptr=np.asarray(gh.indptr, np.int64),
            labels=sess.labels_np().astype(np.int32),
            nw=store._nw.astype(np.float64),
            overlay_u=cat(store._ou, np.int32),
            overlay_v=cat(store._ov, np.int32),
            overlay_w=cat(store._ow, np.float32),
        )
        scfg = dataclasses.asdict(sess.cfg)
        custom_partition_cfg = scfg.pop("partition_cfg") is not None
        dep = self.rs.deployment
        if dep is None:
            dep_info = None
        else:
            dep_info = dict(
                type=type(dep).__name__, halo=dep.halo,
                escalate_fraction=dep.escalate_fraction,
                replicas=getattr(dep, "replicas", 1),
            )
        extra = _json_safe(dict(
            kind="partition_session_dr",
            format=1,
            n=store.n, m=store.base.m, k=sess.k,
            step=sess._step, cut_ref=sess._cut_ref, ew_ref=sess._ew_ref,
            suppress_escalation=sess.suppress_escalation,
            session_cfg=scfg,
            custom_partition_cfg=custom_partition_cfg,
            trajectory=[dataclasses.asdict(r) for r in sess.trajectory],
            resilient_cfg=dataclasses.asdict(self.rs.cfg),
            expected_seq=self.rs._expected_seq,
            degraded=self.rs.degraded,
            deployment=dep_info,
        ))
        return tree, extra

    # ---------------------------------------------------------------- public

    @property
    def session(self) -> PartitionSession:
        return self.rs.session

    @property
    def anchor_step(self) -> int:
        """Step of the checkpoint the current WAL extends."""
        return self._anchor_step

    def submit(self, upd: GraphUpdate, seq: Optional[int] = None) -> TxResult:
        """Transactional submit with durable commit logging; checkpoints at
        the configured cadence AFTER the transaction completes (a
        checkpoint is always a transaction-boundary state)."""
        tx = self.rs.submit(upd, seq=seq)
        if self._commits_since_ckpt >= self.cfg.checkpoint_every:
            self.checkpoint()
        return tx

    def checkpoint(self) -> Optional[int]:
        """Write a full durable checkpoint and rotate the WAL.

        Returns the checkpoint step, or None on failure — a failed write
        (disk full, injected crash) NEVER hurts recoverability: the torn
        ``.tmp`` is invisible to ``latest_step``, the previous checkpoint
        stays intact, and the current WAL keeps extending it, so the
        latest restorable state is exactly what it was before the
        attempt."""
        t0 = time.time()
        step = self.rs.session._step
        with _obs_span("checkpoint.write", cat="resilience",
                       step=int(step)) as sp:
            try:
                tree, extra = self._capture()
                ckpt.save(self.cfg.directory, step, tree, extra)
            except BaseException as e:
                self.failed_checkpoints += 1
                self.last_checkpoint_error = e
                self.last_checkpoint_seconds = time.time() - t0
                sp.set(failed=True)
                return None
        if getattr(self, "_wal", None) is not None:
            self._wal.close()
        self._anchor_step = step
        self._wal = self._open_wal(step, fresh=True)
        self._commits_since_ckpt = 0
        self.checkpoints_written += 1
        self.last_checkpoint_seconds = time.time() - t0
        self.metrics.observe("checkpoint_seconds",
                             self.last_checkpoint_seconds)
        self._prune()
        return step

    def _prune(self) -> None:
        """Drop checkpoints (and their WALs) beyond the retention window."""
        steps = self._checkpoint_steps()
        for s in steps[: -self.cfg.keep_checkpoints]:
            shutil.rmtree(
                os.path.join(self.cfg.directory, f"step_{s:08d}"),
                ignore_errors=True,
            )
            try:
                os.remove(wal_path(self.cfg.directory, s))
            except OSError:
                pass

    def heal(self):
        """:meth:`ResilientSession.heal` + durable timeline maintenance.

        A heal that rolled the session back past committed batches forks
        the timeline: WAL records (and any checkpoints) newer than the
        surviving step describe a future that no longer exists and are
        truncated/dropped, so a later restore lands on the healed state,
        not the corrupt one."""
        rep = self.rs.heal()
        self._refit_to_step(self.rs.session._step)
        return rep

    def _refit_to_step(self, step: int) -> None:
        step = int(step)
        dropped = [s for s in self._checkpoint_steps() if s > step]
        for s in dropped:
            shutil.rmtree(
                os.path.join(self.cfg.directory, f"step_{s:08d}"),
                ignore_errors=True,
            )
            try:
                os.remove(wal_path(self.cfg.directory, s))
            except OSError:
                pass
        anchors = [s for s in self._checkpoint_steps() if s <= step]
        if not anchors:
            # rolled back below every retained checkpoint (snapshots can
            # predate the durable wrapper): re-anchor with a fresh one
            # (second attempt absorbs a transient/injected write failure)
            self._wal.close()
            if self.checkpoint() is None and self.checkpoint() is None:
                raise self.last_checkpoint_error
            return
        anchor = anchors[-1]
        self._wal.close()
        _truncate_wal(
            wal_path(self.cfg.directory, anchor), step,
            fsync=self.cfg.wal_fsync,
        )
        self._anchor_step = anchor
        self._wal = self._open_wal(anchor, fresh=False)

    def close(self) -> None:
        self._wal.close()

    def stats(self) -> dict:
        d = self.rs.stats()
        d.update(
            dr_anchor_step=self._anchor_step,
            dr_checkpoints_written=self.checkpoints_written,
            dr_failed_checkpoints=self.failed_checkpoints,
            dr_wal_records=self._wal.records_appended,
            dr_wal_flushes=self._wal.flushes,
            dr_wal_buffered=self._wal.buffered,
            dr_commits_since_checkpoint=self._commits_since_ckpt,
            # RPO observable: records that exist only in the current WAL —
            # the replay a restore would need (plus buffered = not yet
            # durable at all).  RTO observable: measured restore wall time.
            dr_wal_records_since_checkpoint=self._wal.records_appended,
            dr_last_checkpoint_seconds=self.last_checkpoint_seconds,
            dr_last_restore_seconds=self.last_restore_seconds,
        )
        return d

    # ---------------------------------------------------------------- restore

    @staticmethod
    def restore(
        directory: str,
        *,
        durable_cfg: Optional[DurableConfig] = None,
        session_cfg: Optional[SessionConfig] = None,
        with_deployment: Optional[bool] = None,
        device=None,
    ) -> Tuple["DurableSession", RestoreReport]:
        """Rebuild the full serving stack on a fresh process.

        Procedure (the restore-on-fresh-process path):
        newest complete checkpoint -> session WITHOUT the initial V-cycle
        -> WAL replay through the real ``update`` path (suppress flags
        re-applied per record) -> deployment re-extraction from the
        restored labels -> transactional wrapper with the persisted
        sequence state.  The result's ``host_digest`` is bit-identical to
        the crashed process's at its last committed transaction.

        ``session_cfg`` overrides the persisted config — REQUIRED when the
        original session used a custom ``partition_cfg`` (not serialized).
        ``with_deployment=False`` skips rebuilding a persisted deployment.
        The stack is rebuilt on ``device`` (CUDA unless the caller names
        another).
        """
        t0 = time.time()
        anchor = ckpt.latest_step(directory)
        if anchor is None:
            raise FileNotFoundError(
                f"no complete checkpoint under {directory}"
            )
        leaves, manifest = ckpt.load(directory, anchor)
        extra = manifest["extra"]
        if extra.get("kind") != "partition_session_dr":
            raise ValueError(f"not a DR checkpoint: {extra.get('kind')!r}")
        # leaves are in flatten (sorted-key) order of _capture's dict
        ew, indices, indptr, labels, nw, ov_u, ov_v, ov_w = leaves
        if extra["custom_partition_cfg"] and session_cfg is None:
            raise ValueError(
                "checkpoint used a custom partition_cfg (not serialized); "
                "pass session_cfg explicitly"
            )
        cfg = session_cfg or SessionConfig(**extra["session_cfg"])
        g = GraphNP(
            indptr=indptr.astype(np.int64),
            indices=indices.astype(np.int32),
            ew=ew.astype(np.float32),
            nw=nw.astype(np.float32),
        )
        traj = [UpdateResult(**r) for r in extra["trajectory"]]
        sess = PartitionSession.from_restored(
            g, cfg,
            labels=labels, step=extra["step"], cut_ref=extra["cut_ref"],
            ew_ref=extra["ew_ref"], trajectory=traj,
            suppress_escalation=extra["suppress_escalation"],
            device=device,
        )
        # the f64 host mirror is authoritative for L_max / feasibility;
        # restore it exactly rather than through the f32 device round-trip
        sess.store._nw = nw.astype(np.float64)
        if ov_u.size:
            # the port's store keeps int64 overlay ids
            sess.store._ou.append(ov_u.astype(np.int64))
            sess.store._ov.append(ov_v.astype(np.int64))
            sess.store._ow.append(ov_w.astype(np.float32))
            sess.store._olen += int(ov_u.size)
        # ---- WAL replay: committed batches since the anchor checkpoint ----
        wal_file = wal_path(directory, anchor)
        records, valid_bytes, tail_error = read_wal(wal_file)
        wal_size = os.path.getsize(wal_file) if os.path.exists(wal_file) \
            else 0
        replayed = 0
        last_suppress = bool(extra["suppress_escalation"])
        last_seq = None
        for rec in records:
            if rec.step <= sess._step:
                continue            # already inside the checkpoint
            sess.suppress_escalation = rec.suppress
            sess.update(rec.upd)
            assert sess._step == rec.step, (sess._step, rec.step)
            replayed += 1
            last_suppress = rec.suppress
            last_seq = rec.seq
        if valid_bytes < wal_size:
            # torn/corrupt tail: drop it so future appends stay parseable
            with open(wal_file, "rb") as f:
                good = f.read(valid_bytes)
            with open(wal_file, "wb") as f:
                f.write(good)
                f.flush()
                os.fsync(f.fileno())
        # ---- deployment: derived state, re-extracted from restored labels
        dep_info = extra.get("deployment")
        dep = None
        if dep_info is not None and with_deployment is not False:
            if dep_info["type"] == "ReplicatedDeployment":
                from ..deploy.replicate import ReplicatedDeployment
                dep = ReplicatedDeployment(
                    sess, halo=dep_info["halo"],
                    escalate_fraction=dep_info["escalate_fraction"],
                    replicas=dep_info["replicas"],
                )
            else:
                from ..deploy.migrate import ShardDeployment
                dep = ShardDeployment(
                    sess, halo=dep_info["halo"],
                    escalate_fraction=dep_info["escalate_fraction"],
                )
        rs = ResilientSession(
            sess, deployment=dep,
            cfg=ResilientConfig(**extra["resilient_cfg"]),
        )
        rs._expected_seq = int(extra["expected_seq"])
        if last_seq is not None:
            rs._expected_seq = max(rs._expected_seq, last_seq + 1)
        sess.suppress_escalation = last_suppress
        rs.degraded = last_suppress or (replayed == 0
                                        and bool(extra["degraded"]))
        dcfg = durable_cfg or DurableConfig(directory=directory)
        ds = DurableSession(rs, dcfg, _resume_step=anchor)
        report = RestoreReport(
            checkpoint_step=int(anchor),
            records_replayed=replayed,
            wal_tail_error=tail_error,
            wal_bytes_dropped=int(wal_size - valid_bytes),
            seconds=time.time() - t0,
        )
        ds.last_restore_seconds = report.seconds
        ds.metrics.observe("restore_seconds", report.seconds)
        return ds, report
