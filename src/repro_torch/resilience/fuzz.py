"""End-to-end disaster-recovery fault fuzzer (resilience, layer 6) — the
torch twin of ``repro.resilience.fuzz``: the same seeded episodes, run on
the device the caller names (CUDA by default).

Single-fault unit tests prove each recovery path works in isolation; real
outages stack faults.  This harness drives the full serving stack —
:class:`~repro_torch.dynamic.session.PartitionSession` inside a
:class:`~repro_torch.resilience.transact.ResilientSession` with a
:class:`~repro_torch.deploy.replicate.ReplicatedDeployment` and a
:class:`~repro_torch.resilience.durable.DurableSession` on top — through seeded
episodes that interleave EVERY :class:`~repro_torch.resilience.faults.
FaultInjector` class (label / overlay / base-CSR / shard / replica / WAL
corruption, shard loss, stream drop + duplicate + reorder, extract and
escalation crashes, mid-checkpoint kills) against two concurrently mangled
producer streams, with serving reads mixed in.

The property checked after every episode, not per fault: **the stack
heals or restores to the oracle**.  Concretely —

* ``heal()`` normally ends with a passing invariant audit; when stacked
  faults exhaust the snapshot ring (no retained in-memory version is
  clean), the remedy is disaster recovery proper — restore from disk,
  walking back through retained checkpoints until one audits clean;
* a fresh-process :meth:`DurableSession.restore` replays the WAL to a
  session whose :func:`~repro_torch.resilience.snapshot.host_digest` is
  **bit-identical** to the live healed session.  Two fault classes fork
  the live timeline away from the durable one in ways no audit can see
  (label corruption is a *valid* partition the next commit absorbs; WAL
  media corruption silently drops committed records — both outside the
  RPO-0 crash contract), so the harness re-anchors with a checkpoint
  before the strict digest comparison whenever such a fault fired since
  the last rotation — which is itself the documented operator remedy;
* every block is readable through the checksum-audited ``read_block``
  path at episode end, with one retry absorbing a pending injected
  infrastructure failure.

Episodes never assert mid-flight: violations are collected as strings so
one failing seed reports everything it saw.
"""

from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..dynamic.session import PartitionSession, SessionConfig
from ..dynamic.store import GraphUpdate
from ..graph.generators import planted_partition
from .durable import DurableConfig, DurableSession, wal_path
from .faults import FaultInjector, InjectedFailure
from .snapshot import host_digest
from .transact import ResilientConfig, ResilientSession

__all__ = ["FuzzConfig", "EpisodeResult", "FuzzReport", "run_episode",
           "run_fuzz"]


@dataclass
class FuzzConfig:
    directory: str                  # workdir; episode e uses <dir>/ep<e>
    n: int = 600                    # fixed across episodes
    k: int = 4
    episodes: int = 20
    batches_per_episode: int = 12
    batch_size: int = 24
    seed: int = 0
    checkpoint_every: int = 4       # tight cadence: rotation under fire
    replicas: int = 2
    audit_cadence: int = 2
    drop: float = 0.12              # stream-mangling probabilities
    dup: float = 0.12
    swap: float = 0.15
    fault_rate: float = 0.5         # injections per submitted batch (avg)
    read_rate: float = 0.5          # serving reads per submitted batch
    invalid_batch_rate: float = 0.1  # producer emits a garbage batch


@dataclass
class EpisodeResult:
    seed: int
    commits: int = 0
    quarantined: int = 0
    faults: List[str] = field(default_factory=list)
    heals: int = 0
    heal_failures: int = 0          # ring exhausted -> disaster restore
    restores: int = 0
    replayed: int = 0
    failovers: int = 0
    strict_digest_checks: int = 0
    violations: List[str] = field(default_factory=list)
    seconds: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.violations


@dataclass
class FuzzReport:
    episodes: List[EpisodeResult] = field(default_factory=list)
    seconds: float = 0.0

    @property
    def ok(self) -> bool:
        return all(e.ok for e in self.episodes)

    @property
    def violations(self) -> List[str]:
        return [f"ep{e.seed}: {v}" for e in self.episodes
                for v in e.violations]

    def summary(self) -> dict:
        eps = self.episodes
        return dict(
            episodes=len(eps),
            ok=self.ok,
            commits=sum(e.commits for e in eps),
            quarantined=sum(e.quarantined for e in eps),
            faults=sum(len(e.faults) for e in eps),
            heals=sum(e.heals for e in eps),
            heal_failures=sum(e.heal_failures for e in eps),
            restores=sum(e.restores for e in eps),
            failovers=sum(e.failovers for e in eps),
            strict_digest_checks=sum(e.strict_digest_checks for e in eps),
            violations=self.violations,
            seconds=self.seconds,
        )


# The injection menu: every fault class the injector knows, weighted so
# cheap state corruptions dominate and process-level faults stay rare
# enough that most episodes still make forward progress.  Faults that
# fork the live timeline from the durable one undetectably (see module
# docstring) are flagged: a checkpoint must re-anchor before the strict
# digest contract holds again.
_FAULT_MENU = (
    ("corrupt_labels", 3),
    ("corrupt_base_csr", 2),
    ("corrupt_shard", 3),
    ("lose_shard", 2),
    ("corrupt_replica", 2),
    ("fail_next_extract", 1),
    ("fail_next_escalation", 1),
    ("fail_mid_checkpoint", 1),
    ("corrupt_wal", 1),
    ("bitflip_overlay", 1),
)
_TIMELINE_FORKING = frozenset({"corrupt_labels", "corrupt_wal"})


def _inject(name: str, inj: FaultInjector, ds: DurableSession) -> Optional[str]:
    """Fire one named fault against the running stack; returns the fault
    kind actually recorded (None when there was nothing to corrupt)."""
    sess, dep = ds.session, ds.rs.deployment
    if name == "corrupt_labels":
        f = inj.corrupt_labels(sess, count=2)
    elif name == "corrupt_base_csr":
        f = inj.corrupt_base_csr(
            sess.store, mode="weight" if inj.rng.random() < 0.5 else "endpoint"
        )
    elif name == "corrupt_shard":
        f = inj.corrupt_shard(dep)
    elif name == "lose_shard":
        f = inj.lose_shard(dep)
    elif name == "corrupt_replica":
        f = inj.corrupt_replica(dep)
    elif name == "fail_next_extract":
        f = inj.fail_next_extract(dep)
    elif name == "fail_next_escalation":
        f = inj.fail_next_escalation(sess)
    elif name == "fail_mid_checkpoint":
        f = inj.fail_mid_checkpoint(ds)
    elif name == "corrupt_wal":
        f = inj.corrupt_wal(ds)
    elif name == "bitflip_overlay":
        f = inj.bitflip_overlay(sess.store)
    else:  # pragma: no cover - menu/dispatch mismatch
        raise ValueError(name)
    return f.kind if f is not None else None


def _producer_batches(rng: np.random.Generator, n: int, count: int,
                      size: int, invalid_rate: float) -> List[GraphUpdate]:
    """One producer's batch list: random edge additions over the fixed
    node set, with an occasional garbage batch (endpoints past ``n``) that
    validation must quarantine without moving state."""
    out = []
    for _ in range(count):
        u = rng.integers(0, n, size)
        v = (u + 1 + rng.integers(0, n - 1, size)) % n
        if rng.random() < invalid_rate:
            u = u + n + 17        # out-of-range: the mangled-producer case
        out.append(GraphUpdate.add_edges(u, v))
    return out


def _digest_mismatch(a: dict, b: dict) -> Optional[str]:
    if a.keys() != b.keys():
        return f"digest keys differ: {sorted(a)} vs {sorted(b)}"
    for key in a:
        if not np.array_equal(a[key], b[key]):
            return f"digest field {key!r} differs"
    return None


def _force_checkpoint(ds: DurableSession, ep: EpisodeResult) -> bool:
    """Re-anchor durable state at the live session (two attempts: a
    pending one-shot mid-checkpoint kill consumes the first)."""
    for _ in range(2):
        if ds.checkpoint() is not None:
            return True
    ep.violations.append(
        f"checkpoint failed twice: {ds.last_checkpoint_error!r}"
    )
    return False


def _restore_drill(ds: DurableSession, ep: EpisodeResult,
                   tag: str) -> DurableSession:
    """Simulate process death + fresh-process restore; returns the
    restored stack (the episode continues on it).

    Call on a HEALED, re-anchored stack: the live session equals its last
    committed transaction and the WAL is intact past the anchor, so the
    restored digest must match bit-for-bit."""
    live = host_digest(ds.session)
    # no close(): a crash does not flush anything the commit path has not
    # already fsynced — restoring from exactly what is on disk is the test
    try:
        ds2, rep = DurableSession.restore(
            ds.cfg.directory, device=ds.session.device
        )
    except Exception as e:
        ep.violations.append(f"{tag}: restore raised {e!r}")
        return ds
    ep.restores += 1
    ep.replayed += rep.records_replayed
    miss = _digest_mismatch(host_digest(ds2.session), live)
    ep.strict_digest_checks += 1
    if miss is not None:
        ep.violations.append(f"{tag}: restore not bit-identical: {miss}")
    audit = ds2.rs.auditor.audit()
    if not audit.ok:
        ep.violations.append(
            f"{tag}: restored session failed audit: {audit.failures}"
        )
    return ds2


def _disaster_restore(directory: str, ep: EpisodeResult,
                      tag: str, device) -> Optional[DurableSession]:
    """The runbook's last-resort path, exercised when no retained
    in-memory snapshot is clean: restore from disk, discarding restore
    points that audit dirty until one is healthy (``keep_checkpoints``
    retention exists precisely for this walk-back)."""
    for _ in range(8):
        try:
            ds2, _ = DurableSession.restore(directory, device=device)
        except FileNotFoundError:
            ep.violations.append(f"{tag}: no restorable checkpoint left")
            return None
        except Exception as e:
            ep.violations.append(f"{tag}: disaster restore raised {e!r}")
            return None
        ep.restores += 1
        if ds2.rs.auditor.audit().ok:
            return ds2
        bad = ds2.anchor_step
        shutil.rmtree(
            os.path.join(directory, f"step_{bad:08d}"), ignore_errors=True
        )
        try:
            os.remove(wal_path(directory, bad))
        except OSError:
            pass
    ep.violations.append(f"{tag}: no retained checkpoint audits clean")
    return None


def _read_block_checked(dep, b: int, ep: EpisodeResult) -> None:
    """A serving read; one retry absorbs a pending injected one-shot
    infrastructure failure in the synchronous-recovery fallback."""
    for attempt in (0, 1):
        try:
            shard = dep.read_block(b)
        except InjectedFailure:
            if attempt:
                ep.violations.append(f"read_block({b}) failed twice")
                return
            continue
        if shard is None or not dep.verify_shard(b, shard):
            ep.violations.append(f"read_block({b}) served a bad shard")
        return


def run_episode(cfg: FuzzConfig, ep_seed: int, g, labels0: np.ndarray,
                cut_ref: float, ew_ref: float, device=None) -> EpisodeResult:
    """One seeded episode over a fresh stack (cheap: restored from the
    golden labels, no V-cycle): mangled two-producer stream + interleaved
    faults + serving reads, a mid-episode crash/restore drill, and the
    heal-or-restore property checks at the end."""
    t0 = time.time()
    ep = EpisodeResult(seed=ep_seed)
    rng = np.random.default_rng(ep_seed)
    inj = FaultInjector(ep_seed)
    workdir = os.path.join(cfg.directory, f"ep{ep_seed}")

    sess = PartitionSession.from_restored(
        g, SessionConfig(k=cfg.k, seed=0),
        labels=labels0.copy(), step=0, cut_ref=cut_ref, ew_ref=ew_ref,
        device=device,
    )
    from ..deploy.replicate import ReplicatedDeployment
    dep = ReplicatedDeployment(sess, replicas=cfg.replicas)
    rs = ResilientSession(
        sess, deployment=dep,
        cfg=ResilientConfig(audit_cadence=cfg.audit_cadence),
    )
    ds = DurableSession(rs, DurableConfig(
        directory=workdir, checkpoint_every=cfg.checkpoint_every,
    ))

    # two producers, independently mangled, merged by original seq — the
    # transactional layer sees drops as gaps, dups as replays, swaps as
    # out-of-order arrivals
    half = cfg.batches_per_episode - cfg.batches_per_episode // 2
    batches = _producer_batches(
        rng, cfg.n, half, cfg.batch_size, cfg.invalid_batch_rate
    ) + _producer_batches(
        rng, cfg.n, cfg.batches_per_episode // 2, cfg.batch_size,
        cfg.invalid_batch_rate,
    )
    stream = inj.mangle_stream(
        batches, drop=cfg.drop, dup=cfg.dup, swap=cfg.swap
    )

    names = [name for name, w in _FAULT_MENU for _ in range(w)]
    forked = False                  # durable/live timelines diverged
    ckpts_seen = ds.checkpoints_written
    drill_at = int(rng.integers(1, max(2, len(stream)))) \
        if len(stream) > 1 else None

    def sync_rotation() -> None:
        # any successful checkpoint rotates the WAL and re-anchors the
        # durable timeline at the live state, healing a fork
        nonlocal forked, ckpts_seen
        if ds.checkpoints_written > ckpts_seen:
            ckpts_seen = ds.checkpoints_written
            forked = False

    def heal_or_restore(tag: str) -> bool:
        # heal in memory; when the ring is exhausted, fall back to the
        # disaster-restore walk.  Returns False when even that failed.
        nonlocal ds, dep, forked, ckpts_seen
        rep = ds.heal()
        ep.heals += 1
        sync_rotation()
        if not rep.ok:
            ep.heal_failures += 1
            nds = _disaster_restore(
                ds.cfg.directory, ep, tag, ds.session.device
            )
            if nds is None:
                return False
            ds, dep = nds, nds.rs.deployment
            forked, ckpts_seen = False, ds.checkpoints_written
        if ds.rs.degraded:
            ep.violations.append(f"{tag}: degraded after clean heal")
        return True

    for i, (seq, upd) in enumerate(stream):
        if rng.random() < cfg.fault_rate:
            kind = _inject(str(rng.choice(names)), inj, ds)
            if kind is not None:
                ep.faults.append(kind)
                forked = forked or kind in _TIMELINE_FORKING
        tx = ds.submit(upd, seq=seq)
        for t in [tx] + tx.followups:
            ep.commits += int(t.committed)
            ep.quarantined += int(t.quarantined)
        sync_rotation()
        if rng.random() < cfg.read_rate:
            _read_block_checked(dep, int(rng.integers(0, cfg.k)), ep)
        if i == drill_at:
            # mid-episode kill: heal first (the strict digest contract
            # needs the live session at a committed, audited state)
            if heal_or_restore("mid-episode heal"):
                if forked and _force_checkpoint(ds, ep):
                    sync_rotation()
                if not forked:
                    ds = _restore_drill(ds, ep, tag="mid-episode")
                    dep = ds.rs.deployment
                    ckpts_seen = ds.checkpoints_written
            # retire the old injector (restore any armed-but-unfired
            # one-shot patches, e.g. the process-global ckpt.save hook)
            # and rebind to the (possibly new) live objects
            inj.disarm()
            inj = FaultInjector(ep_seed + 1)

    # ---- episode end: the heal-or-restore property -----------------------
    if heal_or_restore("final heal"):
        if forked and _force_checkpoint(ds, ep):
            sync_rotation()
        if not forked:
            ds = _restore_drill(ds, ep, tag="final")
            dep = ds.rs.deployment
        try:
            dep.run_recovery()
        except InjectedFailure:
            dep.run_recovery()      # one-shot hook consumed; must succeed
        for b in range(cfg.k):
            _read_block_checked(dep, b, ep)
        ep.failovers = dep.failovers
    inj.disarm()    # a hook left armed would leak into the next episode
    ep.seconds = time.time() - t0
    return ep


def run_fuzz(cfg: FuzzConfig, device=None) -> FuzzReport:
    """Run the full fuzzing campaign: one golden partition (the only
    V-cycle), then ``cfg.episodes`` seeded episodes over fresh stacks, on
    ``device`` (CUDA unless the caller names another)."""
    t0 = time.time()
    os.makedirs(cfg.directory, exist_ok=True)
    g = planted_partition(cfg.n, cfg.k, 12, 2, seed=0)
    golden = PartitionSession(g, SessionConfig(k=cfg.k, seed=0),
                              device=device)
    device = golden.device
    labels0 = golden.labels_np()
    cut_ref, ew_ref = golden._cut_ref, golden._ew_ref
    report = FuzzReport()
    for e in range(cfg.episodes):
        report.episodes.append(run_episode(
            cfg, cfg.seed * 1000 + e, g, labels0, cut_ref, ew_ref, device
        ))
    report.seconds = time.time() - t0
    return report
