"""Incremental shard migration from the dynamic session (layer 3) — the
torch twin of ``repro.deploy.migrate`` (host numpy bookkeeping around the
device extractor).

A deployed partition must track the partition it deploys: every
``PartitionSession.update`` moves nodes (repair) and mutates the graph
(edge/node churn), and the serving PEs need their :class:`BlockShard`
artifacts patched — re-extracting the world per batch would throw away the
entire point of incremental repair.  :class:`ShardDeployment` keeps the
shard set consistent by re-extracting only the **affected blocks** and
re-assembling the (cheap, host-side) exchange schedule globally:

* a *dirty node* is a moved node (label changed), a net-churned edge
  endpoint, or a freshly added node;
* block ``b`` is *affected* iff a dirty node is a member of its shard
  (owned or ghost) or is the source/target block of a move.  This is exact,
  not heuristic: an edge ``{u, v}`` appears in (or shifts the halo of) a
  shard only if ``u`` or ``v`` already lies within its h-ring — any path
  from the block through the new edge is longer than ``h`` otherwise — and
  a label move changes exactly the two block's node sets plus the
  ghost-owner entries of its subscribers.  Slot/send-list shifts in
  *unaffected* shards (an owner's interface buffer re-indexes when its
  requested set changes) are schedule-only and covered by the global
  re-assembly, which costs O(boundary log boundary) host work, not O(m)
  device work.

Each migration emits a :class:`MigrationDelta` — moved nodes, patched
blocks, per-block halo additions/removals — the record a PE runtime would
consume to DMA exactly the changed entries.  **Escalation**: when the
affected fraction reaches ``escalate_fraction`` (or the session itself
escalated to a full V-cycle, which moves nodes everywhere), patching
degenerates and the deployment falls back to a full re-extraction through
the same extractor and the same sticky shape buckets.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..dynamic.session import PartitionSession, UpdateResult, _reg_counter
from ..dynamic.store import GraphUpdate
from ..obs import span as _obs_span
from .extract import BlockExtractor, BlockShard, assemble_schedule

__all__ = ["MigrationDelta", "ShardDeployment"]


@dataclass
class MigrationDelta:
    """What one update did to the deployed shard set."""

    step: int
    moved: np.ndarray                # global ids whose label changed
    moved_from: np.ndarray           # (len(moved),) old block (-1: new node)
    moved_to: np.ndarray             # (len(moved),) new block
    dirty: np.ndarray                # moved + churned endpoints + new nodes
    blocks_patched: np.ndarray       # block ids re-extracted this step
    full_rebuild: bool               # escalated to re-extracting all blocks
    halo_added: Dict[int, np.ndarray] = field(default_factory=dict)
    halo_removed: Dict[int, np.ndarray] = field(default_factory=dict)
    failed: bool = False             # extraction failed: shard set left on
                                     # the last consistent (stale) state
    seconds: float = 0.0

    @property
    def noop(self) -> bool:
        return self.blocks_patched.size == 0


class ShardDeployment:
    """Device-resident shard set tracking a :class:`PartitionSession`.

    ``update(upd)`` forwards the batch to the session (store -> compact ->
    repair -> guard) and then migrates the deployed shards incrementally.
    ``shards[b]`` is always consistent with the session's current graph and
    labels — the invariant the parity tests pin after every batch.  The
    shards live on the session's device.
    """

    # deployment counters live in the session's registry (one stack, one
    # reset/snapshot/export path); the extractor's counters join it under
    # the "deploy." namespace so its h2d/d2h bytes stay distinct from the
    # engine's transfer counters
    migrate_calls = _reg_counter("migrate_calls")
    full_rebuilds = _reg_counter("full_rebuilds")
    blocks_patched_total = _reg_counter("blocks_patched_total")
    failed_migrations = _reg_counter("failed_migrations")
    shard_recoveries = _reg_counter("shard_recoveries")

    def __init__(self, session: PartitionSession, halo: int = 1,
                 escalate_fraction: float = 0.5):
        if halo < 1:
            raise ValueError("halo depth must be >= 1")
        self.session = session
        self.metrics = session.metrics
        self.halo = int(halo)
        self.k = session.k
        self.escalate_fraction = float(escalate_fraction)
        self.extractor = BlockExtractor(registry=session.metrics,
                                        device=session.device)
        self.full_rebuilds = 0
        self.migrate_calls = 0
        self.blocks_patched_total = 0
        self.failed_migrations = 0
        self.shard_recoveries = 0
        # a failed migration leaves the shard set on its last consistent
        # state: ``stale`` flags that it lags the session until the next
        # successful migrate catches up (``_labels`` is only advanced on
        # success, so moved nodes are never lost; churned endpoints of the
        # failed step are carried in ``_pending_dirty``)
        self.stale = False
        self._pending_dirty: List[np.ndarray] = []
        self._labels = session.labels_np().copy()
        self.shards: List[BlockShard] = self.extractor.extract(
            session.store.graph(), session.labels, self.k, halo=self.halo
        )
        self._member = self._membership(self.session.n)
        self.deltas: List[MigrationDelta] = []

    # ------------------------------------------------------------- internals

    def _membership(self, n: int) -> np.ndarray:
        """(k, n) bool: node is a member (owned or ghost) of block's shard —
        the subscriber index the affected-block computation reads."""
        mem = np.zeros((self.k, n), bool)
        for i, s in enumerate(self.shards):
            mem[i, s.own_global_np()] = True
            mem[i, s.ghost_global_np()] = True
        return mem

    def _refresh_member_rows(self, blocks, n: int) -> None:
        if self._member.shape[1] < n:
            self._member = np.pad(
                self._member, ((0, 0), (0, n - self._member.shape[1]))
            )
        for b in blocks:
            self._member[b, :] = False
            s = self.shards[b]
            self._member[b, s.own_global_np()] = True
            self._member[b, s.ghost_global_np()] = True

    # --------------------------------------------------------------- public

    def update(self, upd: GraphUpdate):
        """Session update + incremental shard migration.

        Returns ``(UpdateResult, MigrationDelta)``."""
        res = self.session.update(upd)
        return res, self.migrate(upd, res)

    def migrate(self, upd: Optional[GraphUpdate],
                res: Optional[UpdateResult] = None) -> MigrationDelta:
        """Patch the shard set to the session's current graph + labels."""
        with _obs_span("deploy.migrate", cat="deploy") as sp:
            delta = self._migrate_impl(upd, res)
            sp.set(
                blocks=int(delta.blocks_patched.size),
                full_rebuild=delta.full_rebuild, failed=delta.failed,
            )
        return delta

    def _migrate_impl(self, upd: Optional[GraphUpdate],
                      res: Optional[UpdateResult]) -> MigrationDelta:
        t0 = time.time()
        self.migrate_calls += 1
        sess = self.session
        lab_new = sess.labels_np()
        n_new = lab_new.shape[0]
        old = self._labels
        n_old = old.shape[0]
        both = min(n_old, n_new)
        moved = np.flatnonzero(lab_new[:both] != old[:both]).astype(np.int64)
        new_ids = np.arange(n_old, n_new, dtype=np.int64)
        moved_all = np.concatenate([moved, new_ids])
        moved_from = np.concatenate(
            [old[moved], np.full(new_ids.size, -1, old.dtype)]
        ).astype(np.int32)
        moved_to = lab_new[moved_all].astype(np.int32)
        if upd is not None:
            u, v, _ = upd.net_arcs(max(n_new, 1))
        else:
            u = v = np.zeros(0, np.int64)
        dirty = np.unique(np.concatenate(
            [moved_all, u, v] + self._pending_dirty
        ).astype(np.int64))
        # a lost shard (None — a dropped PE) is re-extracted as part of any
        # migrate pass, so the catch-up paths (resync, heal) self-repair
        # holes instead of tripping over them
        lost = {b for b in range(self.k) if self.shards[b] is None}
        step = res.step if res is not None else sess.trajectory[-1].step
        if dirty.size == 0 and not lost:
            delta = MigrationDelta(
                step=step, moved=moved_all, moved_from=moved_from,
                moved_to=moved_to, dirty=dirty,
                blocks_patched=np.zeros(0, np.int64), full_rebuild=False,
                seconds=time.time() - t0,
            )
            self.deltas.append(delta)
            return delta
        # affected = subscribers of dirty nodes + source/target of moves
        in_range = dirty[dirty < self._member.shape[1]]
        aff = set(np.flatnonzero(self._member[:, in_range].any(axis=1)))
        aff |= {int(b) for b in moved_from if b >= 0}
        aff |= {int(b) for b in moved_to}
        aff |= lost
        escalated = res.escalated if res is not None else False
        full = escalated or len(aff) > self.escalate_fraction * self.k
        blocks = list(range(self.k)) if full else sorted(aff)
        old_ghosts = {
            b: (self.shards[b].ghost_global_np()
                if self.shards[b] is not None else np.zeros(0, np.int64))
            for b in blocks
        }
        g = sess.store.graph()
        try:
            with _obs_span("deploy.extract", cat="deploy",
                           blocks=len(blocks)) as sp:
                fresh = self.extractor.extract(
                    g, sess.labels, self.k, halo=self.halo, blocks=blocks,
                    assemble=False,
                )
                sp.sync_on(fresh[-1].ew)
        except Exception:
            # failed migration: serve the last consistent shard set (stale).
            # ``_labels`` is NOT advanced, so the next successful migrate
            # re-discovers every moved node; the failed step's churned
            # endpoints are queued so halo effects are not lost either.
            self.failed_migrations += 1
            self.stale = True
            if u.size or v.size:
                self._pending_dirty.append(
                    np.concatenate([u, v]).astype(np.int64)
                )
            delta = MigrationDelta(
                step=step, moved=moved_all, moved_from=moved_from,
                moved_to=moved_to, dirty=dirty,
                blocks_patched=np.zeros(0, np.int64), full_rebuild=full,
                failed=True, seconds=time.time() - t0,
            )
            self.deltas.append(delta)
            return delta
        for b, s in zip(blocks, fresh):
            self.shards[b] = s
        with _obs_span("deploy.schedule", cat="deploy"):
            # schedule is globally coupled through the owners' buffer
            # orderings: re-assemble for ALL shards (host O(boundary), not
            # device O(m))
            assemble_schedule(self.shards)
            self._refresh_member_rows(blocks, n_new)
            halo_added, halo_removed = {}, {}
            for b in blocks:
                new_g = self.shards[b].ghost_global_np()
                halo_added[b] = np.setdiff1d(new_g, old_ghosts[b])
                halo_removed[b] = np.setdiff1d(old_ghosts[b], new_g)
        self._labels = lab_new.copy()
        self.stale = False
        self._pending_dirty = []
        if full:
            self.full_rebuilds += 1
        self.blocks_patched_total += len(blocks)
        delta = MigrationDelta(
            step=step, moved=moved_all, moved_from=moved_from,
            moved_to=moved_to, dirty=dirty,
            blocks_patched=np.asarray(blocks, np.int64), full_rebuild=full,
            halo_added=halo_added, halo_removed=halo_removed,
            seconds=time.time() - t0,
        )
        self.deltas.append(delta)
        return delta

    def resync(self, upd: Optional[GraphUpdate] = None,
               full: bool = False) -> MigrationDelta:
        """Catch the shard set up with the session OUTSIDE the normal
        update flow — the rollback path's shard repair.

        A plain ``migrate(None)`` only re-extracts blocks with *moved*
        nodes, which is not enough after a rollback: the undone batch's
        graph churn left halo content in shards that the restored base no
        longer has.  Passing the undone ``upd`` queues its endpoints as
        dirty so those blocks are re-extracted too; ``full=True`` marks
        every node dirty (a full re-extraction through the same migrate
        machinery) for when the set of undone batches is unknown."""
        if full:
            self._pending_dirty.append(
                np.arange(self.session.n, dtype=np.int64)
            )
        elif upd is not None:
            eps = np.concatenate([
                upd.add_u, upd.add_v, upd.rem_u, upd.rem_v,
            ]).astype(np.int64)
            eps = eps[(eps >= 0) & (eps < self.session.n)]
            if eps.size:
                self._pending_dirty.append(eps)
        return self.migrate(None)

    def recover_block(self, b: int) -> BlockShard:
        """Re-extract block ``b`` from the resident global state — the
        recovery path for a lost or corrupted :class:`BlockShard`.

        If the deployment is stale (a prior migration failed), a catch-up
        ``migrate(None)`` runs first so the recovered shard is not newer
        than its peers — the schedule re-assembly couples every shard's
        buffer orderings, so consistency must be restored set-wide.  Always
        re-assembles the exchange schedule."""
        if not 0 <= b < self.k:
            raise ValueError(f"block id {b} outside [0, {self.k})")
        if self.stale:
            self.migrate(None)
        sess = self.session
        g = sess.store.graph()
        fresh = self.extractor.extract(
            g, sess.labels, self.k, halo=self.halo, blocks=[b],
            assemble=False,
        )
        self.shards[b] = fresh[0]
        assemble_schedule(self.shards)
        self._refresh_member_rows([b], sess.n)
        self.shard_recoveries += 1
        return self.shards[b]

    def stats(self) -> dict:
        """Session + extractor counters (the deployment dashboard row)."""
        d = self.session.stats()
        st = self.extractor.stats
        d.update(
            migrate_calls=self.migrate_calls,
            full_rebuilds=self.full_rebuilds,
            blocks_patched_total=self.blocks_patched_total,
            failed_migrations=self.failed_migrations,
            shard_recoveries=self.shard_recoveries,
            shards_stale=self.stale,
            extract_calls=st.extract_calls,
            deploy_bucket_count=st.deploy_bucket_count,
            deploy_h2d_bytes=st.h2d_bytes,
            deploy_d2h_bytes=st.d2h_bytes,
        )
        return d
