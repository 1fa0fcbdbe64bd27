"""Versioned snapshots of the serving session (resilience, layer 1) — the
torch twin of ``repro.resilience.snapshot``.

A snapshot is cheap by construction, not by compression: no serving code
writes into a tensor the session holds (labels, base-CSR tensors, node
weights are only ever *rebound* to new tensors — the port's aliasing rule,
which stands in for the reference's immutable jax arrays), the store's
``_nw`` host mirror is rebind-only, and the store's overlay chunks are
appended but never mutated in place.  Capturing the state is therefore taking references plus copying
the overlay chunk *lists* — O(pending-chunks) host work, zero device work,
zero data movement — and rolling back is rebinding those references.  The
cost scales with the delta since the last compaction, not with the graph.

Restoring a version makes the session bit-identical to the moment the
snapshot was taken: same labels, same base handle (so engine caches keyed
on its identity stay warm), same overlay, same step counter — replaying
the same update stream from a restored state reproduces the same labels
bit for bit, because every repair seed derives from the step counter
(parity-tested against the :func:`host_digest` numpy oracle).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..obs import span as _obs_span
from ..obs.memory import pin as _mem_pin

__all__ = ["SessionSnapshot", "SnapshotManager", "host_digest"]


@dataclass
class SessionSnapshot:
    """One captured version of the full session state."""

    version: int
    step: int                   # session step counter at capture time
    state: dict = field(repr=False)  # PartitionSession.snapshot_state()
    seconds: float = 0.0        # capture cost (host bookkeeping only)


def host_digest(session) -> Dict[str, np.ndarray]:
    """Deep host-side copy of everything the session serves — the numpy
    oracle the rollback parity tests compare against.

    Unlike :class:`SessionSnapshot` (references), every array here is a
    materialized copy: equal digests before a batch and after its rollback
    prove bit-identical restoration with no reference aliasing involved."""
    gh = session.store.csr_host()
    ou = session.store._ou
    return dict(
        labels=session.labels_np().copy(),
        nw=session.store.node_weights().copy(),
        indptr=np.asarray(gh.indptr).copy(),
        indices=np.asarray(gh.indices).copy(),
        ew=np.asarray(gh.ew).copy(),
        # the port's overlay chunks are int64; the digest keeps the
        # reference's int32 so digests of the two packages compare equal
        overlay_u=(np.concatenate(ou) if ou else np.zeros(0)).astype(np.int32),
        step=np.int64(session._step),
        cut_ref=np.float64(session._cut_ref),
    )


class SnapshotManager:
    """Ring of versioned snapshots over one :class:`PartitionSession`.

    ``take()`` captures the current state and returns its version id;
    ``rollback(version)`` restores it (and drops every newer version — the
    timeline forks, exactly like a transactional abort).  Retention is
    bounded by ``keep``: the oldest snapshots are discarded first, so a
    long-lived session holds O(keep) extra references, and the device
    tensors they hold are freed as versions expire.
    """

    def __init__(self, session, keep: int = 8):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.session = session
        self.keep = int(keep)
        self._snaps: List[SessionSnapshot] = []
        self._next_version = 0
        self.takes = 0
        self.rollbacks = 0

    # ---------------------------------------------------------------- queries

    @property
    def versions(self) -> List[int]:
        return [s.version for s in self._snaps]

    @property
    def latest(self) -> Optional[SessionSnapshot]:
        return self._snaps[-1] if self._snaps else None

    def get(self, version: int) -> SessionSnapshot:
        for s in self._snaps:
            if s.version == version:
                return s
        raise KeyError(f"snapshot version {version} not retained")

    # ------------------------------------------------------------------- ops

    def take(self) -> int:
        """Capture the current session state; returns the new version id."""
        t0 = time.time()
        with _obs_span(
            "resilience.snapshot", cat="resilience",
            version=self._next_version,
        ):
            snap = SessionSnapshot(
                version=self._next_version,
                step=self.session._step,
                state=self.session.snapshot_state(),
            )
        snap.seconds = time.time() - t0
        # snapshot_refs are pins, not owned allocations: the tensors belong
        # to other families (labels arena, base CSR), so retention keeps
        # device memory alive without allocating more of it
        st = snap.state
        base = st["store"]["base"]
        _mem_pin(
            "snapshot_refs", st["labels"], st["store"]["nw_dev"],
            base.indptr, base.indices, base.ew, base.nw, base.src,
        )
        self._next_version += 1
        self._snaps.append(snap)
        if len(self._snaps) > self.keep:
            self._snaps = self._snaps[-self.keep:]
        self.takes += 1
        return snap.version

    def rollback(self, version: int) -> SessionSnapshot:
        """Restore ``version`` and discard every newer snapshot."""
        snap = self.get(version)
        self.session.restore_state(snap.state)
        self._snaps = [s for s in self._snaps if s.version <= version]
        self.rollbacks += 1
        return snap
