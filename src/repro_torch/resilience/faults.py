"""Seeded deterministic fault injection (resilience, layer 3) — the torch
twin of ``repro.resilience.faults``: the same faults from the same draws
of the same seeded generator.

Every recovery path in this package is exercised against *injected*
faults, not hypothetical ones.  The injector draws from one
``np.random.default_rng(seed)``, so a failing test replays exactly; every
injection is logged as an :class:`InjectedFault` record.

Injection discipline: device state is corrupted by **rebinding fresh
objects**, never by writing into a tensor in place.  Snapshots, standby
replicas and the store hold references to the pristine tensors (see
:mod:`~repro_torch.resilience.snapshot`), so an in-place write would
silently corrupt them too and rollback could not heal it — every fault
clones the tensor it corrupts, writes into the clone, and rebinds the
session's labels, a shard's field or a new ``GraphDev`` over the store's
base, which leaves every captured version intact by construction.

Stream-level faults (drop / duplicate / reorder) are modelled on the
batch sequence itself via :meth:`FaultInjector.mangle_stream`; the
transactional layer detects them through sequence numbers.  Simulated
infrastructure failures (extraction/compile blow-ups, escalation
failures) install one-shot raising wrappers on the real entry points and
restore them after firing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..graph.csr import GraphDev

__all__ = ["FaultInjector", "InjectedFault", "InjectedFailure"]


class InjectedFailure(RuntimeError):
    """Raised by one-shot failure hooks (simulated compile/extract crash)."""


@dataclass
class InjectedFault:
    """Log record of one injection."""

    kind: str
    detail: str
    step: int = -1


def _rebind_bumped_weight(s, ei: int) -> None:
    """Add 1 to arc ``ei``'s weight of shard ``s`` in a CLONE and rebind the
    shard's ``ew`` to it: copies of the shard keep the clean tensor."""
    ew = s.ew.clone()
    ew[ei] += 1.0
    s.ew = ew
    s._host = None


class FaultInjector:
    """Deterministic fault source over a session / deployment pair."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.log: List[InjectedFault] = []
        self._disarmers: List = []

    def _record(self, kind: str, detail: str) -> InjectedFault:
        f = InjectedFault(kind=kind, detail=detail)
        self.log.append(f)
        return f

    def disarm(self) -> None:
        """Restore every armed-but-unfired one-shot hook.  One-shot faults
        patch live entry points (including the process-global ``ckpt.save``)
        and restore themselves only when they FIRE — an injector retired
        with a hook still pending must disarm it, or the stale patch leaks
        into unrelated code."""
        for d in self._disarmers:
            d()
        self._disarmers.clear()

    # ------------------------------------------------------- state corruption

    def corrupt_labels(self, session, count: int = 1,
                       out_of_range: bool = False) -> InjectedFault:
        """Flip ``count`` served label entries.  ``out_of_range=False``
        moves nodes to a *valid but wrong* block (caught by the cut
        checksum), ``True`` writes garbage ``>= k`` (caught by the range
        check)."""
        n = session.store.n
        idx = self.rng.choice(n, size=min(count, n), replace=False)
        idx_t = torch.from_numpy(idx).to(session.labels.device)
        lab = session.labels[idx_t].cpu().numpy()
        if out_of_range:
            vals = lab + session.k + 1
        else:
            vals = (lab + 1 + self.rng.integers(0, session.k - 1, idx.size)) \
                % session.k
        new = session.labels.clone()
        new[idx_t] = torch.from_numpy(vals.astype(np.int32)).to(new.device)
        session.labels = new
        return self._record(
            "corrupt_labels",
            f"{idx.size} entries, out_of_range={out_of_range}",
        )

    def bitflip_overlay(self, store) -> Optional[InjectedFault]:
        """Flip one bit of one pending overlay weight (the chunk is
        REPLACED with a modified copy).  Returns None when the overlay is
        empty (nothing to corrupt)."""
        if not store._ow:
            return None
        ci = int(self.rng.integers(0, len(store._ow)))
        chunk = store._ow[ci].copy()
        ei = int(self.rng.integers(0, chunk.size))
        bits = chunk.view(np.uint32)
        bits[ei] ^= np.uint32(1 << int(self.rng.integers(0, 23)))
        store._ow[ci] = chunk
        return self._record("bitflip_overlay", f"chunk {ci} entry {ei}")

    def corrupt_base_csr(self, store, mode: str = "weight") -> InjectedFault:
        """Corrupt the resident base CSR by rebinding a NEW ``GraphDev``
        whose ``ew`` (mode="weight") or ``indices`` (mode="endpoint")
        differs in one entry — an asymmetric arc, exactly what a partial
        DMA or a flipped device page would produce."""
        g = store.base
        if g.m == 0:
            raise ValueError("cannot corrupt an edgeless base")
        ai = int(self.rng.integers(0, g.m))
        if mode == "weight":
            ew = g.ew.clone()
            ew[ai] += 1.0
            new = GraphDev(
                indptr=g.indptr, indices=g.indices, ew=ew,
                nw=g.nw, src=g.src, n=g.n, m=g.m, nw_max=g.nw_max,
                ew_max=g.ew_max, ew_integral=g.ew_integral,
                on_materialize=g.on_materialize,
            )
        elif mode == "endpoint":
            ind = g.indices.clone()
            ind[ai] = (ind[ai] + 1) % max(g.n, 1)
            new = GraphDev(
                indptr=g.indptr, indices=ind, ew=g.ew,
                nw=g.nw, src=g.src, n=g.n, m=g.m, nw_max=g.nw_max,
                ew_max=g.ew_max, ew_integral=g.ew_integral,
                on_materialize=g.on_materialize,
            )
        else:
            raise ValueError(f"unknown mode {mode!r}")
        store.base = new
        return self._record("corrupt_base_csr", f"arc {ai} mode={mode}")

    def corrupt_shard(self, deployment, block: Optional[int] = None) -> InjectedFault:
        """Flip one edge weight inside one deployed shard (bit-flip of a
        served artifact — caught by the reassembly checksum)."""
        b = int(self.rng.integers(0, deployment.k)) if block is None else block
        s = deployment.shards[b]
        if s.m_local == 0:
            raise ValueError(f"shard {b} has no local arcs")
        ei = int(self.rng.integers(0, s.m_local))
        _rebind_bumped_weight(s, ei)
        return self._record("corrupt_shard", f"block {b} arc {ei}")

    def lose_shard(self, deployment, block: Optional[int] = None) -> InjectedFault:
        """Drop a deployed shard entirely (a lost PE)."""
        b = int(self.rng.integers(0, deployment.k)) if block is None else block
        deployment.shards[b] = None
        return self._record("lose_shard", f"block {b}")

    # --------------------------------------------------------- stream mangling

    def mangle_stream(self, batches: List, drop: float = 0.0,
                      dup: float = 0.0, swap: float = 0.0) -> List[Tuple[int, object]]:
        """Turn a batch list into a sequenced ``(seq, batch)`` stream with
        seeded drops, duplicates, and adjacent swaps (reordering).  The
        assigned sequence numbers reflect the ORIGINAL order, so the
        receiver can detect every mangle."""
        seq = list(enumerate(batches))
        out: List[Tuple[int, object]] = []
        for item in seq:
            r = self.rng.random()
            if r < drop:
                self._record("drop_batch", f"seq {item[0]}")
                continue
            out.append(item)
            if self.rng.random() < dup:
                self._record("duplicate_batch", f"seq {item[0]}")
                out.append(item)
        i = 0
        while i + 1 < len(out):
            if self.rng.random() < swap:
                self._record(
                    "reorder_batches", f"seq {out[i][0]} <-> {out[i+1][0]}"
                )
                out[i], out[i + 1] = out[i + 1], out[i]
                i += 2
            else:
                i += 1
        return out

    # ------------------------------------------------------- one-shot failures

    def fail_next_extract(self, deployment) -> Optional[InjectedFault]:
        """Make the deployment's next ``extractor.extract`` raise once
        (simulated compile/DMA failure during migration).  Returns None
        when a hook is already armed: stacking one-shot patches would
        capture the first hook as the "real" entry point and re-arm it on
        fire/disarm."""
        extractor = deployment.extractor
        real = extractor.extract
        if getattr(real, "_injected_hook", False):
            return None

        def boom(*a, **kw):
            extractor.extract = real
            raise InjectedFailure("injected extract failure")

        def disarm():
            if extractor.extract is boom:
                extractor.extract = real

        boom._injected_hook = True
        extractor.extract = boom
        self._disarmers.append(disarm)
        return self._record("fail_next_extract", "one-shot")

    def fail_next_escalation(self, session) -> Optional[InjectedFault]:
        """Make the session's next ``_escalate`` raise once (simulated
        V-cycle crash — the watchdog/degraded-mode trigger).  Returns
        None when a hook is already armed (no stacking)."""
        real = session._escalate
        if getattr(real, "_injected_hook", False):
            return None

        def boom(*a, **kw):
            session._escalate = real
            raise InjectedFailure("injected escalation failure")

        def disarm():
            if session._escalate is boom:
                session._escalate = real

        boom._injected_hook = True
        session._escalate = boom
        self._disarmers.append(disarm)
        return self._record("fail_next_escalation", "one-shot")

    # ------------------------------------------------ disaster-recovery faults

    def fail_mid_checkpoint(self, durable) -> Optional[InjectedFault]:
        """Kill the next checkpoint mid-write: the state capture runs, a
        torn ``step_X.tmp`` partial is left behind, and the save dies
        BEFORE the atomic rename (simulated power loss inside the
        checkpoint window).  The latest complete checkpoint must remain
        the restorable one.  Returns None when a hook is already armed —
        ``ckpt.save`` is process-global, and stacking patches would
        restore the first hook instead of the real writer."""
        import os

        from .. import ckpt

        durable_cfg = durable.cfg
        real_save = ckpt.save
        if getattr(real_save, "_injected_hook", False):
            return None

        def boom(path, step, tree, extra=None):
            ckpt.save = real_save
            tmp = os.path.join(path, f"step_{step:08d}.tmp")
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                f.write(b"torn partial write")
            raise InjectedFailure("injected mid-checkpoint crash")

        def disarm():
            if ckpt.save is boom:
                ckpt.save = real_save

        boom._injected_hook = True
        ckpt.save = boom
        self._disarmers.append(disarm)
        return self._record(
            "fail_mid_checkpoint", f"dir {durable_cfg.directory}"
        )

    def corrupt_wal(self, durable) -> Optional[InjectedFault]:
        """Flip one bit somewhere in the current WAL file's record bytes
        (simulated disk corruption).  The framing crc must confine the
        damage: replay keeps the clean prefix and drops the tail.  Returns
        None when the WAL holds no records yet."""
        import os

        from .durable import wal_path

        path = wal_path(durable.cfg.directory, durable.anchor_step)
        size = os.path.getsize(path) if os.path.exists(path) else 0
        if size == 0:
            return None
        durable._wal._f.flush()
        byte = int(self.rng.integers(0, size))
        bit = int(self.rng.integers(0, 8))
        with open(path, "r+b") as f:
            f.seek(byte)
            old = f.read(1)
            f.seek(byte)
            f.write(bytes([old[0] ^ (1 << bit)]))
        return self._record("corrupt_wal", f"byte {byte} bit {bit}")

    def corrupt_replica(self, deployment,
                        block: Optional[int] = None) -> Optional[InjectedFault]:
        """Flip one edge weight inside one STANDBY copy (replica rot: the
        failover path must audit standbys before promoting them).  Returns
        None when the chosen block has no standbys."""
        b = int(self.rng.integers(0, deployment.k)) if block is None else block
        standbys = deployment._standbys[b]
        if not standbys:
            return None
        ri = int(self.rng.integers(0, len(standbys)))
        s = standbys[ri]
        if s.m_local == 0:
            return None
        ei = int(self.rng.integers(0, s.m_local))
        _rebind_bumped_weight(s, ei)
        return self._record("corrupt_replica", f"block {b} standby {ri} arc {ei}")
