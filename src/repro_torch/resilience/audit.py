"""Device-side invariant auditor (resilience, layer 2) — the torch twin of
``repro.resilience.audit``.

Three invariant families, each checked by cheap device reductions:

* **CSR well-formedness** of the store's resident base — monotone
  zero-based ``indptr`` closed at ``m``, inert padding (rows ``>= n`` hold
  ``m``, arcs ``>= m`` hold 0/0), endpoints in range, no self loops,
  ``src`` consistent with ``indptr``, and arc symmetry via a uint32
  wrap-sum checksum (``sum H(u, v, w) == sum H(v, u, w)`` over live arcs —
  order-free, one pass, necessary-not-sufficient by design);
* **partition health** — labels in ``[0, k)``, the stored (trajectory)
  cut bitwise-equal to a recomputation through the *same* engine
  reduction, block weights feasible against the current ``L_max``;
* **shard health** — the wrap-sum of every shard's owned-row global arcs
  equals the base CSR's arc checksum (blocks partition the node set, so
  each arc is owned exactly once), and every ghost's recorded owner block
  matches the served labels.

The uint32 arithmetic runs on int64 tensors holding values in
``[0, 2^32)``: the multiplies split their constant in 16-bit halves
(``_mulmod32``) so no product overflows, sums run in int64 (exact below
2^31 arcs) and are reduced mod 2^32 once at the end.  The checksums equal
the reference's as integers.  Dispatch shapes are recorded through
``EngineStats.note_audit_key`` under the reference's keys; nothing
compiles, so there is no compile counter.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..core.label_propagation import _mulmod32
from ..core.metrics import lmax
from ..obs import span as _obs_span

__all__ = ["AuditReport", "InvariantAuditor"]

_M32 = 0xFFFFFFFF


# --------------------------------------------------------------- device side

def _mix(u, v, wbits):
    """Order-free arc hash: identical in every checksum, so shard sums are
    directly comparable with the base CSR's.  ``u``/``v`` are cast like
    uint32 (negative values wrap), ``wbits`` holds uint32 values."""
    uu = _mulmod32(u & _M32, 0x9E3779B1)
    vv = _mulmod32(v & _M32, 0x85EBCA6B)
    h = ((uu ^ vv ^ wbits) + 0x165667B1) & _M32
    return _mulmod32(h, 0x27D4EB2F)


def _wbits(ew: torch.Tensor) -> torch.Tensor:
    """The float32 weights' bit patterns as uint32 values in int64."""
    return ew.contiguous().view(torch.int32).to(torch.int64) & _M32


def _wrap_sum(h: torch.Tensor) -> torch.Tensor:
    return h.sum() & _M32


def _csr_audit(indptr, src, dst, ew, nw, n: int, m: int):
    """All base-CSR invariants.  Returns ``(flags, chk_fwd, chk_rev)``: an
    (8,) bool tensor (see ``_CSR_FLAGS``) plus the forward/transposed arc
    checksums as 0-d int64 tensors — ``chk_fwd`` doubles as the reference
    the shard reassembly audit compares against."""
    dev = indptr.device
    Nb = indptr.shape[0] - 1
    Mb = src.shape[0]
    iota_n = torch.arange(Nb + 1, device=dev)
    iota_m = torch.arange(Mb, device=dev)
    live = iota_m < m
    mono = torch.all(indptr[1:] >= indptr[:-1])
    closed = (indptr[0] == 0) & torch.all(
        torch.where(iota_n >= n, indptr == m, True)
    )
    in_range = torch.all(
        torch.where(live, (src >= 0) & (src < n) & (dst >= 0) & (dst < n), True)
    )
    no_self = torch.all(torch.where(live, src != dst, True))
    # src consistent with indptr: arc i lies inside its source's row
    src_c = torch.clamp(src, 0, Nb - 1)
    row_lo = indptr[src_c]
    row_hi = indptr[src_c + 1]
    deg_ok = torch.all(
        torch.where(live, (row_lo <= iota_m) & (iota_m < row_hi), True)
    )
    w_pos = torch.all(torch.where(live, ew > 0.0, True))
    pad_inert = torch.all(
        torch.where(live, True, (src == 0) & (dst == 0) & (ew == 0.0))
    )
    nw_pad = torch.all(
        torch.where(torch.arange(nw.shape[0], device=dev) >= n, nw == 0.0, True)
    )
    wbits = _wbits(ew)
    h_fwd = torch.where(live, _mix(src, dst, wbits), 0)
    h_rev = torch.where(live, _mix(dst, src, wbits), 0)
    flags = torch.stack([
        mono, closed, in_range, no_self, deg_ok, w_pos, pad_inert, nw_pad
    ])
    return flags, _wrap_sum(h_fwd), _wrap_sum(h_rev)


_CSR_FLAGS = [
    "indptr_monotone", "indptr_closed", "endpoints_in_range",
    "self_loop_free", "src_indptr_consistent", "weights_positive",
    "arc_padding_inert", "nw_padding_zero",
]


def _labels_audit(labels, n: int, k: int):
    live = torch.arange(labels.shape[0], device=labels.device) < n
    return torch.all(torch.where(live, (labels >= 0) & (labels < k), True))


def _shard_owned_chk(own_g, ghost_g, indptr, indices, ew, n_own: int,
                     m_local: int):
    """uint32 wrap-sum of one shard's owned-row arcs in GLOBAL ids (a 0-d
    int64 tensor).

    Local rank ``r`` maps to ``own_g[r]`` below ``n_own`` and
    ``ghost_g[r - n_own]`` above (the extractor's layout-sort order);
    heads are local ranks, rows recovered by ``searchsorted`` on the
    local indptr.  Padding arcs and non-owned rows are masked out."""
    Eb = indices.shape[0]
    Ob = own_g.shape[0]
    Gb = ghost_g.shape[0]
    iota_e = torch.arange(Eb, device=indices.device)
    row_of = torch.searchsorted(indptr, iota_e, right=True) - 1
    live = (iota_e < m_local) & (row_of >= 0) & (row_of < n_own)
    u_g = own_g[torch.clamp(row_of, 0, Ob - 1)]
    head_own = own_g[torch.clamp(indices, 0, Ob - 1)]
    head_gho = ghost_g[torch.clamp(indices - n_own, 0, Gb - 1)]
    v_g = torch.where(indices < n_own, head_own, head_gho)
    return _wrap_sum(torch.where(live, _mix(u_g, v_g, _wbits(ew)), 0))


def _ghost_owner_audit(ghost_g, ghost_block, labels, n_ghost: int):
    live = torch.arange(ghost_g.shape[0], device=ghost_g.device) < n_ghost
    A = labels.shape[0]
    lab_of = labels[torch.clamp(ghost_g, 0, A - 1)]
    return torch.all(torch.where(live, lab_of == ghost_block, True))


def shard_checksum(s) -> torch.Tensor:
    """:func:`_shard_owned_chk` of one :class:`BlockShard` (0-d tensor)."""
    return _shard_owned_chk(
        s.own_g, s.ghost_g, s.indptr, s.indices, s.ew, s.n_own, s.m_local
    )


def shard_key(s) -> tuple:
    """The reference's audit key of one shard checksum dispatch."""
    return ("shard", s.own_g.shape[0], s.ghost_g.shape[0], s.indices.shape[0])


# ---------------------------------------------------------------- host side

@dataclass
class AuditReport:
    """Outcome of one audit pass."""

    step: int
    ok: bool
    failures: List[str] = field(default_factory=list)
    checked: List[str] = field(default_factory=list)
    stored_cut: float = 0.0
    recomputed_cut: float = 0.0
    seconds: float = 0.0

    def fail(self, what: str) -> None:
        self.failures.append(what)
        self.ok = False


class InvariantAuditor:
    """Configurable-cadence auditor over a session (+ optional deployment).

    ``maybe_audit(step)`` runs a full pass every ``cadence`` committed
    steps (always at ``cadence=1``); ``audit()`` forces one.  Each pass is
    a handful of device reductions over already-resident tensors — no data
    movement beyond a few scalars.
    """

    def __init__(self, session, deployment=None, cadence: int = 8):
        if cadence < 1:
            raise ValueError("cadence must be >= 1")
        self.session = session
        self.deployment = deployment
        self.cadence = int(cadence)
        self.audits = 0
        self.failed_audits = 0
        self.reports: List[AuditReport] = []

    # ------------------------------------------------------------- internals

    def _note(self, key) -> None:
        st = self.session.engine.stats
        st.audit_calls += 1
        st.note_audit_key(key)

    def _audit_graph(self, rep: AuditReport) -> Optional[int]:
        """CSR well-formedness of the resident base; returns the arc
        checksum for the shard pass (None when structure is broken)."""
        g = self.session.store.base
        flags, chk_f, chk_r = _csr_audit(
            g.indptr, g.src, g.indices, g.ew, g.nw, g.n, g.m,
        )
        self._note(("csr", g.indptr.shape[0], g.src.shape[0]))
        vals = torch.cat([flags.to(torch.int64), torch.stack([chk_f, chk_r])]).tolist()
        self.session.engine.stats.d2h_bytes += len(_CSR_FLAGS) + 8
        for name, okay in zip(_CSR_FLAGS, vals[:8]):
            rep.checked.append(f"csr:{name}")
            if not okay:
                rep.fail(f"csr:{name}")
        chk_f, chk_r = vals[8], vals[9]
        rep.checked.append("csr:arc_symmetry")
        if chk_f != chk_r:
            rep.fail("csr:arc_symmetry")
        return chk_f if rep.ok else None

    def _audit_partition(self, rep: AuditReport) -> None:
        sess = self.session
        g = sess.store.base
        in_range = _labels_audit(sess.labels, sess.store.n, sess.k)
        self._note(("labels", sess.labels.shape[0]))
        rep.checked.append("partition:labels_in_range")
        if not bool(in_range):
            rep.fail("partition:labels_in_range")
            return  # cut/bw of out-of-range labels is meaningless
        # recompute through the SAME engine reductions the serving loop
        # scored with: identical tensors, identical reductions -> equal
        # floats, so exact comparison is sound
        rep.stored_cut = float(sess.trajectory[-1].cut)
        rep.recomputed_cut = sess.engine.cut(g, sess.labels)
        rep.checked.append("partition:cut_matches")
        if rep.recomputed_cut != rep.stored_cut:
            rep.fail("partition:cut_matches")
        bw = sess.engine.block_weights(g, sess.labels, sess.k)
        L = lmax(sess.store.total_node_weight, sess.k, sess.cfg.eps)
        rep.checked.append("partition:feasible")
        if float(bw.max()) > L + 1e-6:
            rep.fail("partition:feasible")
        rep.checked.append("partition:weights_conserved")
        if not np.isclose(float(bw.sum()), sess.store.total_node_weight):
            rep.fail("partition:weights_conserved")

    def _audit_shards(self, rep: AuditReport, base_chk: Optional[int]) -> None:
        dep = self.deployment
        if dep is None:
            return
        if dep.stale:
            # a failed migration left the set on its last consistent state:
            # shards lag the session by design, so content checks against
            # the current graph would false-positive — surfaced, not failed
            rep.checked.append("shards:skipped_stale")
            return
        labels = self.session.labels
        outs, blocks, missing = [], [], False
        for s in dep.shards:
            if s is None:
                missing = True
                break
            outs.append(shard_checksum(s))
            self._note(shard_key(s))
            outs.append(_ghost_owner_audit(
                s.ghost_g, s.ghost_block_dev, labels, s.n_ghost,
            ).to(torch.int64))
            self._note(("ghost", s.ghost_g.shape[0], labels.shape[0]))
            self.session.engine.stats.d2h_bytes += 5
            blocks.append(s.block)
        vals = torch.stack(outs).tolist() if outs else []
        total = 0  # python int; reduced mod 2**32 (wrap-sum)
        for b, chk, gok in zip(blocks, vals[0::2], vals[1::2]):
            if not gok:
                rep.fail(f"shards:ghost_owner_block_{b}")
            total = (total + chk) & _M32
        if missing:
            rep.fail("shards:missing_shard")
            return
        rep.checked.append("shards:reassembly_checksum")
        rep.checked.append("shards:ghost_owner_map")
        if base_chk is not None and total != base_chk:
            rep.fail("shards:reassembly_checksum")

    # ---------------------------------------------------------------- public

    def audit(self) -> AuditReport:
        """One full invariant pass; appends and returns the report."""
        t0 = time.time()
        sess = self.session
        rep = AuditReport(step=sess._step, ok=True)
        with _obs_span(
            "resilience.audit", cat="resilience", step=sess._step
        ) as sp:
            # audits run against the compacted base (the served graph); a
            # dirty overlay is pending-but-valid state, not a violation
            sess.store.graph()
            base_chk = self._audit_graph(rep)
            self._audit_partition(rep)
            self._audit_shards(rep, base_chk)
            sp.set(ok=rep.ok)
        rep.seconds = time.time() - t0
        self.audits += 1
        if not rep.ok:
            self.failed_audits += 1
        self.reports.append(rep)
        return rep

    def maybe_audit(self, step: int) -> Optional[AuditReport]:
        """Cadence gate: audit on every ``cadence``-th step."""
        if step % self.cadence == 0:
            return self.audit()
        return None

    def stats(self) -> dict:
        return dict(
            audits=self.audits,
            failed_audits=self.failed_audits,
            audit_cadence=self.cadence,
        )
