"""Mutable device-resident graph store (dynamic subsystem, layer 1) — the
torch twin of ``repro.dynamic.store``.

* **Base CSR** — a bucket-padded :class:`~repro_torch.graph.csr.GraphDev`
  (uploaded once, or the output of the previous compaction).  All O(m)
  state stays on the device.
* **Delta overlay** — a bounded host-side COO buffer of signed arc-weight
  deltas (both directions of each undirected edge).  Weight deltas are
  integral, so merged float32 sums are exact in any order — the
  precondition of every bit-reproducibility guarantee of the subsystem.
* **Compaction** — :func:`merge_overlay_device` folds the overlay back into
  CSR: one stable sort of the int64 key ``u * Nb + v`` (the reference's
  int32 key below 46k nodes and its two-pass lexsort above give the same
  ``(u, v)`` order), run segmentation, exact weight sums, a drop of runs
  whose merged weight reaches zero, and a searchsorted CSR rebuild.
* **View** — :func:`overlay_view_device` gives the merged adjacency without
  the merge sort (repair is insensitive to within-row arc order).
* **Vacuum** — :func:`vacuum_device` drops tombstoned isolated nodes and
  re-packs ids.

``GraphUpdate``, its validation and its wire format are host code copied
from the reference (``to_bytes`` is byte-identical).  The reference's
compile counters and memory accounting are not ported: torch runs eagerly,
and the memory model is a later slice.  Every device program returns new
tensors; nothing here writes into a tensor that a base, a view or a
snapshot may hold.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..graph.csr import GraphDev, GraphNP, arc_bucket, pow2, to_device_csr
from ..obs import MetricsRegistry, RegistryBackedStats
from ..obs import span as _obs_span
from ..obs.memory import account as _mem_account
from ..obs.watchdog import note_new

__all__ = [
    "DynamicGraphStore",
    "GraphUpdate",
    "StoreStats",
    "UpdateValidationError",
    "merge_overlay_device",
    "overlay_view_device",
    "vacuum_device",
]


class UpdateValidationError(ValueError):
    """A :class:`GraphUpdate` failed pre-apply validation.

    Subclasses ``ValueError`` (the historical raise type) and carries a
    structured ``reason`` tag so the resilience layer can quarantine by
    fault class instead of parsing messages.
    """

    def __init__(self, reason: str, detail: str):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason
        self.detail = detail


# Wire format of one serialized GraphUpdate (the WAL record body):
#
#   header  "<4sBBHQI" = magic b"GUPD" | version u8 | flags u8 (reserved 0)
#                        | reserved u16 | payload_len u64 | crc32 u32
#   payload 7 x u64 field lengths (add_u, add_v, add_w, rem_u, rem_v,
#           rem_w, add_node_w) followed by the fields as little-endian
#           int64 in that order.
#
# The crc32 covers the payload only, so a truncated header, a truncated
# payload, and a bit-flipped payload are three distinguishable rejection
# reasons — the durable WAL relies on that to stop replay at the first
# torn/corrupt record instead of applying garbage.
_WIRE_MAGIC = b"GUPD"
_WIRE_VERSION = 1
_WIRE_HEADER = struct.Struct("<4sBBHQI")
_WIRE_FIELDS = ("add_u", "add_v", "add_w", "rem_u", "rem_v", "rem_w",
                "add_node_w")


def _as_ids(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int64).reshape(-1)


def _as_w(w, size: int) -> np.ndarray:
    if w is None:
        return np.ones(size, dtype=np.int64)
    w = np.asarray(w, dtype=np.float64).reshape(-1)
    if not np.all(w == np.round(w)):
        raise ValueError("update weights must be integral (int32 deltas)")
    if w.size and np.abs(w).max() >= 2**24:
        # f32 loses integer exactness at 2^24 — the bound every
        # bit-reproducibility guarantee of the subsystem rests on
        raise ValueError("update weight deltas must stay below 2^24")
    return w.astype(np.int64)


@dataclass
class GraphUpdate:
    """One batched mutation request (all arrays host numpy, int semantics).

    ``add_u/add_v/add_w`` are undirected edges whose weight is *increased*
    by ``w`` (creating the edge if absent); ``rem_u/rem_v/rem_w`` decrease
    it (an edge whose merged weight reaches zero disappears).  ``add_node_w``
    appends new nodes with the given weights; new node ids are assigned
    contiguously from the current n, so a batch may add nodes and then wire
    them up with edges in the same request.
    """

    add_u: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    add_v: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    add_w: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    rem_u: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    rem_v: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    rem_w: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    add_node_w: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    @staticmethod
    def add_edges(u, v, w=None) -> "GraphUpdate":
        u, v = _as_ids(u), _as_ids(v)
        return GraphUpdate(add_u=u, add_v=v, add_w=_as_w(w, u.shape[0]))

    @staticmethod
    def remove_edges(u, v, w=None) -> "GraphUpdate":
        u, v = _as_ids(u), _as_ids(v)
        return GraphUpdate(rem_u=u, rem_v=v, rem_w=_as_w(w, u.shape[0]))

    @staticmethod
    def add_nodes(nw) -> "GraphUpdate":
        return GraphUpdate(add_node_w=_as_w(nw, len(np.atleast_1d(nw))))

    @property
    def num_new_nodes(self) -> int:
        return int(self.add_node_w.shape[0])

    def merged(self, other: "GraphUpdate") -> "GraphUpdate":
        """Concatenate two requests into one batch (other's edges may
        reference nodes this batch adds)."""
        cat = np.concatenate
        return GraphUpdate(
            add_u=cat([self.add_u, other.add_u]),
            add_v=cat([self.add_v, other.add_v]),
            add_w=cat([self.add_w, other.add_w]),
            rem_u=cat([self.rem_u, other.rem_u]),
            rem_v=cat([self.rem_v, other.rem_v]),
            rem_w=cat([self.rem_w, other.rem_w]),
            add_node_w=cat([self.add_node_w, other.add_node_w]),
        )

    def validate(self, n_before: int) -> None:
        """Raise :class:`UpdateValidationError` unless the batch is applicable
        to a graph with ``n_before`` nodes.  Covers everything the factory
        helpers enforce (integral weights below 2^24) plus the structural
        checks (endpoint range against the post-batch node set, self loops) —
        so a request built by direct field construction is held to the same
        contract.  Pure read-only: validation never touches store state,
        which is what makes rejection atomic by construction."""
        n_after = int(n_before) + self.num_new_nodes
        for tag, arr in (
            ("add_w", self.add_w), ("rem_w", self.rem_w),
            ("add_node_w", self.add_node_w),
        ):
            a = np.asarray(arr, dtype=np.float64).reshape(-1)
            if a.size and not np.all(a == np.round(a)):
                raise UpdateValidationError(
                    "non_integral_weight", f"{tag} must be integral"
                )
            if a.size and np.abs(a).max() >= 2**24:
                raise UpdateValidationError(
                    "weight_overflow", f"{tag} must stay below 2^24"
                )
        if not (self.add_u.shape[0] == self.add_v.shape[0] == self.add_w.shape[0]):
            raise UpdateValidationError("shape_mismatch", "add arrays disagree")
        if not (self.rem_u.shape[0] == self.rem_v.shape[0] == self.rem_w.shape[0]):
            raise UpdateValidationError("shape_mismatch", "rem arrays disagree")
        u, v, _ = self.arcs()
        if u.size:
            if u.min() < 0 or v.min() < 0 or max(u.max(), v.max()) >= n_after:
                raise UpdateValidationError(
                    "endpoint_out_of_range",
                    f"edge endpoint outside [0, {n_after})",
                )
            if np.any(u == v):
                raise UpdateValidationError(
                    "self_loop", "self loops are not representable"
                )

    # ------------------------------------------------------------ wire format

    def to_bytes(self) -> bytes:
        """Serialize to the length + checksum framed wire format (the WAL
        record body).  Self-delimiting: the header carries the payload
        length, so records can be concatenated into a log and re-split
        without an outer index."""
        fields = [np.ascontiguousarray(getattr(self, f), dtype="<i8")
                  for f in _WIRE_FIELDS]
        payload = struct.pack("<7Q", *(f.size for f in fields))
        payload += b"".join(f.tobytes() for f in fields)
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        return _WIRE_HEADER.pack(
            _WIRE_MAGIC, _WIRE_VERSION, 0, 0, len(payload), crc
        ) + payload

    @staticmethod
    def wire_size(data: bytes) -> int:
        """Total record size (header + payload) of the record at the start
        of ``data``; raises :class:`UpdateValidationError` when even the
        header is torn or unrecognizable."""
        if len(data) < _WIRE_HEADER.size:
            raise UpdateValidationError(
                "wal_truncated",
                f"{len(data)} bytes < {_WIRE_HEADER.size}-byte header",
            )
        magic, ver, _, _, plen, _ = _WIRE_HEADER.unpack_from(data)
        if magic != _WIRE_MAGIC:
            raise UpdateValidationError("wal_bad_magic", repr(magic))
        if ver != _WIRE_VERSION:
            raise UpdateValidationError("wal_bad_version", str(ver))
        return _WIRE_HEADER.size + plen

    @staticmethod
    def from_bytes(data: bytes) -> "GraphUpdate":
        """Parse one record produced by :meth:`to_bytes`.

        Rejects (with :class:`UpdateValidationError`, never a partial
        object) torn headers/payloads (``wal_truncated``), foreign bytes
        (``wal_bad_magic`` / ``wal_bad_version``), bit flips anywhere in
        the payload (``wal_corrupt``, via crc32), and internally
        inconsistent field lengths (``wal_corrupt``).  Trailing bytes
        beyond the framed record are rejected too (``wal_trailing``) so a
        mis-split log cannot silently drop records."""
        total = GraphUpdate.wire_size(data)
        if len(data) < total:
            raise UpdateValidationError(
                "wal_truncated", f"{len(data)} bytes < {total}-byte record"
            )
        if len(data) > total:
            raise UpdateValidationError(
                "wal_trailing", f"{len(data) - total} bytes past the record"
            )
        _, _, _, _, plen, crc = _WIRE_HEADER.unpack_from(data)
        payload = data[_WIRE_HEADER.size:total]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise UpdateValidationError("wal_corrupt", "payload crc mismatch")
        if plen < 56:
            raise UpdateValidationError(
                "wal_corrupt", f"payload {plen} bytes < 56-byte length block"
            )
        counts = struct.unpack_from("<7Q", payload)
        if 56 + 8 * sum(counts) != plen:
            raise UpdateValidationError(
                "wal_corrupt",
                f"field lengths {counts} disagree with payload size {plen}",
            )
        out, off = {}, 56
        for name, c in zip(_WIRE_FIELDS, counts):
            out[name] = np.frombuffer(
                payload, dtype="<i8", count=c, offset=off
            ).astype(np.int64)
            off += 8 * c
        return GraphUpdate(**out)

    def arcs(self) -> tuple:
        """Symmetric signed arc deltas ``(u, v, w)`` of the batch: both arcs
        per undirected edge, ``+w`` for adds, ``-w`` for removals."""
        u = np.concatenate([self.add_u, self.add_v, self.rem_u, self.rem_v])
        v = np.concatenate([self.add_v, self.add_u, self.rem_v, self.rem_u])
        w = np.concatenate([self.add_w, self.add_w, -self.rem_w, -self.rem_w])
        return u, v, w

    def net_arcs(self, n: int) -> tuple:
        """Deduplicated net arc deltas over the batch — the batch's true
        effect.  Arcs whose adds and removals cancel vanish here, which is
        what makes a net-no-op batch leave labels bit-identical: the session
        skips repair entirely when this comes back empty."""
        u, v, w = self.arcs()
        if u.size == 0:
            return u.astype(np.int64), v.astype(np.int64), w
        key = u * np.int64(n) + v
        order = np.argsort(key, kind="stable")
        key_s, w_s = key[order], w[order]
        boundary = np.empty(key_s.shape[0], dtype=bool)
        boundary[0] = True
        boundary[1:] = key_s[1:] != key_s[:-1]
        run = np.cumsum(boundary) - 1
        net = np.zeros(int(run[-1]) + 1, dtype=np.int64)
        np.add.at(net, run, w_s)
        first = key_s[np.flatnonzero(boundary)]
        live = net != 0
        return (first[live] // n, first[live] % n, net[live])



class StoreStats(RegistryBackedStats):
    """Counters surfaced through ``PartitionSession.stats()``.  Bucket sets
    hold the reference's keys: ``(Mb, Rb, Nb)`` for merges and views,
    ``(Mb, Nb)`` for vacuums; ``compact_deferred`` counts compactions
    dispatched without waiting for their result."""

    _COUNTER_FIELDS = (
        "update_batches", "edges_added", "edges_removed",
        "nodes_added", "nodes_removed",
        "compact_calls", "compact_deferred",
        "view_calls",
        "vacuum_calls",
    )
    _SET_FIELDS = ("compact_buckets", "view_buckets", "vacuum_buckets")

    @property
    def compact_bucket_count(self) -> int:
        return len(self.compact_buckets)

    @property
    def view_bucket_count(self) -> int:
        return len(self.view_buckets)

    @property
    def vacuum_bucket_count(self) -> int:
        return len(self.vacuum_buckets)


def _runs(key: torch.Tensor, valid: torch.Tensor):
    """Run segmentation of the valid entries of an int64 key.

    Returns ``(run_of, run_key, nrun)``: each entry's run id in sorted key
    order (``T`` for invalid entries), each run's key (an arbitrary value
    past ``nrun``) and the run count as a tensor.  Invalid entries sort
    last under a sentinel key."""
    T = key.shape[0]
    big = torch.iinfo(torch.int64).max
    ks, order = torch.sort(torch.where(valid, key, big), stable=True)
    oks = ks < big
    first = oks.clone()
    first[1:] &= ks[1:] != ks[:-1]
    run = torch.cumsum(first, 0) - 1
    run_of = torch.empty_like(run).scatter_(0, order, run)
    run_of = torch.where(valid, run_of, T)
    # spare slot T takes every non-first entry and is cut off
    run_key = torch.zeros(T + 1, dtype=torch.int64, device=key.device)
    run_key.scatter_(0, torch.where(first, run, T), ks)
    return run_of, run_key[:T], first.sum()


def _sum_runs(run_of: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-run weight sums; entries with run id ``T`` go to a dropped slot."""
    T = run_of.shape[0]
    out = torch.zeros(T + 1, dtype=torch.float32, device=w.device)
    return out.index_add_(0, run_of, w)[:T]


def _scatter_set(L: int, idx: torch.Tensor, val: torch.Tensor,
                 base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``zeros(L).at[idx].set(val, mode="drop")`` for ``idx`` in ``[0, L]``:
    index ``L`` is a spare slot that is cut off."""
    if base is None:
        base = torch.zeros(L + 1, dtype=val.dtype, device=val.device)
    return base.scatter_(0, idx, val)


def merge_overlay_device(src, dst, ew, ou, ov, ow, nw, n: int, m: int, r: int):
    """Fold a COO delta overlay into a CSR on the device.

    Args:
      src, dst, ew: ``(Mb,)`` base arcs; entries >= ``m`` are inert padding.
      ou, ov, ow: ``(Rb,)`` overlay arc deltas (symmetric, signed, integral
        float32); entries >= ``r`` are inert padding.
      nw: ``(Nb,)`` node weights of the post-update node set (0 beyond n).

    Returns ``(indptr, src, dst, ew, m_new, nw_max, ew_max)``, all on the
    device (``Mb + Rb`` arc slots, the last three 0-d tensors): the merged
    CSR in ``(u, v)`` order — what ``from_edges`` would emit for the merged
    edge list — with edges whose merged weight is <= 0 dropped (removal
    saturates) and GraphDev padding invariants restored.
    """
    dev = src.device
    Mb, Rb, Nb = src.shape[0], ou.shape[0], nw.shape[0]
    T = Mb + Rb
    iota = torch.arange(T, dtype=torch.int64, device=dev)
    u = torch.cat([src, ou])
    v = torch.cat([dst, ov])
    w = torch.cat([ew, ow])
    valid = torch.cat([iota[:Mb] < m, iota[:Rb] < r])
    run_of, run_key, nrun = _runs(u * Nb + v, valid)
    rw = _sum_runs(run_of, torch.where(valid, w, 0.0))
    # drop runs whose merged weight hit zero (removed edges); kept runs stay
    # in (u, v) key order, so a rank scatter IS the compaction
    keep = (iota < nrun) & (rw > 0.0)
    kpos = torch.where(keep, torch.cumsum(keep, 0) - 1, T)
    m_new = keep.sum()
    src_c = _scatter_set(T, kpos, run_key // Nb)[:T]
    dst_c = _scatter_set(T, kpos, run_key % Nb)[:T]
    ew_c = _scatter_set(T, kpos, rw)[:T]
    cu_sorted = torch.where(iota < m_new, src_c, Nb)
    indptr_c = torch.searchsorted(
        cu_sorted, torch.arange(Nb + 1, dtype=torch.int64, device=dev)
    )
    return indptr_c, src_c, dst_c, ew_c, m_new, nw.max(), ew_c.max()


def overlay_view_device(indptr, src, dst, ew, ou, ov, ow, n: int, m: int, r: int):
    """Merged-adjacency view of (base CSR + COO overlay) without the merge
    sort.

    The overlay alone is deduplicated (an O(r log r) sort); each net delta
    is matched into its base row by a vectorized 32-step binary search
    (rows are v-sorted), matched weights are patched, dead arcs (merged
    weight <= 0) are compacted out by a rank scatter, and new arcs go to
    the tail of their source row.

    Returns ``(indptr_v, src_v, dst_v, ew_v, m_view)`` over ``Mb + Rb`` arc
    slots: rows, degrees and weighted arc multisets equal the compacted
    merge's exactly; only the within-row order differs, to which every
    repair consumer is insensitive.
    """
    dev = src.device
    Mb, Rb = src.shape[0], ou.shape[0]
    Nb = indptr.shape[0] - 1
    Mv = Mb + Rb
    iota_r = torch.arange(Rb, dtype=torch.int64, device=dev)
    iota_m = torch.arange(Mb, dtype=torch.int64, device=dev)
    valid_o = iota_r < r
    # ---- dedup the overlay: net signed delta per distinct (u, v) ----
    run_of, uk, nrun = _runs(ou * Nb + ov, valid_o)
    dw = _sum_runs(run_of, torch.where(valid_o, ow, 0.0))
    run_live = iota_r < nrun
    du = torch.where(run_live, uk // Nb, 0)
    dv = torch.where(run_live, uk % Nb, 0)
    # ---- match each net delta into its base row (vectorized bisect) ----
    lo = indptr[du]
    row_end = indptr[du + 1]
    hi = row_end
    for _ in range(32):
        mid = (lo + hi) >> 1
        ltv = dst[torch.clamp(mid, 0, Mb - 1)] < dv
        cont = lo < hi
        lo, hi = (torch.where(cont & ltv, mid + 1, lo),
                  torch.where(cont & ~ltv, mid, hi))
    found = run_live & (lo < row_end) & (dst[torch.clamp(lo, 0, Mb - 1)] == dv)
    # ---- patch matched weights; the merge's saturating drop semantics
    # (a merged weight <= 0 removes the arc) ----
    idx = torch.where(found, lo, Mb)
    ew_eff = torch.cat([ew, ew.new_zeros(1)]).index_add_(
        0, idx, torch.where(found, dw, 0.0))[:Mb]
    in_m = iota_m < m
    arc_live = in_m & (ew_eff > 0.0)
    dead = in_m & ~arc_live
    src_s = torch.where(in_m, src, 0)
    dst_s = torch.where(in_m, dst, 0)
    dead_cnt = torch.zeros(Nb, dtype=torch.int64, device=dev).index_add_(
        0, src_s, dead.to(torch.int64))
    is_new = run_live & ~found & (dw > 0.0)
    new_cnt = torch.zeros(Nb, dtype=torch.int64, device=dev).index_add_(
        0, du, is_new.to(torch.int64))
    # ---- merged row pointers: survivors first, new arcs at the tail ----
    deg_live = (indptr[1:] - indptr[:-1]) - dead_cnt
    cum_view = torch.cumsum(deg_live + new_cnt, 0)
    zero1 = cum_view.new_zeros(1)
    indptr_v = torch.cat([zero1, cum_view])
    live_before = torch.cat([zero1, torch.cumsum(deg_live, 0)])[:-1]
    new_before = torch.cat([zero1, torch.cumsum(new_cnt, 0)])[:-1]
    gr = torch.cumsum(arc_live, 0) - 1
    pos_base = indptr_v[src_s] + (gr - live_before[src_s])
    gn = torch.cumsum(is_new, 0) - 1
    pos_new = indptr_v[du] + deg_live[du] + (gn - new_before[du])
    tb = torch.where(arc_live, pos_base, Mv)
    tn = torch.where(is_new, pos_new, Mv)
    # padding arcs stay (0, 0, 0.0), the inertness every arc consumer needs
    src_v = _scatter_set(Mv, tn, du, _scatter_set(Mv, tb, src_s))[:Mv]
    dst_v = _scatter_set(Mv, tn, dv, _scatter_set(Mv, tb, dst_s))[:Mv]
    ew_v = _scatter_set(Mv, tn, torch.where(is_new, dw, 0.0),
                        _scatter_set(Mv, tb, torch.where(arc_live, ew_eff, 0.0)))[:Mv]
    return indptr_v, src_v, dst_v, ew_v, cum_view[-1]


def vacuum_device(src, dst, ew, newid, keep, nw, m: int):
    """Relabel-on-compact: rewrite arcs through ``newid`` and drop
    tombstoned rows.

    ``newid`` (``(Nb,)`` int64, ``cumsum(keep) - 1`` clipped at 0) must be
    monotone on kept ids, so within-row and global ``(u, v)`` order survive
    the remap; no arc may touch a tombstoned node.  Returns ``(indptr, src,
    dst, ew, nw)`` in the new id space, in the input's buckets.
    """
    dev = src.device
    Mb, Nb = src.shape[0], newid.shape[0]
    arc_ok = torch.arange(Mb, dtype=torch.int64, device=dev) < m
    src_r = torch.where(arc_ok, newid[torch.where(arc_ok, src, 0)], 0)
    dst_r = torch.where(arc_ok, newid[torch.where(arc_ok, dst, 0)], 0)
    ew_r = torch.where(arc_ok, ew, 0.0)
    cu = torch.where(arc_ok, src_r, Nb)
    indptr_r = torch.searchsorted(
        cu, torch.arange(Nb + 1, dtype=torch.int64, device=dev))
    nw_r = torch.zeros(Nb + 1, dtype=torch.float32, device=dev).index_add_(
        0, torch.where(keep, newid, Nb), torch.where(keep, nw, 0.0))[:Nb]
    return indptr_r, src_r, dst_r, ew_r, nw_r


class DynamicGraphStore:
    """Device-resident base CSR + bounded COO delta overlay.

    ``apply`` appends update batches to the overlay (O(batch) host work, no
    device work); ``compact`` merges the overlay into a fresh
    :class:`GraphDev` base; ``graph()`` hands out the up-to-date handle,
    compacting first when dirty.  The overlay is bounded by ``overlay_cap``
    arcs; exceeding it compacts automatically.  Runs on ``device`` (CUDA
    unless the caller names another).
    """

    def __init__(
        self,
        g: GraphNP,
        *,
        overlay_cap: int = 1 << 16,
        on_h2d: Optional[Callable[[int], None]] = None,
        on_d2h: Optional[Callable[[int], None]] = None,
        registry: Optional[MetricsRegistry] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        if g.m and not bool(np.all(g.ew == np.round(g.ew))):
            raise ValueError("dynamic store requires integral edge weights")
        if g.m and float(g.ew.max()) >= 2**24:
            raise ValueError("edge weights must stay below 2^24 (f32-exact)")
        self._on_h2d = on_h2d or (lambda b: None)
        self._on_d2h = on_d2h or (lambda b: None)
        self.overlay_cap = int(overlay_cap)
        self.stats = StoreStats(registry)
        self.n = g.n
        self._nw = g.nw.astype(np.float64).copy()   # host mirror, authoritative
        self.base: GraphDev = to_device_csr(
            g, self.device, on_materialize=self._on_d2h
        )
        self._on_h2d(sum(int(t.numel() * t.element_size()) for t in (
            self.base.indptr, self.base.indices, self.base.ew, self.base.nw,
            self.base.src)))
        self._nw_dev: Optional[torch.Tensor] = self.base.nw  # survives compacts
        self._ou: List[np.ndarray] = []
        self._ov: List[np.ndarray] = []
        self._ow: List[np.ndarray] = []
        self._olen = 0
        self._pending: Optional[dict] = None    # in-flight deferred merge
        self._tomb: Optional[np.ndarray] = None  # (n,) bool tombstone column
        self.last_vacuum_map: Optional[np.ndarray] = None

    # ------------------------------------------------------------- properties

    @property
    def m(self) -> int:
        """Arc count of the last compacted base (overlay arcs not included
        until ``compact``)."""
        return self.base.m

    @property
    def overlay_len(self) -> int:
        return self._olen

    @property
    def dirty(self) -> bool:
        return self._olen > 0

    @property
    def compact_pending(self) -> bool:
        """A deferred compaction has been dispatched but not finalized."""
        return self._pending is not None

    @property
    def pending_removals(self) -> int:
        """Tombstoned nodes awaiting the relabel-on-compact vacuum."""
        return 0 if self._tomb is None else int(self._tomb.sum())

    @property
    def total_node_weight(self) -> float:
        return float(self._nw.sum())

    def node_weights(self) -> np.ndarray:
        return self._nw

    # ---------------------------------------------------------------- updates

    def apply(self, upd: GraphUpdate) -> None:
        """Append one batch: new nodes first (ids from the current n), then
        the batch's symmetric arc deltas into the overlay.  The whole batch
        is validated up front, so a rejected request leaves the store
        untouched."""
        upd.validate(self.n)
        u, v, w = upd.arcs()
        n_after = self.n + upd.num_new_nodes
        if upd.num_new_nodes:
            self._nw = np.concatenate(
                [self._nw, upd.add_node_w.astype(np.float64)]
            )
            self.n = n_after
            self.stats.nodes_added += upd.num_new_nodes
            self._nw_dev = None         # device mirror is stale
        if u.size:
            self._ou.append(u.astype(np.int64))
            self._ov.append(v.astype(np.int64))
            self._ow.append(w.astype(np.float32))
            self._olen += u.size
        self.stats.update_batches += 1
        self.stats.edges_added += int(upd.add_u.shape[0])
        self.stats.edges_removed += int(upd.rem_u.shape[0])
        if self._olen > self.overlay_cap:
            self.compact()

    def add_edges(self, u, v, w=None) -> None:
        self.apply(GraphUpdate.add_edges(u, v, w))

    def remove_edges(self, u, v, w=None) -> None:
        self.apply(GraphUpdate.remove_edges(u, v, w))

    def add_nodes(self, nw) -> None:
        self.apply(GraphUpdate.add_nodes(nw))

    # ------------------------------------------------------------- compaction

    def _upload_overlay(self, Rb: int) -> tuple:
        """The overlay chunk lists as Rb-padded COO tensors on the device
        (shared by the merge and the view)."""
        ou = np.zeros(Rb, np.int64)
        ov = np.zeros(Rb, np.int64)
        ow = np.zeros(Rb, np.float32)
        o = 0
        for cu, cv, cw in zip(self._ou, self._ov, self._ow):
            ou[o : o + cu.size] = cu
            ov[o : o + cu.size] = cv
            ow[o : o + cu.size] = cw
            o += cu.size
        self._on_h2d(Rb * 12)
        return tuple(torch.from_numpy(a).to(self.device) for a in (ou, ov, ow))

    def _dispatch_merge(self) -> None:
        """Launch the overlay merge WITHOUT reading its result.  Its outputs
        and the consumed overlay prefix park in ``_pending`` until
        :meth:`_finalize_pending` reads the three result scalars and swaps
        the base — the card runs the merge while the host goes on."""
        self.stats.compact_calls += 1
        r = self._olen
        Rb = pow2(max(r, 8))
        Nb = pow2(max(self.n, 8))
        # node weights re-upload only after node churn (edge-only streams
        # reuse the resident tensor across compactions)
        if self._nw_dev is None or self._nw_dev.shape[0] != Nb:
            nw = np.zeros(Nb, np.float32)
            nw[: self.n] = self._nw
            self._nw_dev = torch.from_numpy(nw).to(self.device)
            _mem_account("base_csr", self._nw_dev)
            self._on_h2d(nw.nbytes)
        ou, ov, ow = self._upload_overlay(Rb)
        _mem_account("overlay_chunks", ou, ov, ow)
        Mb = self.base.indices.shape[0]
        note_new(self.stats.compact_buckets, "store.compact", (Mb, Rb, Nb))
        # no sync_on: a deferred merge must stay asynchronous under tracing
        # too, so the span covers the launches, not the card's completion
        with _obs_span(
            "store.compact", cat="store", overlay=int(r), m=int(self.base.m)
        ):
            res = merge_overlay_device(
                self.base.src, self.base.indices, self.base.ew,
                ou, ov, ow, self._nw_dev, self.n, self.base.m, r,
            )
            _mem_account("base_csr", *res[:4])  # in-flight merge outputs
        self._pending = dict(
            res=res, r=r, nchunks=len(self._ou), n=self.n,
            nw_dev=self._nw_dev,
        )

    def _finalize_pending(self) -> bool:
        """Wait for a dispatched merge and install its result as the base.

        Returns False (discarding the result) when the node set changed
        since dispatch, so the caller re-compacts synchronously.  Overlay
        chunks consumed by the merge are dropped only here, so snapshots and
        views taken while it ran see (old base + full overlay), an
        equivalent graph."""
        p = self._pending
        self._pending = None
        if p is None:
            return False
        if p["n"] != self.n or p["nw_dev"] is not self._nw_dev:
            return False
        indptr, src_c, dst_c, ew_c, m_new, nwmax, ewmax = p["res"]
        m_new, nwmax, ewmax = torch.stack(
            [m_new.double(), nwmax.double(), ewmax.double()]
        ).cpu().tolist()
        m_new = int(m_new)
        self._on_d2h(12)
        if float(ewmax) >= 2**24:
            # the first merge whose sums could round in f32: refuse rather
            # than silently break the exact-merge contract
            raise ValueError(
                "merged edge weight reached 2^24 — f32 exactness lost"
            )
        Mcb = arc_bucket(m_new)

        def fit(a, L):
            if a.shape[0] >= L:
                return a[:L]
            return torch.cat([a, a.new_zeros(L - a.shape[0])])

        self.base = GraphDev(
            indptr=indptr,
            indices=fit(dst_c, Mcb),
            ew=fit(ew_c, Mcb),
            nw=self._nw_dev,
            src=fit(src_c, Mcb),
            n=self.n, m=m_new,
            nw_max=float(nwmax), ew_max=float(ewmax), ew_integral=True,
            on_materialize=self._on_d2h,
        )
        self._ou = self._ou[p["nchunks"]:]
        self._ov = self._ov[p["nchunks"]:]
        self._ow = self._ow[p["nchunks"]:]
        self._olen -= p["r"]
        return True

    def compact(self, deferred: bool = False) -> GraphDev:
        """Merge the overlay into a fresh base CSR (no-op when clean); only
        the ``(m_new, nw_max, ew_max)`` scalars cross to the host.  The
        previous base handle is dropped: callers caching device state
        against its identity must evict (the session does).

        ``deferred=True`` launches the merge and returns with the OLD base
        still installed (the overlay stays queued, so views and snapshots
        stay right); the swap happens at the next ``compact()``/``graph()``.
        Deferral needs a stable node set."""
        if self._pending is not None and self._finalize_pending():
            if not self.dirty and self.n == self.base.n:
                return self.base
        if not self.dirty and self.n == self.base.n:
            return self.base
        if deferred and self.n == self.base.n and self.dirty:
            self._dispatch_merge()
            self.stats.compact_deferred += 1
            return self.base
        self._dispatch_merge()
        self._finalize_pending()
        return self.base

    # ------------------------------------------------------------ overlay view

    def can_view(self) -> bool:
        """True when :meth:`view` can serve the current state: pending arc
        deltas only (a stable node set, no tombstones awaiting vacuum) and a
        node bucket under the reference's fused-int32-key gate
        ``Nb * Nb < 2**31``.  The port's int64 keys do not need that gate;
        it is kept so the same steps take the view path in both packages."""
        Nb = self.base.indptr.shape[0] - 1
        return (
            self.dirty
            and self.n == self.base.n
            and self.pending_removals == 0
            and Nb * Nb < 2**31
        )

    def overlay_fraction(self) -> float:
        """Pending overlay arcs as a fraction of the base arc count — what
        the session's ``compact_fraction`` policy thresholds on."""
        return self._olen / max(self.base.m, 1)

    def view(self) -> tuple:
        """Merged-adjacency device view of (base + overlay) WITHOUT
        compacting: ``(indptr, src, dst, ew, m_view)`` over ``Mb + Rb`` arc
        slots (see :func:`overlay_view_device`); the base handle and every
        cache keyed on it survive.  Requires :meth:`can_view`."""
        if not self.can_view():
            raise ValueError("store state not viewable (see can_view)")
        self.stats.view_calls += 1
        r = self._olen
        Rb = pow2(max(r, 8))
        Mb = self.base.indices.shape[0]
        Nb = self.base.indptr.shape[0] - 1
        note_new(self.stats.view_buckets, "store.view", (Mb, Rb, Nb))
        ou, ov, ow = self._upload_overlay(Rb)
        _mem_account("overlay_chunks", ou, ov, ow)
        with _obs_span(
            "store.view", cat="store", overlay=int(r), m=int(self.base.m)
        ) as sp:
            out = overlay_view_device(
                self.base.indptr, self.base.src, self.base.indices,
                self.base.ew, ou, ov, ow, self.n, self.base.m, r,
            )
            sp.sync_on(out[0])
        _mem_account("overlay_chunks", *out[:4])
        return out

    def graph(self) -> GraphDev:
        """The up-to-date device graph: finalizes an in-flight deferred
        merge, compacts when the overlay holds arcs or nodes were added
        since the last compaction, then vacuums pending tombstones (see
        ``last_vacuum_map`` for the id remap)."""
        if self.dirty or self.n != self.base.n or self._pending is not None:
            self.compact()
        if self.pending_removals:
            self.vacuum()
        return self.base

    def csr_host(self) -> GraphNP:
        """Host CSR of the CURRENT graph (compacts, then materializes; the
        base handle caches it, and the first base is the host graph)."""
        return self.graph().to_host()

    # ------------------------------------------------------------- tombstones

    def remove_nodes(self, ids) -> None:
        """Tombstone *isolated* nodes for removal (disconnect them first with
        ``remove_edges``); the ids leave the CSR, and the id space re-packs,
        at the next vacuum (:meth:`graph` runs one)."""
        ids = np.unique(np.asarray(ids, dtype=np.int64))
        if ids.size == 0:
            return
        if ids.min() < 0 or ids.max() >= self.n:
            raise UpdateValidationError(
                "endpoint_out_of_range", f"node id outside [0, {self.n})"
            )
        # degrees are judged on the MERGED graph
        if self.dirty or self.n != self.base.n or self._pending is not None:
            self.compact()
        ii = torch.from_numpy(ids).to(self.device)
        self._on_h2d(ids.size * 4)
        ip = self.base.indptr
        deg = (ip[ii + 1] - ip[ii]).cpu().numpy().astype(np.int64)
        self._on_d2h(deg.nbytes // 2)
        if np.any(deg > 0):
            bad = ids[deg > 0][0]
            raise UpdateValidationError(
                "node_not_isolated",
                f"node {bad} still has degree {int(deg[deg > 0][0])}",
            )
        if self._tomb is None:
            self._tomb = np.zeros(self.n, dtype=bool)
        if np.any(self._tomb[ids]):
            raise UpdateValidationError(
                "node_already_removed", "duplicate tombstone"
            )
        self._tomb[ids] = True
        self.stats.nodes_removed += ids.size

    def vacuum(self) -> Optional[np.ndarray]:
        """Relabel-on-compact: drop tombstoned rows from the base CSR on the
        device and re-pack node ids contiguously.

        Returns the old -> new id map ((old_n,) int64, -1 for removed nodes;
        also kept as ``last_vacuum_map``), or None when nothing is pending.
        Arcs survive bit for bit under the monotone remap; buckets are
        reused."""
        if self.pending_removals == 0:
            return None
        if self.dirty or self.n != self.base.n or self._pending is not None:
            self.compact()
        self.stats.vacuum_calls += 1
        n_old = self.n
        keep_h = ~self._tomb
        newid_h = np.cumsum(keep_h) - 1
        mapping = np.where(keep_h, newid_h, -1).astype(np.int64)
        n_new = int(keep_h.sum())
        Mb = self.base.indices.shape[0]
        Nb = self.base.indptr.shape[0] - 1
        note_new(self.stats.vacuum_buckets, "store.vacuum", (Mb, Nb))
        newid = np.zeros(Nb, np.int64)
        newid[:n_old] = np.maximum(newid_h, 0)
        keep = np.zeros(Nb, bool)
        keep[:n_old] = keep_h
        self._on_h2d(Nb * 5)
        newid_d = torch.from_numpy(newid).to(self.device)
        keep_d = torch.from_numpy(keep).to(self.device)
        _mem_account("base_csr", newid_d, keep_d)
        with _obs_span(
            "store.vacuum", cat="store", removed=int(n_old - n_new)
        ) as sp:
            indptr_r, src_r, dst_r, ew_r, nw_r = vacuum_device(
                self.base.src, self.base.indices, self.base.ew,
                newid_d, keep_d, self.base.nw, self.base.m,
            )
            sp.sync_on(nw_r)
        self._nw = self._nw[keep_h]
        self._nw_dev = nw_r
        self.base = GraphDev(
            indptr=indptr_r, indices=dst_r, ew=ew_r, nw=nw_r, src=src_r,
            n=n_new, m=self.base.m,
            nw_max=float(self._nw.max()) if n_new else 0.0,
            ew_max=self.base.ew_max, ew_integral=True,
            on_materialize=self._on_d2h,
        )
        self.n = n_new
        self._tomb = None
        self.last_vacuum_map = mapping
        return mapping

    # ------------------------------------------------------- snapshot support

    def snapshot_state(self) -> dict:
        """O(overlay-chunks) structural snapshot of the store's graph state.

        Payloads are captured *by reference*.  That is sound because nothing
        in the serving code writes into them: a base's tensors are only ever
        replaced by new ones (merge, vacuum), ``_nw``/``_nw_dev`` are
        rebound, never written, and overlay chunks are appended, never
        mutated — so only the chunk *lists* and the tombstone column are
        copied.  Counters are monitoring state and are not captured."""
        return dict(
            n=self.n,
            base=self.base,
            nw=self._nw,
            nw_dev=self._nw_dev,
            ou=list(self._ou),
            ov=list(self._ov),
            ow=list(self._ow),
            olen=self._olen,
            tomb=None if self._tomb is None else self._tomb.copy(),
        )

    def restore_state(self, st: dict) -> None:
        """Rebind graph state to a :meth:`snapshot_state` capture.  An
        in-flight deferred merge is discarded (its bookkeeping refers to the
        pre-restore chunk lists)."""
        self._pending = None
        self.n = st["n"]
        self.base = st["base"]
        self._nw = st["nw"]
        self._nw_dev = st["nw_dev"]
        self._ou = list(st["ou"])
        self._ov = list(st["ov"])
        self._ow = list(st["ow"])
        self._olen = st["olen"]
        tomb = st.get("tomb")
        self._tomb = None if tomb is None else tomb.copy()
