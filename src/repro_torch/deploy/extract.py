"""Device-resident block shard extraction (deployment subsystem, layer 1) —
the torch twin of ``repro.deploy.extract``.

A partition is consumed as one PE-local subgraph per block, with ghost
copies of remote neighbours and a fixed interface-exchange schedule.  This
module turns a resident CSR (:class:`~repro_torch.graph.csr.GraphDev`, e.g.
the dynamic store's base) and a label tensor into one :class:`BlockShard`
per block, on the device:

* **h-ring halo** — a multi-source BFS layering per block
  (:func:`_shard_masks`: one frontier scatter per ring over the resident
  arc arrays) assigns every node its hop distance from the block; ring
  ``r`` ghosts are the nodes at distance ``r`` in ``[1, h]``.
* **local id space** — owned nodes first (ascending global id), then ghosts
  ring by ring (ascending global id within a ring): one stable sort plus a
  scatter-rank relabel.  Rows ``[0, n_rows)`` with ``n_rows = #{hop < h}``
  (owned + interior ghosts) carry adjacency, so h-hop computations rooted
  at owned nodes never leave the shard.
* **block-local CSR** — the O(m) edge fill is
  :func:`~repro_torch.graph.packing.gather_pack_device` over a one-row
  layout, followed by the global→local head remap.  Padding follows the
  GraphDev invariants (rows >= n_rows hold ``m_local``, arcs >= m_local are
  0/0).
* **exchange schedule** — ghosts carry their owning block; the cross-block
  (owner, slot) maps and per-neighbour send lists are assembled on the host
  from the O(boundary) id lists (:func:`assemble_schedule`).

Only the ``(n_own, n_ghost, n_rows, m_local)`` scalars cross to the host per
block; output shapes follow sticky ``(Ob, Gb, Eb)`` buckets, as in the
reference, so padded shapes agree with it.  The host oracle
:func:`extract_blocks_numpy` is bit-identical to the device path, and
:func:`reassemble` glues the owned rows of all shards back into the exact
global CSR.  Device index tensors are int64; :meth:`BlockShard.host` hands
out the reference's dtypes (int32 ids, int64 ``indptr``, float32 weights).
No function here writes into a tensor it did not just allocate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..graph.csr import GraphDev, GraphNP, arc_bucket, pow2, to_device_csr
from ..graph.packing import gather_pack_device
from ..obs import RegistryBackedStats
from ..obs.memory import account as _mem_account
from ..obs.watchdog import note_new

__all__ = [
    "BlockShard",
    "BlockShardNP",
    "BlockExtractor",
    "DeployStats",
    "assemble_schedule",
    "extract_blocks_numpy",
    "ghost_exchange_numpy",
    "reassemble",
]

AnyGraph = Union[GraphNP, GraphDev]

_BIG = 0x7FFFFFF  # hop sentinel: outside the halo (> any real h)


# --------------------------------------------------------------------------
# device programs
# --------------------------------------------------------------------------


def _shard_masks(lab, src, dst, indptr, b: int, n: int, h: int):
    """Hop layering + shard size counts for block ``b``.

    Returns ``(hop, counts)``: hop 0 = owned, ``r in [1, h]`` = ring-r
    ghost, ``_BIG`` = outside; ``counts`` is the ``(4,)`` tensor
    ``(n_own, n_ghost, n_rows, m_local)``.  Trailing padding arcs are
    (0, 0) and only ever re-mark node 0 from itself — inert.
    """
    Nb = indptr.shape[0] - 1
    iota = torch.arange(Nb, device=lab.device)
    own = (lab == b) & (iota < n)
    hop = torch.where(own, 0, _BIG)
    for r in range(h):
        # reach[dst] = max(reach[dst], hop[src] <= r): the ring scatter
        reach = torch.zeros(Nb, dtype=torch.int32, device=lab.device).scatter_reduce(
            0, dst, (hop[src] <= r).to(torch.int32), "amax", include_self=True
        )
        hop = torch.where((reach > 0) & (hop > r + 1), r + 1, hop)
    deg = torch.where(iota < n, indptr[1:] - indptr[:-1], 0)
    is_ghost = (hop >= 1) & (hop <= h)
    is_row = hop < h  # owned + interior ghosts: full adjacency in-shard
    counts = torch.stack([
        own.sum(), is_ghost.sum(), is_row.sum(),
        torch.where(is_row, deg, 0).sum(),
    ])
    return hop, counts


def _shard_extract(hop, lab, indptr, indices, ew, nw, n: int, h: int,
                   n_own: int, n_ghost: int, n_rows: int, *, Ob: int,
                   Gb: int, Eb: int):
    """The shard materialization, bucket-padded to ``(Ob, Gb, Eb)``.

    Stable layout sort on the ``(own=0, ring, outside=BIG)`` key + a
    scatter-rank relabel give the local id space; the edge fill is a
    one-row :func:`~repro_torch.graph.packing.gather_pack_device` call
    followed by the global→local head remap.  Padding uses the inert
    sentinels (ids ``n``, hop/weight 0, ghost block -1).
    """
    dev = hop.device
    Nb = indptr.shape[0] - 1
    iota = torch.arange(Nb, device=dev)
    key = torch.where(
        hop == 0, 0, torch.where((hop >= 1) & (hop <= h), hop, _BIG)
    )
    perm = torch.sort(key, stable=True).indices
    loc = torch.empty(Nb, dtype=torch.int64, device=dev).scatter_(0, perm, iota)

    own_valid = torch.arange(Ob, device=dev) < n_own
    own_g = torch.where(own_valid, perm[:Ob], n)
    # ghosts start at rank n_own; the pad keeps the slice inside the array
    # when n_own + Gb > Nb
    perm_ext = torch.cat([perm, perm.new_full((Gb,), Nb)])
    ghost_valid = torch.arange(Gb, device=dev) < n_ghost
    ghost_g = torch.where(ghost_valid, perm_ext[n_own : n_own + Gb], n)
    gclamp = torch.clamp(ghost_g, max=Nb - 1)
    ghost_hop = torch.where(ghost_valid, hop[gclamp], 0)
    ghost_block = torch.where(ghost_valid, lab[gclamp], -1)
    ghost_nw = torch.where(ghost_valid, nw[gclamp], 0.0)
    nw_own = torch.where(own_valid, nw[torch.clamp(own_g, max=Nb - 1)], 0.0)

    # rows = the first n_rows ranks (owned + interior ghosts)
    Rb = Ob + Gb
    row_valid = (torch.arange(Rb, device=dev) < n_rows)[None, :]
    rows = torch.where(row_valid[0], perm_ext[:Rb], n)[None, :]
    edge_dst, edge_w, _, edge_valid = gather_pack_device(
        rows, row_valid, indptr, indices, ew, n, E=Eb
    )
    heads = torch.where(
        edge_valid[0], loc[torch.clamp(edge_dst[0], max=Nb - 1)], 0
    )
    rows_c = torch.clamp(rows[0], max=Nb - 1)
    deg = torch.where(row_valid[0], indptr[rows_c + 1] - indptr[rows_c], 0)
    indptr_loc = torch.cat([deg.new_zeros(1), torch.cumsum(deg, 0)])
    return (own_g, ghost_g, ghost_hop, ghost_block, nw_own, ghost_nw,
            indptr_loc, heads, edge_w[0])


# --------------------------------------------------------------------------
# shard containers
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockShardNP:
    """Host view of one deployed block (exact live arrays, no padding).

    Local id space: ``[0, n_own)`` owned nodes (ascending global id),
    ``[n_own, n_own + n_ghost)`` ghosts ordered by (ring, global id).
    Rows ``[0, n_rows)`` of the local CSR carry adjacency (heads in local
    id space); ``n_rows == n_own`` at halo depth 1.
    """

    block: int
    halo: int
    n_own: int
    n_ghost: int
    n_rows: int
    m_local: int
    own_global: np.ndarray    # (n_own,) int32, ascending
    ghost_global: np.ndarray  # (n_ghost,) int32, (ring, id) order
    ghost_hop: np.ndarray     # (n_ghost,) int32 in [1, halo]
    ghost_block: np.ndarray   # (n_ghost,) int32 owning block
    nw: np.ndarray            # (n_own,) f32
    ghost_nw: np.ndarray      # (n_ghost,) f32
    indptr: np.ndarray        # (n_rows + 1,) int64
    indices: np.ndarray       # (m_local,) int32, local heads
    ew: np.ndarray            # (m_local,) f32
    # exchange schedule (assemble_schedule)
    ghost_slot: Optional[np.ndarray] = None   # (n_ghost,) slot in owner buf
    iface_global: Optional[np.ndarray] = None  # (n_iface,) slot order
    iface_local: Optional[np.ndarray] = None   # (n_iface,) owned local ids
    send_blocks: Optional[np.ndarray] = None   # (n_nbr,) neighbour blocks
    send_ptr: Optional[np.ndarray] = None      # (n_nbr + 1,) int64
    send_local: Optional[np.ndarray] = None    # owned local ids per nbr

    @property
    def local_global(self) -> np.ndarray:
        """(n_own + n_ghost,) local id -> global id."""
        return np.concatenate([self.own_global, self.ghost_global])


def _np(t: torch.Tensor, dtype) -> np.ndarray:
    """A host copy (never a view of the tensor's storage)."""
    return t.cpu().numpy().astype(dtype)


@dataclass
class BlockShard:
    """Device-resident deployed block: bucket-padded tensors + live counts.

    Tensors follow the GraphDev padding invariants (ids pad with the global
    ``n`` sentinel, rows >= n_rows hold ``m_local``, arcs >= m_local are
    0-weight); the exchange-schedule fields are host numpy, assembled
    cross-block by :func:`assemble_schedule`.  ``host()`` materializes the
    exact :class:`BlockShardNP` view lazily (cached).  Fault injection and
    every other writer REBIND a field to a new tensor, never write into
    one, so a copy made with ``dataclasses.replace`` stays intact.
    """

    block: int
    halo: int
    n_own: int
    n_ghost: int
    n_rows: int
    m_local: int
    own_g: torch.Tensor
    ghost_g: torch.Tensor
    ghost_hop: torch.Tensor
    ghost_block_dev: torch.Tensor
    nw: torch.Tensor
    ghost_nw: torch.Tensor
    indptr: torch.Tensor
    indices: torch.Tensor
    ew: torch.Tensor
    on_materialize: Optional[Callable[[int], None]] = None
    ghost_slot: Optional[np.ndarray] = None
    iface_global: Optional[np.ndarray] = None
    iface_local: Optional[np.ndarray] = None
    send_blocks: Optional[np.ndarray] = None
    send_ptr: Optional[np.ndarray] = None
    send_local: Optional[np.ndarray] = None
    _own_np: Optional[np.ndarray] = field(default=None, repr=False)
    _ghost_np: Optional[np.ndarray] = field(default=None, repr=False)
    _gblock_np: Optional[np.ndarray] = field(default=None, repr=False)
    _host: Optional[BlockShardNP] = field(default=None, repr=False)

    def _note(self, nbytes: int) -> None:
        if self.on_materialize is not None:
            self.on_materialize(int(nbytes))

    def own_global_np(self) -> np.ndarray:
        """Owned global ids (the O(n_own) schedule-planning download)."""
        if self._own_np is None:
            self._own_np = _np(self.own_g[: self.n_own], np.int32)
            self._note(self._own_np.nbytes)
        return self._own_np

    def ghost_global_np(self) -> np.ndarray:
        if self._ghost_np is None:
            self._ghost_np = _np(self.ghost_g[: self.n_ghost], np.int32)
            self._note(self._ghost_np.nbytes)
        return self._ghost_np

    def ghost_block_np(self) -> np.ndarray:
        if self._gblock_np is None:
            self._gblock_np = _np(self.ghost_block_dev[: self.n_ghost], np.int32)
            self._note(self._gblock_np.nbytes)
        return self._gblock_np

    def host(self) -> BlockShardNP:
        """Exact host view (one O(n_loc + m_loc) download, cached)."""
        if self._host is None:
            no, ng, nr, ml = self.n_own, self.n_ghost, self.n_rows, self.m_local
            self._host = BlockShardNP(
                block=self.block, halo=self.halo, n_own=no, n_ghost=ng,
                n_rows=nr, m_local=ml,
                own_global=self.own_global_np(),
                ghost_global=self.ghost_global_np(),
                ghost_hop=_np(self.ghost_hop[:ng], np.int32),
                ghost_block=self.ghost_block_np(),
                nw=_np(self.nw[:no], np.float32),
                ghost_nw=_np(self.ghost_nw[:ng], np.float32),
                indptr=_np(self.indptr[: nr + 1], np.int64),
                indices=_np(self.indices[:ml], np.int32),
                ew=_np(self.ew[:ml], np.float32),
                ghost_slot=self.ghost_slot,
                iface_global=self.iface_global,
                iface_local=self.iface_local,
                send_blocks=self.send_blocks,
                send_ptr=self.send_ptr,
                send_local=self.send_local,
            )
            self._note(ng * 16 + no * 4 + (nr + 1) * 4 + ml * 8)
        return self._host


# --------------------------------------------------------------------------
# extractor
# --------------------------------------------------------------------------


class DeployStats(RegistryBackedStats):
    """Counters surfaced through ``ShardDeployment.stats()``:
    ``extract_calls`` (per-shard extraction dispatches), ``mask_calls``,
    the transfer byte counters, and the set of distinct shape buckets
    (``deploy_bucket_count``).  The reference's ``deploy_compiles`` has no
    counterpart: nothing compiles in eager torch."""

    _COUNTER_FIELDS = (
        "extract_calls", "mask_calls", "h2d_bytes", "d2h_bytes",
    )
    _SET_FIELDS = ("deploy_buckets",)
    # registry keys are namespaced (deploy.h2d_bytes) so the extractor can
    # share the serving stack's registry without colliding with the
    # engine's transfer counters; attributes and snapshot() keys stay bare
    _COUNTER_PREFIX = "deploy."

    @property
    def deploy_bucket_count(self) -> int:
        return len(self.deploy_buckets)


class BlockExtractor:
    """Materializes :class:`BlockShard` artifacts from a resident CSR on
    ``device`` (CUDA unless the caller names another; a :class:`GraphDev`
    input is used on its own device).

    ``(Ob, Gb, Eb)`` buckets are pow2 / ``arc_bucket`` with *sticky* floors,
    as in the reference, so balanced blocks share one padded shape.
    """

    def __init__(self, on_h2d=None, on_d2h=None, registry=None, device=None):
        self.device = resolve_device(device)
        self.stats = DeployStats(registry)
        self._on_h2d = on_h2d or (lambda b: None)
        self._on_d2h = on_d2h or (lambda b: None)
        self._o_sticky = 0
        self._g_sticky = 0
        self._e_sticky = 0
        self._dev_cache: Dict[int, tuple] = {}   # id(GraphNP) -> (g, GraphDev)

    # ------------------------------------------------------------- internals

    def _note_h2d(self, nbytes: int) -> None:
        self.stats.h2d_bytes += int(nbytes)
        self._on_h2d(int(nbytes))

    def _note_d2h(self, nbytes: int) -> None:
        self.stats.d2h_bytes += int(nbytes)
        self._on_d2h(int(nbytes))

    def _as_dev(self, g: AnyGraph) -> GraphDev:
        if isinstance(g, GraphDev):
            return g
        hit = self._dev_cache.get(id(g))
        if hit is not None and hit[0] is g:
            return hit[1]
        gd = to_device_csr(g, self.device, on_materialize=self._note_d2h)
        self._note_h2d(sum(t.numel() * t.element_size() for t in (
            gd.indptr, gd.indices, gd.ew, gd.nw, gd.src)))
        # one entry: only the current graph's upload is worth pinning (a
        # serving loop feeds a fresh host snapshot per extraction)
        self._dev_cache = {id(g): (g, gd)}
        return gd

    def _labels_nb(self, gd: GraphDev, labels, k: int) -> torch.Tensor:
        """Labels sliced/padded to the CSR node bucket (pad k: no block)."""
        Nb = gd.nw.shape[0]
        if isinstance(labels, torch.Tensor):
            lab = labels.to(torch.int32)
            if lab.shape[0] >= Nb:
                return lab[:Nb]
            return torch.cat([lab, lab.new_full((Nb - lab.shape[0],), k)])
        out = np.full(Nb, k, np.int32)
        out[: gd.n] = np.asarray(labels[: gd.n], dtype=np.int32)
        self._note_h2d(out.nbytes)
        t = torch.from_numpy(out).to(gd.nw.device)
        _mem_account("label_arenas", t)
        return t

    # --------------------------------------------------------------- public

    def extract_one(self, g: AnyGraph, labels, block: int, k: int,
                    halo: int = 1) -> BlockShard:
        """Extract one block's shard (device; 4 scalars sync to host)."""
        if halo < 1:
            raise ValueError("halo depth must be >= 1")
        gd = self._as_dev(g)
        lab = self._labels_nb(gd, labels, k)
        return self._extract_one(gd, lab, block, halo)

    def _extract_one(self, gd: GraphDev, lab: torch.Tensor, block: int,
                     halo: int) -> BlockShard:
        Nb = gd.nw.shape[0]
        Mb = gd.indices.shape[0]
        self.stats.mask_calls += 1
        note_new(self.stats.deploy_buckets, "deploy.extract", ("mask", Nb, Mb))
        hop, counts = _shard_masks(
            lab, gd.src, gd.indices, gd.indptr, block, gd.n, halo
        )
        n_own, n_ghost, n_rows, m_local = (int(x) for x in counts.tolist())
        self._note_d2h(16)
        # sticky buckets, clamped to the current CSR's buckets so one
        # extractor serves graphs of different scales (perm has Nb entries)
        Ob = min(max(self._o_sticky, pow2(max(n_own, 8))), Nb)
        Gb = min(max(self._g_sticky, pow2(max(n_ghost, 8))), Nb)
        Eb = min(max(self._e_sticky, arc_bucket(m_local)), arc_bucket(Mb))
        self._o_sticky, self._g_sticky, self._e_sticky = Ob, Gb, Eb
        self.stats.extract_calls += 1
        note_new(self.stats.deploy_buckets, "deploy.extract",
                 ("extract", Nb, Mb, Ob, Gb, Eb))
        (own_g, ghost_g, ghost_hop, ghost_block, nw_own, ghost_nw,
         indptr_loc, heads, ew_loc) = _shard_extract(
            hop, lab, gd.indptr, gd.indices, gd.ew, gd.nw, gd.n, halo,
            n_own, n_ghost, n_rows, Ob=Ob, Gb=Gb, Eb=Eb,
        )
        _mem_account(
            "block_shards", own_g, ghost_g, ghost_hop, ghost_block,
            nw_own, ghost_nw, indptr_loc, heads, ew_loc,
        )
        return BlockShard(
            block=block, halo=halo, n_own=n_own, n_ghost=n_ghost,
            n_rows=n_rows, m_local=m_local,
            own_g=own_g, ghost_g=ghost_g, ghost_hop=ghost_hop,
            ghost_block_dev=ghost_block, nw=nw_own, ghost_nw=ghost_nw,
            indptr=indptr_loc, indices=heads, ew=ew_loc,
            on_materialize=self._note_d2h,
        )

    def extract(self, g: AnyGraph, labels, k: int, halo: int = 1,
                blocks=None, assemble: bool = True) -> List[BlockShard]:
        """Extract shards for ``blocks`` (default: all ``k``) and assemble
        the cross-block exchange schedule.

        The schedule needs every ghost's *owner* shard present, so it can
        only be assembled over the full block set — a partial extraction
        (the migration path) must pass ``assemble=False`` and re-assemble
        over the complete patched shard list."""
        if halo < 1:
            raise ValueError("halo depth must be >= 1")
        blocks = list(range(k)) if blocks is None else list(blocks)
        if assemble and (
            len(blocks) != k or set(blocks) != set(range(k))
        ):
            raise ValueError(
                "exchange-schedule assembly needs each of the k blocks "
                "exactly once; pass assemble=False for a partial extraction"
            )
        gd = self._as_dev(g)
        lab = self._labels_nb(gd, labels, k)
        shards = [self._extract_one(gd, lab, b, halo) for b in blocks]
        if assemble:
            assemble_schedule(shards)
        return shards


# --------------------------------------------------------------------------
# exchange-schedule assembly (host, O(boundary log boundary))
# --------------------------------------------------------------------------


def _schedule_from_lists(own, ghost_g, ghost_b, blocks):
    """Shared schedule planner: per-owner iface buffers (sorted unique
    requested ids), (owner, slot) maps and per-neighbour send lists, from
    the O(boundary) id lists.  ``blocks[i]`` is the block id of entry i;
    used verbatim by the device and oracle paths so the schedule is
    identical whenever the id lists are."""
    k = len(own)
    of_block = {b: i for i, b in enumerate(blocks)}
    iface_g: List[np.ndarray] = []
    for i in range(k):
        req = [ghost_g[j][ghost_b[j] == blocks[i]] for j in range(k) if j != i]
        req = [r for r in req if r.size]
        iface_g.append(
            np.unique(np.concatenate(req)).astype(np.int32)
            if req else np.zeros(0, np.int32)
        )
    out = []
    for i in range(k):
        slot = np.zeros(ghost_g[i].shape[0], np.int32)
        nbrs, ptr, send = [], [0], []
        for c in np.unique(ghost_b[i]):
            c = int(c)
            j = of_block[c]
            sel = ghost_b[i] == c
            slot[sel] = np.searchsorted(iface_g[j], ghost_g[i][sel]).astype(
                np.int32
            )
        # send lists of block i: who ghosts MY nodes, in sorted-id order
        for j in range(k):
            if j == i:
                continue
            gids = np.sort(ghost_g[j][ghost_b[j] == blocks[i]])
            if gids.size:
                nbrs.append(blocks[j])
                send.append(
                    np.searchsorted(own[i], gids).astype(np.int32)
                )
                ptr.append(ptr[-1] + gids.size)
        out.append(dict(
            ghost_slot=slot,
            iface_global=iface_g[i],
            iface_local=np.searchsorted(own[i], iface_g[i]).astype(np.int32),
            send_blocks=np.asarray(nbrs, np.int32),
            send_ptr=np.asarray(ptr, np.int64),
            send_local=(np.concatenate(send).astype(np.int32)
                        if send else np.zeros(0, np.int32)),
        ))
    return out


def assemble_schedule(shards: List[BlockShard]) -> None:
    """Fill the exchange-schedule fields of device shards (host fields of
    the shard objects; no tensor is written).

    Every ghost of every shard must point at an (owner, slot) pair such
    that packing each owner's ``iface_local`` nodes in slot order and
    all-gathering the stacked buffers reproduces every ghost table —
    the invariant :func:`ghost_exchange_numpy` executes."""
    plans = _schedule_from_lists(
        [s.own_global_np() for s in shards],
        [s.ghost_global_np() for s in shards],
        [s.ghost_block_np() for s in shards],
        [s.block for s in shards],
    )
    for s, p in zip(shards, plans):
        s.ghost_slot = p["ghost_slot"]
        s.iface_global = p["iface_global"]
        s.iface_local = p["iface_local"]
        s.send_blocks = p["send_blocks"]
        s.send_ptr = p["send_ptr"]
        s.send_local = p["send_local"]
        s._host = None  # host view (if any) predates the schedule


def ghost_exchange_numpy(shards, values: np.ndarray) -> List[np.ndarray]:
    """Execute one bulk-synchronous ghost exchange on the host.

    ``values`` is a global per-node payload (labels, activations, ...).
    Each owner packs ``values[iface_global]`` (its send buffer, slot
    order); the stacked buffers play the role of the all-gather result;
    every shard fills its ghost table via ``bufs[ghost_block, ghost_slot]``.
    Returns the per-shard ``(n_ghost,)`` received arrays — equal to
    ``values[ghost_global]`` by the schedule invariant.
    """
    hosts = [s.host() if isinstance(s, BlockShard) else s for s in shards]
    of_block = {h.block: i for i, h in enumerate(hosts)}
    bufs = [values[h.iface_global] for h in hosts]
    out = []
    for h in hosts:
        recv = np.zeros(h.n_ghost, values.dtype)
        for c in np.unique(h.ghost_block):
            sel = h.ghost_block == c
            recv[sel] = bufs[of_block[int(c)]][h.ghost_slot[sel]]
        out.append(recv)
    return out


# --------------------------------------------------------------------------
# numpy oracle + reassembly
# --------------------------------------------------------------------------


def extract_blocks_numpy(g: GraphNP, labels: np.ndarray, k: int,
                         halo: int = 1, blocks=None) -> List[BlockShardNP]:
    """Host oracle: bit-identical to the device extraction + schedule (and
    to the reference's oracle).

    The same synchronous BFS layering, the same stable layout sort, the
    same row-major CSR-order edge fill — so every array of every shard
    matches the device path's ``host()`` view exactly (same dtypes, same
    bits).
    """
    if halo < 1:
        raise ValueError("halo depth must be >= 1")
    n = g.n
    labels = np.asarray(labels[:n], dtype=np.int32)
    src = g.arc_sources().astype(np.int64)
    dst = g.indices.astype(np.int64)
    deg = g.degrees().astype(np.int64)
    blocks = range(k) if blocks is None else blocks
    cores = []
    for b in blocks:
        hop = np.where(labels == b, 0, _BIG).astype(np.int32)
        for r in range(halo):
            reach = np.zeros(n, bool)
            reach[dst[hop[src] <= r]] = True
            hop = np.where(reach & (hop > r + 1), r + 1, hop).astype(np.int32)
        key = np.where(hop == 0, 0, np.where(hop <= halo, hop, _BIG))
        perm = np.argsort(key, kind="stable")
        n_own = int((hop == 0).sum())
        n_ghost = int(((hop >= 1) & (hop <= halo)).sum())
        n_rows = int((hop < halo).sum())
        loc = np.zeros(n, np.int32)
        loc[perm] = np.arange(n, dtype=np.int32)
        own_global = perm[:n_own].astype(np.int32)
        ghost_global = perm[n_own : n_own + n_ghost].astype(np.int32)
        rows = perm[:n_rows]
        rdeg = deg[rows]
        indptr_loc = np.zeros(n_rows + 1, np.int64)
        np.cumsum(rdeg, out=indptr_loc[1:])
        m_local = int(indptr_loc[-1])
        # the arcs of each row in CSR order, rows in layout order
        idx = (np.repeat(g.indptr[rows].astype(np.int64) - indptr_loc[:-1],
                         rdeg) + np.arange(m_local, dtype=np.int64))
        cores.append(dict(
            block=b, n_own=n_own, n_ghost=n_ghost, n_rows=n_rows,
            m_local=m_local, own_global=own_global,
            ghost_global=ghost_global,
            ghost_hop=hop[ghost_global].astype(np.int32),
            ghost_block=labels[ghost_global].astype(np.int32),
            nw=g.nw[own_global].astype(np.float32),
            ghost_nw=g.nw[ghost_global].astype(np.float32),
            indptr=indptr_loc,
            indices=loc[g.indices[idx]].astype(np.int32),
            ew=g.ew[idx].astype(np.float32),
        ))
    plans = _schedule_from_lists(
        [c["own_global"] for c in cores],
        [c["ghost_global"] for c in cores],
        [c["ghost_block"] for c in cores],
        [c["block"] for c in cores],
    )
    return [
        BlockShardNP(halo=halo, **c, **p) for c, p in zip(cores, plans)
    ]


def reassemble(shards, n: int) -> GraphNP:
    """Glue the OWNED rows of all shards back into the global CSR.

    Blocks partition the node set, so every global row lives in exactly one
    shard; heads map back through ``local_global`` and arc order within a
    row is preserved — the result is bit-identical to the extraction input,
    and its cut equals the sum of the shards' ghost-arc weights.
    """
    hosts = [s.host() if isinstance(s, BlockShard) else s for s in shards]
    deg = np.zeros(n, np.int64)
    for h in hosts:
        deg[h.own_global] = np.diff(h.indptr[: h.n_own + 1])
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    m = int(indptr[-1])
    indices = np.zeros(m, np.int32)
    ew = np.zeros(m, np.float32)
    nw = np.zeros(n, np.float32)
    for h in hosts:
        if h.n_own == 0:
            continue
        lg = h.local_global
        nw[h.own_global] = h.nw
        cnt = np.diff(h.indptr[: h.n_own + 1])
        m_own = int(h.indptr[h.n_own])
        rows_rep = np.repeat(np.arange(h.n_own), cnt)
        off = np.arange(m_own) - np.repeat(h.indptr[: h.n_own], cnt)
        gpos = indptr[h.own_global[rows_rep]] + off
        indices[gpos] = lg[h.indices[:m_own]]
        ew[gpos] = h.ew[:m_own]
    return GraphNP(indptr=indptr, indices=indices, ew=ew, nw=nw)
