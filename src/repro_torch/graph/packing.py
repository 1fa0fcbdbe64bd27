"""Packing: the static-shape layouts the LP engine consumes.

Host planners (numpy, array-for-array identical to ``repro.graph.packing``):

* :func:`plan_chunks` / :func:`layout_nodes` / :func:`pack_chunks` — group
  nodes (in a traversal order) into fixed-size *chunks* with bounded node
  and edge counts; the sweep walks chunks sequentially and moves the
  nodes of one chunk synchronously;
* :func:`pad_pack` — pad a pack to a larger bucket shape (inert);
* :func:`plan_region_pack` — the chunk plan of a node subset (the dynamic
  repairer's affected region);
* :func:`plan_ell_rows` / :func:`ell_pack` — the row-split ELL layout of the
  dense refinement (a node of degree d owns ``ceil(d / width)`` rows);
* :func:`shard_graph` — the distributed graph (:class:`ShardedGraph`):
  P contiguous node ranges with ghost and interface maps.

Device gathers (torch): :func:`gather_pack_device` and
:func:`gather_ell_device` fill the O(m) edge arrays of a host plan from a
device-resident CSR (a :class:`~repro_torch.graph.csr.GraphDev`'s, or the
engine's upload of a :class:`~repro_torch.graph.csr.GraphNP`), in groups
under :data:`GATHER_BUDGET_BYTES`.

Pack invariants (relied upon by the sweep): within a chunk, valid arcs are
grouped by source slot in non-decreasing slot order; padded arcs trail with
``edge_valid == False``, slot 0, weight 0 and head ``n``; padded node slots
hold the sentinel ``n``; a node's arcs never straddle chunks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .csr import GraphNP

__all__ = [
    "ChunkPack",
    "EllPack",
    "chunk_geometry",
    "plan_chunks",
    "layout_nodes",
    "pack_chunks",
    "plan_region_pack",
    "gather_pack_device",
    "gather_ell_device",
    "plan_ell_rows",
    "pad_pack",
    "ell_pack",
    "ShardedGraph",
    "shard_graph",
    "ELL_WIDTH",
    "GATHER_BUDGET_BYTES",
]

#: Slots per row of the dense path's ELL pack, and the multiple that
#: ``pad_k`` rounds a block count up to: the reference's lane width (128).
ELL_WIDTH = 128

#: Device bytes of temporaries a gather may hold beyond its outputs:
#: :func:`gather_pack_device` and :func:`gather_ell_device` split a larger
#: input into groups of whole chunks (every lane) or rows that each stay
#: under it, so building the finest graph's packs adds no peak of its own.
#: A smaller input, such as a region pack or a small coarse level, is one
#: group.
GATHER_BUDGET_BYTES = 64 << 20

# Upper bounds on the bytes a gather holds per output slot (arc or ELL
# slot) of a group, and per node slot of a chunk plan through the groups
# (before them, at most 48 while they are computed).
_PACK_SLOT_BYTES = 32
_PACK_NODE_BYTES = 24
_ELL_SLOT_BYTES = 24


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def chunk_geometry(n: int, m: int, target_chunks: int = 64) -> tuple:
    """Per-chunk (max_nodes, max_edges) request for an (n, m)-graph."""
    max_nodes = max(256, -(-n // target_chunks))
    max_edges = max(4096, -(-m // max(target_chunks // 2, 1)))
    return max_nodes, max_edges


@dataclass(frozen=True)
class ChunkPack:
    """Fixed-shape chunked traversal layout (numpy).

    Shapes: C chunks, N node slots per chunk, E arcs per chunk.
    """

    nodes: np.ndarray          # (C, N) int32, node ids, padded with n
    node_valid: np.ndarray     # (C, N) bool
    edge_dst: np.ndarray       # (C, E) int32, arc heads, padded with n
    edge_w: np.ndarray         # (C, E) float32, padded with 0
    edge_src_slot: np.ndarray  # (C, E) int32 in [0, N)
    edge_valid: np.ndarray     # (C, E) bool
    n: int

    @property
    def num_chunks(self) -> int:
        return self.nodes.shape[0]


def plan_chunks(
    deg_ordered: np.ndarray,
    n: int,
    max_nodes: int = 4096,
    max_edges: int = 32768,
    block: int = 32,
):
    """Greedy chunk assignment from the O(n) degree sequence alone.

    Greedy runs over mini-blocks of ``block`` consecutive ordered nodes;
    ``max_edges`` is raised to the largest block degree sum so no node's
    adjacency is split across chunks.  Returns ``(node_chunk, C, N, E)``.
    """
    deg = np.asarray(deg_ordered, dtype=np.int64)
    nb = _round_up(n, block) // block
    pad_n = nb * block - n
    deg_b = np.concatenate([deg, np.zeros(pad_n, np.int64)]).reshape(nb, block)
    bdeg = deg_b.sum(axis=1)
    max_edges = max(max_edges, int(bdeg.max(initial=0)))
    max_nodes = max(block, min(max_nodes, n if n > 0 else block))

    chunk_of_block = np.zeros(nb, dtype=np.int64)
    cur, ce, cn = 0, 0, 0
    for i in range(nb):
        if (ce + bdeg[i] > max_edges or cn + block > max_nodes) and (ce > 0 or cn > 0):
            cur += 1
            ce, cn = 0, 0
        chunk_of_block[i] = cur
        ce += int(bdeg[i])
        cn += block
    C = cur + 1

    node_chunk = np.repeat(chunk_of_block, block)[:n]  # per ordered node
    N = int(np.bincount(node_chunk, minlength=C).max())
    N = _round_up(N, 8)
    E = int(np.bincount(node_chunk, weights=deg, minlength=C).max())
    E = max(8, _round_up(E, 8))
    return node_chunk, C, N, E


def _slots(node_chunk: np.ndarray, C: int) -> np.ndarray:
    """Slot of every ordered node inside its chunk (``node_chunk`` is
    non-decreasing, so slots follow from one cumulative count)."""
    counts = np.bincount(node_chunk, minlength=C)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.arange(node_chunk.size, dtype=np.int64) - starts[node_chunk]


def layout_nodes(order: np.ndarray, node_chunk: np.ndarray, C: int, N: int, n: int):
    """(C, N) node-id layout + validity mask for a chunk plan (host, O(n))."""
    nodes = np.full((C * N,), n, dtype=np.int32)
    node_valid = np.zeros((C * N,), dtype=bool)
    if node_chunk.size:
        pos = node_chunk * np.int64(N) + _slots(node_chunk, C)
        nodes[pos] = order
        node_valid[pos] = True
    return nodes.reshape(C, N), node_valid.reshape(C, N)


def pack_chunks(
    g: GraphNP,
    order: np.ndarray,
    max_nodes: int = 4096,
    max_edges: int = 32768,
    block: int = 32,
) -> ChunkPack:
    """Greedy-pack nodes (taken in ``order``) into chunks, edge arrays filled
    on the host.  Vectorized over all arcs; the arrays equal the reference's
    per-chunk loop element for element."""
    n = g.n
    order = np.asarray(order, dtype=np.int64)
    deg = g.degrees().astype(np.int64)[order]
    node_chunk, C, N, E = plan_chunks(
        deg, n, max_nodes=max_nodes, max_edges=max_edges, block=block
    )
    nodes, node_valid = layout_nodes(order, node_chunk, C, N, n)

    edge_dst = np.full((C, E), n, dtype=np.int32)
    edge_w = np.zeros((C, E), dtype=np.float32)
    edge_src_slot = np.zeros((C, E), dtype=np.int32)
    edge_valid = np.zeros((C, E), dtype=bool)
    tot = int(deg.sum())
    if tot:
        # arcs in traversal order: node i's adjacency follows node i-1's, so
        # each chunk's arcs are one contiguous run of this concatenation
        arc_node = np.repeat(np.arange(n, dtype=np.int64), deg)
        node_first = np.cumsum(deg) - deg
        arc_i = np.arange(tot, dtype=np.int64)
        idx = g.indptr[order][arc_node] + (arc_i - node_first[arc_node])
        arc_chunk = node_chunk[arc_node]
        chunk_arcs = np.bincount(arc_chunk, minlength=C)
        chunk_first = np.cumsum(chunk_arcs) - chunk_arcs
        flat = arc_chunk * np.int64(E) + (arc_i - chunk_first[arc_chunk])
        edge_dst.reshape(-1)[flat] = g.indices[idx]
        edge_w.reshape(-1)[flat] = g.ew[idx]
        edge_src_slot.reshape(-1)[flat] = _slots(node_chunk, C)[arc_node]
        edge_valid.reshape(-1)[flat] = True

    return ChunkPack(
        nodes=nodes,
        node_valid=node_valid,
        edge_dst=edge_dst,
        edge_w=edge_w,
        edge_src_slot=edge_src_slot,
        edge_valid=edge_valid,
        n=n,
    )


def pad_pack(pack: ChunkPack, C: int, N: int, E: int) -> ChunkPack:
    """Pad a :class:`ChunkPack` to bucket shape ``(C, N, E)`` (no-op if
    equal): extra chunks are invalid, extra node slots hold the sentinel
    ``n``, extra arcs are invalid with weight 0 and slot 0."""
    c0, n0 = pack.nodes.shape
    e0 = pack.edge_dst.shape[1]
    if (c0, n0, e0) == (C, N, E):
        return pack
    if C < c0 or N < n0 or E < e0:
        raise ValueError(f"bucket {(C, N, E)} smaller than pack {(c0, n0, e0)}")
    pc, pn, pe = C - c0, N - n0, E - e0
    return ChunkPack(
        nodes=np.pad(pack.nodes, ((0, pc), (0, pn)), constant_values=pack.n),
        node_valid=np.pad(pack.node_valid, ((0, pc), (0, pn))),
        edge_dst=np.pad(pack.edge_dst, ((0, pc), (0, pe)), constant_values=pack.n),
        edge_w=np.pad(pack.edge_w, ((0, pc), (0, pe))),
        edge_src_slot=np.pad(pack.edge_src_slot, ((0, pc), (0, pe))),
        edge_valid=np.pad(pack.edge_valid, ((0, pc), (0, pe))),
        n=pack.n,
    )


def plan_region_pack(
    deg_ordered: np.ndarray,
    order: np.ndarray,
    n: int,
    max_nodes: int = 4096,
    max_edges: int = 32768,
    block: int = 8,
):
    """Chunk plan + node layout for a SUBSET of the graph's nodes (the
    dynamic repairer's region pack).

    ``order`` holds region node ids, ``deg_ordered`` their degrees in that
    order; the rest of the graph takes part in the sweep only as (label,
    weight) context.  Reuses :func:`plan_chunks` / :func:`layout_nodes` with
    the region size as the packed-node count but the GLOBAL ``n`` as the
    slot sentinel, so the layout feeds :func:`gather_pack_device` against
    the full resident CSR.  Returns ``(nodes, node_valid, C, N, E)``.
    """
    r = int(order.shape[0])
    node_chunk, C, N, E = plan_chunks(
        deg_ordered, r, max_nodes=max_nodes, max_edges=max_edges, block=block
    )
    nodes, node_valid = layout_nodes(order, node_chunk, C, N, n)
    return nodes, node_valid, C, N, E


def _pack_group(starts, start_off, tot, indices, ew, n_t, e_iota, outs) -> None:
    """The arc fill of one group of whole chunks (every lane) of
    :func:`gather_pack_device`, written into ``outs``, the group's slices
    of the four outputs.  At most ``_PACK_SLOT_BYTES`` per arc slot are
    alive at once: temporaries are updated in place and freed before the
    next one is made."""
    dst_o, w_o, slot_o, valid_o = outs
    B, c, _ = starts.shape
    E = e_iota.shape[0]
    # slot owning arc e == the last slot whose first arc is <= e (an empty
    # slot shares its offset with its successor; padded slots trail with
    # the chunk's total)
    slot = torch.searchsorted(start_off, e_iota.expand(B, c, E).contiguous(),
                              right=True)
    slot -= 1
    slot.clamp_(min=0)
    valid = e_iota < tot
    invalid = ~valid
    pos = torch.gather(starts, 2, slot)
    pos -= torch.gather(start_off, 2, slot)
    pos += e_iota
    pos.masked_fill_(invalid, 0)
    slot_o.copy_(slot.masked_fill_(invalid, 0))
    del slot
    valid_o.copy_(valid)
    pos = pos.view(B, c * E)
    torch.where(valid, indices.gather(1, pos).view(B, c, E), n_t, out=dst_o)
    w_o.copy_(ew.gather(1, pos).view(B, c, E).masked_fill_(invalid, 0.0))


def gather_pack_device(
    nodes: torch.Tensor,       # (C, N) int64 — host-planned layout, sentinel n
    node_valid: torch.Tensor,  # (C, N) bool
    indptr: torch.Tensor,      # (Nb + 1,) int64 — device CSR, rows >= n hold m
    indices: torch.Tensor,     # (Mb,) int64
    ew: torch.Tensor,          # (Mb,) float32
    n,
    *,
    E: int,
):
    """Device edge fill for a chunk plan: the O(m) half of packing.

    Emits ``(edge_dst, edge_w, edge_src_slot, edge_valid)`` equal to what
    :func:`pack_chunks` produces on the materialized graph.  With a leading
    lane axis — ``nodes``/``node_valid`` ``(B, C, N)``, ``indptr``,
    ``indices``, ``ew`` ``(B, ...)`` and ``n`` a ``(B,)`` tensor — each lane
    gathers from its own CSR and the outputs are ``(B, C, E)``.  Groups of
    whole chunks, every lane, fill the outputs one after another, each
    under :data:`GATHER_BUDGET_BYTES` of temporaries.
    """
    if nodes.dim() == 2:
        out = gather_pack_device(
            nodes[None], node_valid[None], indptr[None], indices[None], ew[None],
            torch.tensor([int(n)], device=nodes.device), E=E,
        )
        return tuple(t[0] for t in out)
    dev = nodes.device
    B, C, N = nodes.shape
    n_t = torch.as_tensor(n, device=dev).view(B, 1, 1)
    edge_dst = n_t.to(torch.promote_types(indices.dtype, n_t.dtype)).expand(
        B, C, E).contiguous()
    edge_w = torch.zeros((B, C, E), dtype=ew.dtype, device=dev)
    edge_src_slot = torch.zeros((B, C, E), dtype=torch.int64, device=dev)
    edge_valid = torch.zeros((B, C, E), dtype=torch.bool, device=dev)
    if indices.shape[-1] == 0:      # no arcs: every slot is padding
        return edge_dst, edge_w, edge_src_slot, edge_valid
    # node slots, once for every chunk: each slot's first arc in the CSR
    # and in its chunk, and each chunk's arc count
    last = indptr.shape[-1] - 1
    flat_nodes = nodes.reshape(B, C * N)
    starts = indptr.gather(1, flat_nodes).view(B, C, N)
    deg = indptr.gather(1, torch.clamp(flat_nodes + 1, max=last)).view(B, C, N)
    deg -= starts
    deg.masked_fill_(~node_valid, 0)
    start_off = torch.cumsum(deg, dim=2)
    tot = start_off[..., -1:].clone()
    start_off -= deg
    del deg
    e_iota = torch.arange(E, dtype=torch.int64, device=dev)
    free = GATHER_BUDGET_BYTES - B * C * N * _PACK_NODE_BYTES
    step = max(1, free // (B * E * _PACK_SLOT_BYTES))
    for c0 in range(0, C, step):
        cs = slice(c0, min(C, c0 + step))
        _pack_group(
            starts[:, cs], start_off[:, cs].contiguous(), tot[:, cs], indices, ew,
            n_t, e_iota,
            (edge_dst[:, cs], edge_w[:, cs], edge_src_slot[:, cs],
             edge_valid[:, cs]),
        )
    return edge_dst, edge_w, edge_src_slot, edge_valid


@dataclass(frozen=True)
class EllPack:
    """Row-split ELL layout: R rows of fixed ``width``; a node of degree d
    owns ceil(d / width) consecutive rows.  R is padded to a multiple of
    ``tile_rows``."""

    dst: np.ndarray       # (R, width) int32, padded with n
    w: np.ndarray         # (R, width) float32, padded 0
    row_node: np.ndarray  # (R,) int32, owning node, padded with n
    n: int

    @property
    def rows(self) -> int:
        return self.row_node.shape[0]

    @property
    def width(self) -> int:
        return self.dst.shape[1]


def plan_ell_rows(
    indptr: np.ndarray, n: int, width: int = ELL_WIDTH, tile_rows: int = 256
):
    """Host half of a *device* ELL pack: the per-row ``(row_node, row_first,
    row_end)`` adjacency offsets, mirroring :func:`ell_pack`'s row split."""
    deg = np.diff(np.asarray(indptr[: n + 1], dtype=np.int64))
    nrows = np.maximum(1, (deg + width - 1) // width)
    R = int(nrows.sum())
    Rp = _round_up(max(R, 1), tile_rows)
    row_node = np.full(Rp, n, dtype=np.int32)
    row_node[:R] = np.repeat(np.arange(n, dtype=np.int32), nrows)
    starts = np.cumsum(np.concatenate([[0], nrows]))[:-1]
    within = np.arange(R, dtype=np.int64) - np.repeat(starts, nrows)
    row_first = np.zeros(Rp, dtype=np.int32)
    row_end = np.zeros(Rp, dtype=np.int32)
    row_first[:R] = (
        np.repeat(np.asarray(indptr[:-1], dtype=np.int64), nrows)
        + within * width
    ).astype(np.int32)
    row_end[:R] = np.repeat(
        np.asarray(indptr[1:], dtype=np.int64), nrows
    ).astype(np.int32)
    return row_node, row_first, row_end


def gather_ell_device(
    row_first: torch.Tensor,   # (R,) int64 — first adjacency offset of each row
    row_end: torch.Tensor,     # (R,) int64 — the row's exclusive end offset
    indices: torch.Tensor,     # (Mb,) int64 — device CSR heads
    ew: torch.Tensor,          # (Mb,) float32
    n: int,
    *,
    width: int = ELL_WIDTH,
):
    """Device edge fill for an ELL row plan: ``dst``/``w`` equal to
    :func:`ell_pack` on the materialized graph.  Groups of rows fill the
    outputs one after another, each under :data:`GATHER_BUDGET_BYTES` of
    temporaries."""
    dev = row_first.device
    R = row_first.shape[0]
    dst = torch.full((R, width), int(n), dtype=indices.dtype, device=dev)
    w = torch.zeros((R, width), dtype=ew.dtype, device=dev)
    M = indices.shape[0]
    if M == 0:                      # no arcs: every slot is padding
        return dst, w
    iota = torch.arange(width, dtype=torch.int64, device=dev)
    step = max(1, GATHER_BUDGET_BYTES // (width * _ELL_SLOT_BYTES))
    for r0 in range(0, R, step):
        rs = slice(r0, min(R, r0 + step))
        pos = row_first[rs, None] + iota
        invalid = pos >= row_end[rs, None]
        pos.clamp_(0, M - 1)
        dst[rs] = indices[pos].masked_fill_(invalid, int(n))
        w[rs] = ew[pos].masked_fill_(invalid, 0.0)
    return dst, w


def ell_pack(g: GraphNP, width: int = ELL_WIDTH, tile_rows: int = 256) -> EllPack:
    n = g.n
    deg = g.degrees().astype(np.int64)
    nrows = np.maximum(1, (deg + width - 1) // width)
    R = int(nrows.sum())
    Rp = _round_up(max(R, 1), tile_rows)

    row_node = np.full(Rp, n, dtype=np.int32)
    row_node[:R] = np.repeat(np.arange(n, dtype=np.int32), nrows)
    # per-row start offset inside the owning node's adjacency
    starts = np.cumsum(np.concatenate([[0], nrows]))[:-1]  # first row of node
    within = np.arange(R, dtype=np.int64) - np.repeat(starts, nrows)
    row_first = np.repeat(g.indptr[:-1].astype(np.int64), nrows) + within * width
    row_end = np.repeat(g.indptr[1:].astype(np.int64), nrows)

    pos = row_first[:, None] + np.arange(width, dtype=np.int64)[None, :]
    valid = pos < row_end[:, None]
    pos_c = np.minimum(pos, max(g.m - 1, 0))
    dst = np.full((Rp, width), n, dtype=np.int32)
    w = np.zeros((Rp, width), dtype=np.float32)
    if g.m:
        dst[:R] = np.where(valid, g.indices[pos_c], n)
        w[:R] = np.where(valid, g.ew[pos_c], 0.0)
    return EllPack(dst=dst, w=w, row_node=row_node, n=n)


@dataclass(frozen=True)
class ShardedGraph:
    """The paper's distributed graph (§IV-A) in stacked, padded numpy arrays
    (the reference's fields, shapes and dtypes).

    Every array has a leading PE axis of size P and is padded to the
    per-field maximum over the PEs.  Local index space of PE p: ``[0, n_p)``
    are the owned nodes (globals ``range_start[p] .. range_start[p] + n_p``),
    ``[n_p, n_p + g_p)`` the ghosts (sorted by global id).
    """

    P: int
    n: int                       # global node count
    range_start: np.ndarray      # (P,) int64 — first owned global id
    n_local: np.ndarray          # (P,) int32 — owned nodes per PE
    n_ghost: np.ndarray          # (P,) int32 — ghosts per PE
    n_iface: np.ndarray          # (P,) int32 — interface nodes per PE
    m_local: np.ndarray          # (P,) int32 — arcs per PE
    indptr: np.ndarray           # (P, maxN + 1) int64 (local CSR, padded flat)
    indices: np.ndarray          # (P, maxM) int32 — heads in LOCAL-EXT space
    ew: np.ndarray               # (P, maxM) float32
    nw: np.ndarray               # (P, maxN) float32 — owned node weights
    ghost_global: np.ndarray     # (P, maxG) int64 — global id of each ghost
    ghost_owner: np.ndarray      # (P, maxG) int32 — owning PE
    ghost_slot: np.ndarray       # (P, maxG) int32 — slot in owner's iface buffer
    ghost_nw: np.ndarray         # (P, maxG) float32 — ghost node weights
    iface_nodes: np.ndarray      # (P, maxI) int32 — local ids of interface nodes

    @property
    def max_local(self) -> int:
        return self.nw.shape[1]

    @property
    def max_ghost(self) -> int:
        return self.ghost_global.shape[1]

    @property
    def max_iface(self) -> int:
        return self.iface_nodes.shape[1]


def shard_graph(g: GraphNP, P: int) -> ShardedGraph:
    """Split ``g`` into P contiguous node-range shards with ghost and
    interface maps."""
    n = g.n
    per = (n + P - 1) // P
    range_start = np.minimum(np.arange(P, dtype=np.int64) * per, n)
    range_end = np.minimum(range_start + per, n)

    parts = []
    for p in range(P):
        a, b = int(range_start[p]), int(range_end[p])
        n_p = b - a
        lo, hi = int(g.indptr[a]), int(g.indptr[b])
        dst = g.indices[lo:hi].astype(np.int64)
        is_ghost = (dst < a) | (dst >= b)
        ghosts = np.unique(dst[is_ghost])
        # heads in local-ext space
        heads = np.where(is_ghost, n_p + np.searchsorted(ghosts, dst), dst - a)
        indptr_local = (g.indptr[a : b + 1] - lo).astype(np.int64)
        # interface nodes: owned nodes with a ghost neighbour
        owns_ghost = np.zeros(n_p, dtype=bool)
        if hi > lo:
            src_local = np.repeat(np.arange(n_p), np.diff(indptr_local))
            owns_ghost[src_local[is_ghost]] = True
        parts.append(dict(
            a=a, n_p=n_p, m_p=hi - lo, indptr=indptr_local,
            heads=heads.astype(np.int32), ew=g.ew[lo:hi], nw=g.nw[a:b],
            ghosts=ghosts, iface=np.flatnonzero(owns_ghost).astype(np.int32),
        ))

    maxN = max(1, _round_up(max(d["n_p"] for d in parts), 8))
    maxM = max(8, _round_up(max(d["m_p"] for d in parts), 8))
    maxG = max(8, _round_up(max(d["ghosts"].shape[0] for d in parts), 8))
    maxI = max(8, _round_up(max(d["iface"].shape[0] for d in parts), 8))

    # slot of every owned node in its PE's interface buffer
    iface_slot_of_global = np.full(n, -1, dtype=np.int64)
    for d in parts:
        iface_slot_of_global[d["a"] + d["iface"]] = np.arange(d["iface"].shape[0])

    out = ShardedGraph(
        P=P,
        n=n,
        range_start=range_start,
        n_local=np.array([d["n_p"] for d in parts], np.int32),
        n_ghost=np.array([d["ghosts"].shape[0] for d in parts], np.int32),
        n_iface=np.array([d["iface"].shape[0] for d in parts], np.int32),
        m_local=np.array([d["m_p"] for d in parts], np.int32),
        indptr=np.zeros((P, maxN + 1), np.int64),
        indices=np.zeros((P, maxM), np.int32),
        ew=np.zeros((P, maxM), np.float32),
        nw=np.zeros((P, maxN), np.float32),
        ghost_global=np.full((P, maxG), -1, np.int64),
        ghost_owner=np.zeros((P, maxG), np.int32),
        ghost_slot=np.zeros((P, maxG), np.int32),
        ghost_nw=np.zeros((P, maxG), np.float32),
        iface_nodes=np.zeros((P, maxI), np.int32),
    )
    for p, d in enumerate(parts):
        n_p, m_p, gs = d["n_p"], d["m_p"], d["ghosts"]
        out.indptr[p, : n_p + 1] = d["indptr"]
        out.indptr[p, n_p + 1 :] = d["indptr"][-1]
        out.indices[p, :m_p] = d["heads"]
        out.ew[p, :m_p] = d["ew"]
        out.nw[p, :n_p] = d["nw"]
        out.ghost_global[p, : gs.shape[0]] = gs
        out.ghost_owner[p, : gs.shape[0]] = np.minimum(gs // per, P - 1)
        out.ghost_slot[p, : gs.shape[0]] = iface_slot_of_global[gs]
        out.ghost_nw[p, : gs.shape[0]] = g.nw[gs]
        out.iface_nodes[p, : d["iface"].shape[0]] = d["iface"]
    # every ghost must be an interface node of its owner
    assert np.all(out.ghost_slot[out.ghost_global >= 0] >= 0)
    return out
