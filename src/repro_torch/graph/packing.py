"""Packing: the static-shape layouts the LP engine consumes.

Host planners (numpy, array-for-array identical to ``repro.graph.packing``):

* :func:`plan_chunks` / :func:`layout_nodes` / :func:`pack_chunks` — group
  nodes (in a traversal order) into fixed-size *chunks* with bounded node
  and edge counts; the sweep walks chunks sequentially and moves the
  nodes of one chunk synchronously;
* :func:`pad_pack` — pad a pack to a larger bucket shape (inert);
* :func:`plan_ell_rows` / :func:`ell_pack` — the row-split ELL layout of the
  dense refinement (a node of degree d owns ``ceil(d / width)`` rows).

Device gathers (torch): :func:`gather_pack_device` and
:func:`gather_ell_device` fill the O(m) edge arrays of a host plan from a
still-resident :class:`~repro_torch.graph.csr.GraphDev` CSR.

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
    "gather_pack_device",
    "gather_ell_device",
    "plan_ell_rows",
    "pad_pack",
    "ell_pack",
]


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


def gather_pack_device(
    nodes: torch.Tensor,       # (C, N) int64 — host-planned layout, sentinel n
    node_valid: torch.Tensor,  # (C, N) bool
    indptr: torch.Tensor,      # (Nb + 1,) int64 — device CSR, rows >= n hold m
    indices: torch.Tensor,     # (Mb,) int64
    ew: torch.Tensor,          # (Mb,) float32
    n: int,
    *,
    E: int,
):
    """Device edge fill for a chunk plan: the O(m) half of packing.

    Emits ``(edge_dst, edge_w, edge_src_slot, edge_valid)`` equal to what
    :func:`pack_chunks` produces on the materialized graph.
    """
    dev = nodes.device
    C, N = nodes.shape
    last = indptr.shape[0] - 1
    starts = indptr[nodes]                                      # (C, N)
    ends = indptr[torch.clamp(nodes + 1, max=last)]
    deg = torch.where(node_valid, ends - starts, 0)
    cum = torch.cumsum(deg, dim=1)
    tot = cum[:, -1]
    e_iota = torch.arange(E, dtype=torch.int64, device=dev)
    # slot owning arc e == (#slot starts <= e) - 1: one mark per slot at its
    # first-arc offset, then a running count along the arc axis (empty
    # slots mark the same offset as their successor)
    start_off = cum - deg
    flat = (torch.arange(C, dtype=torch.int64, device=dev)[:, None] * E
            + start_off).reshape(-1)
    keep = (node_valid & (start_off < E)).reshape(-1)
    flat = torch.where(keep, flat, C * E)        # slot C * E is dropped
    marks = torch.zeros(C * E + 1, dtype=torch.int64, device=dev)
    marks.index_add_(0, flat, torch.ones_like(flat))
    slot = torch.cumsum(marks[: C * E].reshape(C, E), dim=1) - 1
    valid_e = e_iota[None, :] < tot[:, None]
    slot_c = torch.clamp(slot, 0, N - 1)
    before = torch.gather(start_off, 1, slot_c)
    pos = torch.gather(starts, 1, slot_c) + (e_iota[None, :] - before)
    pos = torch.where(valid_e, pos, 0)
    edge_dst = torch.where(valid_e, indices[pos], n)
    edge_w = torch.where(valid_e, ew[pos], 0.0)
    edge_src_slot = torch.where(valid_e, slot_c, 0)
    return edge_dst, edge_w, edge_src_slot, valid_e


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
    indptr: np.ndarray, n: int, width: int = 128, tile_rows: int = 256
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
    width: int = 128,
):
    """Device edge fill for an ELL row plan: ``dst``/``w`` equal to
    :func:`ell_pack` on the materialized graph."""
    pos = row_first[:, None] + torch.arange(
        width, dtype=torch.int64, device=row_first.device
    )[None, :]
    valid = pos < row_end[:, None]
    pos_c = torch.clamp(pos, 0, indices.shape[0] - 1)
    dst = torch.where(valid, indices[pos_c], n)
    w = torch.where(valid, ew[pos_c], 0.0)
    return dst, w


def ell_pack(g: GraphNP, width: int = 128, tile_rows: int = 256) -> EllPack:
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
