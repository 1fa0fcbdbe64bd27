"""Distributed-memory SCLaP (paper §IV-A/B/C) — the port of
``repro.core.distributed_lp``.

The reference runs one program per PE under ``shard_map``.  The port keeps
the single controlling process and places PE ``p`` on
``mesh[p] = devices[p % len(devices)]`` (:func:`~repro_torch.launch.make_mesh`):

* every PE owns a contiguous node range plus ghost copies of remote
  neighbours (:class:`~repro_torch.graph.ShardedGraph`), uploaded to its
  device as :class:`ShardTensors`;
* the controller runs the PEs phase-synchronously: within a *phase* each
  PE sweeps one local chunk (:func:`shard_phase`) with the ghost labels of
  the previous phase — the paper's asynchronous overlap expressed
  bulk-synchronously;
* at the end of a phase every PE packs the labels of its *interface nodes*
  into a send buffer; the buffers are stacked into ``(P, maxI)`` on each
  device (the reference's ``all_gather``) and a precomputed (owner, slot)
  map reads the ghosts out of it (:func:`exchange`);
* balance accounting follows §IV-B: coarsening uses per-PE weight tables
  over the clusters of local and ghost nodes only (a sorted-unique table
  rebuilt each phase); refinement uses exact global block weights, the sum
  over PEs of each PE's ``(k + 1)`` table (the reference's ``psum``).

Parity with the reference (bit for bit on integral weights): the chunk
layout and the PRNG (``fold_in(PRNGKey(seed), pe)``, one ``split`` per
phase, ``uniform(sub, (Ec,), 0, 0.49)``) are the same; the ``lexsort`` is
one stable int64 key ``slot * 2^31 + cand``.  The reference writes the new
labels with a scatter whose pad slots (node ``-1``, clamped to 0) carry
local node 0's *old* label; XLA applies the duplicates in order, so a PE's
node 0 never moves when its chunk has padding.  The port writes each index
once, with the value of the last slot that targets it, and so reproduces
that result on every device.  The reference also reads PE p's ghost j at
``maxN + j`` of its local-ext labels while the chunk heads name it
``n_p + j``, so with ``n_p < maxN`` every ghost read is shifted; the port
reads where the reference reads.  Both are reference defects kept for
parity: the labels stay valid, only their quality suffers.

:func:`contract_distributed` (§IV-C) builds each PE's deduplicated quotient
arcs on its device and merges them on the host.  There the shifted ghost
read would make a wrong coarse graph, so the port reads each ghost at
``n_p + j`` and equals the host ``contract``.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..graph.csr import GraphNP, from_edges
from ..graph.packing import ShardedGraph, pack_chunks, shard_graph
from ..kernels.lp_score.threefry import fold_in, prng_key, split, uniform
from ..launch.mesh import make_mesh
from ..obs import span as _obs_span
from .contraction import contract_arcs, relabel

__all__ = [
    "DistLPPlan",
    "ShardTensors",
    "build_plan",
    "contract_distributed",
    "exchange",
    "lp_cluster_distributed",
    "lp_refine_distributed",
    "shard_phase",
    "upload_plan",
]

_NEG = float(np.float32(-1e30))
_HAS = float(np.float32(-1e30 / 2))   # "has an eligible candidate" threshold
_SENT = 2**30                         # sentinel label, above every real id
_JIT_HI = 0.49                        # tie-breaking jitter in [0, 0.49)


@dataclass
class DistLPPlan:
    """Stacked host arrays of the distributed sweep (leading axis P)."""

    sg: ShardedGraph
    # per-shard chunk layout (local node sweep order), stacked over PEs:
    ch_nodes: np.ndarray       # (P, C, Nc) int32 local node ids, pad -1
    ch_edge_dst: np.ndarray    # (P, C, Ec) int32 local-EXT ids, pad 0
    ch_edge_w: np.ndarray      # (P, C, Ec) f32
    ch_edge_slot: np.ndarray   # (P, C, Ec) int32
    ch_edge_valid: np.ndarray  # (P, C, Ec) bool
    ch_node_valid: np.ndarray  # (P, C, Nc) bool


# Plan cache: sharding and per-shard packing are a pure function of
# (graph, P, chunks per shard, order, seed-epoch).  Keyed by graph identity
# with a weak graph reference (the cache must not keep graphs alive) and a
# small FIFO bound: coarse graphs are rebuilt per V-cycle, so only the
# finest graph's plans hit again, and entries die with their graph.
_PLAN_CACHE: dict = {}
_PLAN_CACHE_CAP = 8


def build_plan(
    g: GraphNP,
    P_shards: int,
    chunks_per_shard: int = 8,
    order: str = "degree",
    seed: int = 0,
) -> DistLPPlan:
    """Shard the graph and pack each shard's local sweep into chunks.

    Cached per ``(graph, P, chunks_per_shard, order, seed)``: pass the run's
    seed-epoch (not a per-sweep seed) as ``seed`` to reuse plans across
    calls; traversal randomness belongs to the sweep seed.
    """
    key = (id(g), P_shards, chunks_per_shard, order, seed)
    hit = _PLAN_CACHE.get(key)
    if hit is not None and hit[0]() is g:
        _PLAN_CACHE[key] = _PLAN_CACHE.pop(key)   # refresh: the finest
        return hit[1]                             # graph's plans hit most
    with _obs_span("dist.plan", cat="dist", n=int(g.n), order=order, host=True):
        plan = _build_plan_impl(g, P_shards, chunks_per_shard, order, seed)
    for k in [k for k, v in _PLAN_CACHE.items() if v[0]() is None]:
        del _PLAN_CACHE[k]          # entries whose graph was collected
    if len(_PLAN_CACHE) >= _PLAN_CACHE_CAP:
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    _PLAN_CACHE[key] = (weakref.ref(g), plan)
    return plan


def _build_plan_impl(
    g: GraphNP,
    P_shards: int,
    chunks_per_shard: int,
    order: str,
    seed: int,
) -> DistLPPlan:
    sg = shard_graph(g, P_shards)
    rng = np.random.default_rng(seed)
    packs = []
    for p in range(P_shards):
        n_p = int(sg.n_local[p])
        m_p = int(sg.m_local[p])
        local = GraphNP(
            indptr=sg.indptr[p, : n_p + 1].astype(np.int64),
            indices=sg.indices[p, :m_p],
            ew=sg.ew[p, :m_p],
            nw=sg.nw[p, :n_p],
        )
        deg = local.degrees()
        if order == "degree":
            o = np.argsort(deg + rng.random(n_p), kind="stable")
        else:
            o = rng.permutation(n_p)
        packs.append(
            pack_chunks(
                local,
                o.astype(np.int64),
                max_nodes=max(64, -(-n_p // chunks_per_shard)),
                max_edges=max(512, -(-m_p // max(1, chunks_per_shard // 2))),
            )
        )
    C = max(pk.num_chunks for pk in packs)
    Nc = max(pk.nodes.shape[1] for pk in packs)
    Ec = max(pk.edge_dst.shape[1] for pk in packs)
    Pn = P_shards
    ch_nodes = np.full((Pn, C, Nc), -1, np.int32)
    ch_node_valid = np.zeros((Pn, C, Nc), bool)
    ch_edge_dst = np.zeros((Pn, C, Ec), np.int32)
    ch_edge_w = np.zeros((Pn, C, Ec), np.float32)
    ch_edge_slot = np.zeros((Pn, C, Ec), np.int32)
    ch_edge_valid = np.zeros((Pn, C, Ec), bool)
    for p, pk in enumerate(packs):
        c, nn = pk.nodes.shape
        e = pk.edge_dst.shape[1]
        nodes = pk.nodes.copy()
        nodes[~pk.node_valid] = -1  # pack_chunks pads with local n; use -1
        ch_nodes[p, :c, :nn] = nodes
        ch_node_valid[p, :c, :nn] = pk.node_valid
        dst = pk.edge_dst.copy()
        dst[~pk.edge_valid] = 0  # in-range garbage; masked by edge_valid
        ch_edge_dst[p, :c, :e] = dst
        ch_edge_w[p, :c, :e] = pk.edge_w
        ch_edge_slot[p, :c, :e] = pk.edge_src_slot
        ch_edge_valid[p, :c, :e] = pk.edge_valid
    return DistLPPlan(
        sg=sg,
        ch_nodes=ch_nodes,
        ch_edge_dst=ch_edge_dst,
        ch_edge_w=ch_edge_w,
        ch_edge_slot=ch_edge_slot,
        ch_edge_valid=ch_edge_valid,
        ch_node_valid=ch_node_valid,
    )


# --------------------------------------------------------------------------
# one PE's tensors and its phase program
# --------------------------------------------------------------------------


@dataclass
class ShardTensors:
    """One PE's chunk layout and shard structure on its device."""

    device: torch.device
    ch_nodes: torch.Tensor       # (C, Nc) int64, pad -1
    ch_node_valid: torch.Tensor  # (C, Nc) bool
    ch_edge_dst: torch.Tensor    # (C, Ec) int64 local-ext ids
    ch_edge_w: torch.Tensor      # (C, Ec) f32
    ch_edge_slot: torch.Tensor   # (C, Ec) int64
    ch_edge_valid: torch.Tensor  # (C, Ec) bool
    nw_local: torch.Tensor       # (maxN,) f32
    ghost_nw: torch.Tensor       # (maxG,) f32
    ghost_owner: torch.Tensor    # (maxG,) int64
    ghost_slot: torch.Tensor     # (maxG,) int64
    iface_nodes: torch.Tensor    # (maxI,) int64
    local_valid: torch.Tensor    # (maxN,) bool
    ghost_valid: torch.Tensor    # (maxG,) bool


def upload_plan(plan: DistLPPlan, mesh: Sequence[torch.device]) -> List[ShardTensors]:
    """Each PE's arrays of ``plan`` on its mesh device."""
    sg = plan.sg

    def up(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=dev, dtype=dtype or t.dtype)

    out = []
    for p, dev in enumerate(mesh):
        out.append(ShardTensors(
            device=dev,
            ch_nodes=up(plan.ch_nodes[p], torch.int64),
            ch_node_valid=up(plan.ch_node_valid[p]),
            ch_edge_dst=up(plan.ch_edge_dst[p], torch.int64),
            ch_edge_w=up(plan.ch_edge_w[p]),
            ch_edge_slot=up(plan.ch_edge_slot[p], torch.int64),
            ch_edge_valid=up(plan.ch_edge_valid[p]),
            nw_local=up(sg.nw[p]),
            ghost_nw=up(sg.ghost_nw[p]),
            ghost_owner=up(sg.ghost_owner[p], torch.int64),
            ghost_slot=up(sg.ghost_slot[p], torch.int64),
            iface_nodes=up(sg.iface_nodes[p], torch.int64),
            local_valid=torch.arange(sg.max_local, device=dev) < int(sg.n_local[p]),
            ghost_valid=torch.arange(sg.max_ghost, device=dev) < int(sg.n_ghost[p]),
        ))
    return out


def _local_table(st: ShardTensors, ll, lg):
    """Coarsening's per-PE weight table: the sorted distinct cluster ids of
    the local and ghost nodes with their summed weights (+inf on the
    sentinel rows)."""
    ids = torch.cat([torch.where(st.local_valid, ll, _SENT),
                     torch.where(st.ghost_valid, lg, _SENT)])
    wgt = torch.cat([torch.where(st.local_valid, st.nw_local, 0.0),
                     torch.where(st.ghost_valid, st.ghost_nw, 0.0)])
    sid, order = torch.sort(ids, stable=True)
    newrun = torch.cat([sid.new_ones(1, dtype=torch.bool), sid[1:] != sid[:-1]])
    rid = torch.cumsum(newrun, 0) - 1
    T = sid.shape[0]
    table_ids = torch.full((T,), _SENT, dtype=torch.int64, device=st.device)
    table_ids = table_ids.index_put_((rid,), sid)   # a run writes one value
    table_w = torch.zeros(T, dtype=torch.float32, device=st.device)
    table_w = table_w.index_add_(0, rid, wgt[order])
    return table_ids, torch.where(table_ids == _SENT, float("inf"), table_w)


def block_weights(st: ShardTensors, ll, k: int) -> torch.Tensor:
    """One PE's ``(k + 1)`` block weights of its owned nodes."""
    bw = torch.zeros(k + 1, dtype=torch.float32, device=st.device)
    return bw.index_add_(0, torch.where(st.local_valid, ll, k),
                         torch.where(st.local_valid, st.nw_local, 0.0))


def _labels_ext(st: ShardTensors, ll, lg):
    """The reference's local-ext labels: the padded ``(maxN,)`` local
    labels, then the ghosts.  The chunk heads address ghost j as
    ``n_p + j``, so whenever ``n_p < maxN`` a ghost reads the label
    ``maxN - n_p`` places before its own (a local pad slot or another
    ghost's): a reference defect kept for parity, whose cost
    ``tools/dist_ghost_read.py`` measures."""
    return torch.cat([ll, lg])


def shard_phase(st: ShardTensors, c: int, ll, lg, sub, U: float, table_w=None,
                k: int = 0) -> torch.Tensor:
    """One PE's phase (the body of the reference's ``_shard_sweep`` phase):
    sweep local chunk ``c`` with the ghost labels ``lg`` and return the new
    local labels.  ``sub`` is the phase's PRNG key; ``table_w`` the global
    ``(k + 1)`` block weights in refine mode (``[k] = inf``), None to
    cluster with the PE's local table."""
    refine_mode = table_w is not None
    dev = st.device
    Nc = st.ch_nodes.shape[1]
    Ec = st.ch_edge_dst.shape[1]
    maxN = ll.shape[0]
    labels_ext = _labels_ext(st, ll, lg)
    if refine_mode:
        def lookup_w(lbl):
            return table_w[torch.clamp(lbl, max=k)]
    else:
        table_ids, tw = _local_table(st, ll, lg)
        T = table_ids.shape[0]

        def lookup_w(lbl):
            pos = torch.clamp(torch.searchsorted(table_ids, lbl), max=T - 1)
            return torch.where(table_ids[pos] == lbl, tw[pos], float("inf"))

    nd, ndv = st.ch_nodes[c], st.ch_node_valid[c]
    dst, ev, slot = st.ch_edge_dst[c], st.ch_edge_valid[c], st.ch_edge_slot[c]
    w0 = torch.where(ev, st.ch_edge_w[c], 0.0)
    cand = torch.where(ev, labels_ext[dst], _SENT)

    # runs of equal (slot, candidate) in the reference's lexsort order
    _, perm = torch.sort(slot * 2**31 + cand, stable=True)
    s_slot, s_lbl = slot[perm], cand[perm]
    nr = torch.cat([ev.new_ones(1),
                    (s_slot[1:] != s_slot[:-1]) | (s_lbl[1:] != s_lbl[:-1])])
    rid = torch.cumsum(nr, 0) - 1
    run_w = torch.zeros(Ec, dtype=torch.float32, device=dev).index_add_(0, rid, w0[perm])
    run_slot = torch.full((Ec,), Nc, dtype=torch.int64, device=dev).index_put_(
        (rid,), s_slot)
    run_lbl = torch.full((Ec,), _SENT, dtype=torch.int64, device=dev).index_put_(
        (rid,), s_lbl)

    nd_c = torch.clamp(nd, min=0)
    old = ll[nd_c]
    own = torch.where(ndv, old, _SENT)
    rs = torch.clamp(run_slot, max=Nc - 1)
    own_r = own[rs]
    nw_r = torch.where(ndv, st.nw_local[nd_c], 0.0)[rs]
    fits = lookup_w(run_lbl) + nw_r <= U
    keep_or_fit = (run_w > 0) & (fits | (run_lbl == own_r))
    if refine_mode:
        overloaded = lookup_w(own_r) > U
        eligible = torch.where(overloaded, fits & (run_lbl != own_r), keep_or_fit)
    else:
        eligible = keep_or_fit
    eligible &= (run_slot < Nc) & (run_lbl < _SENT)
    jit = uniform(sub, (Ec,), dev, 0.0, _JIT_HI)
    score = torch.where(eligible, run_w + jit, _NEG)

    seg = torch.clamp(run_slot, max=Nc)
    best = torch.full((Nc + 1,), _NEG, dtype=torch.float32, device=dev).scatter_reduce(
        0, seg, score, "amax", include_self=True)
    is_best = (score >= best[seg]) & (score > _HAS)
    win = torch.full((Nc + 1,), _SENT, dtype=torch.int64, device=dev).scatter_reduce(
        0, seg, torch.where(is_best, run_lbl, _SENT), "amin", include_self=True)[:Nc]
    new_lbl = torch.where(ndv & (win < _SENT), win, own)

    # the reference's duplicate-index write, resolved as XLA on the CPU
    # resolves it: per local index the last slot in slot order wins (pad
    # slots, clamped to node 0, write back node 0's old label)
    iota = torch.arange(Nc, device=dev)
    last = torch.full((maxN,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, nd_c, iota, "amax", include_self=True)
    tgt = torch.where(last[nd_c] == iota, nd_c, maxN)   # maxN: dropped slot
    out = torch.cat([ll, ll[:1]])
    out[tgt] = torch.where(ndv, new_lbl, old)
    return out[:maxN]


def exchange(shards: Sequence[ShardTensors], lls, lgs, n_pes: Optional[int] = None) -> list:
    """The phase's label exchange: every PE's interface labels, stacked
    into ``(P, maxI)`` on each distinct device, are read into the ghosts of
    the PEs there.  Returns the new ghost labels.  ``n_pes``: the number
    of PEs when ``shards`` holds one PE alone (a dry run of its program):
    its send buffer then stands in for each of the ``n_pes``."""
    sends = [ll[torch.clamp(st.iface_nodes, min=0)] for st, ll in zip(shards, lls)]
    if n_pes is not None:
        if len(shards) != 1:
            raise ValueError(f"n_pes is for one PE's shard, got {len(shards)}")
        sends = sends * n_pes
    bufs = {}
    for st in shards:
        if st.device not in bufs:
            bufs[st.device] = torch.stack([s.to(st.device) for s in sends])
    return [
        torch.where(st.ghost_valid, bufs[st.device][st.ghost_owner, st.ghost_slot], lg)
        for st, lg in zip(shards, lgs)
    ]


def _initial_labels(sg: ShardedGraph, labels_global: Optional[np.ndarray]):
    """(P, maxN) local and (P, maxG) ghost labels: each node's own global id
    (clustering) or its label in ``labels_global`` (refinement)."""
    ll = np.zeros((sg.P, sg.max_local), np.int64)
    lg = np.zeros((sg.P, sg.max_ghost), np.int64)
    for p in range(sg.P):
        n_p, g_p = int(sg.n_local[p]), int(sg.n_ghost[p])
        a = int(sg.range_start[p])
        if labels_global is not None:
            ll[p, :n_p] = labels_global[a : a + n_p]
            lg[p, :g_p] = labels_global[sg.ghost_global[p, :g_p]]
        else:
            ll[p, :n_p] = np.arange(a, a + n_p)
            lg[p, :g_p] = sg.ghost_global[p, :g_p]
    return ll, lg


def _run_distributed(
    plan: DistLPPlan,
    labels_global: Optional[np.ndarray],
    U: float,
    iters: int,
    seed: int,
    k: int,
    devices,
) -> np.ndarray:
    """``iters * C`` phases (one chunk each) of every PE, phase-synchronous:
    block weights summed over PEs (refinement), each PE's sweep, then the
    exchange.  Returns the global labels."""
    sg = plan.sg
    Pn = sg.P
    refine_mode = labels_global is not None
    mesh = make_mesh(Pn, devices)
    C = plan.ch_nodes.shape[1]
    with _obs_span("dist.sweep", cat="dist", n=int(sg.n), P=Pn, phases=iters * C,
                   mode="refine" if refine_mode else "cluster") as sp:
        shards = upload_plan(plan, mesh)
        ll0, lg0 = _initial_labels(sg, labels_global)
        lls = [torch.from_numpy(ll0[p]).to(mesh[p]) for p in range(Pn)]
        lgs = [torch.from_numpy(lg0[p]).to(mesh[p]) for p in range(Pn)]
        U32 = float(np.float32(U))
        keys = [fold_in(prng_key(seed), p) for p in range(Pn)]
        for ph in range(iters * C):
            c = ph % C
            subs = []
            for p in range(Pn):
                keys[p], sub = split(keys[p])
                subs.append(sub)
            tables = [None] * Pn
            if refine_mode:
                # exact global block weights: the sum over PEs, on each device
                bws = [block_weights(st, ll, k) for st, ll in zip(shards, lls)]
                per_dev = {}
                for st in shards:
                    if st.device not in per_dev:
                        tw = torch.stack([b.to(st.device) for b in bws]).sum(0)
                        tw[k] = float("inf")
                        per_dev[st.device] = tw
                tables = [per_dev[st.device] for st in shards]
            lls = [shard_phase(st, c, lls[p], lgs[p], subs[p], U32, tables[p], k)
                   for p, st in enumerate(shards)]
            lgs = exchange(shards, lls, lgs)
        sp.sync_on(*lls)
    labels = np.zeros(sg.n, np.int32)
    for p in range(Pn):
        n_p, a = int(sg.n_local[p]), int(sg.range_start[p])
        labels[a : a + n_p] = lls[p][:n_p].cpu().numpy()
    return labels


def lp_cluster_distributed(
    plan: DistLPPlan, U: float, iters: int = 3, seed: int = 0, *, devices=None
) -> np.ndarray:
    """Distributed size-constrained LP clustering; returns global labels.
    PEs run on ``make_mesh(P, devices)`` (every CUDA device by default)."""
    return _run_distributed(plan, None, U, iters, seed, 0, devices)


def lp_refine_distributed(
    plan: DistLPPlan,
    labels_global: np.ndarray,
    k: int,
    U: float,
    iters: int = 6,
    seed: int = 0,
    *,
    devices=None,
) -> np.ndarray:
    """Distributed LP local search with exact global block weights."""
    return _run_distributed(
        plan, np.asarray(labels_global), U, iters, seed, k, devices
    )


# --------------------------------------------------------------------------
# distributed contraction (paper §IV-C): each PE builds the weighted
# quotient of its local subgraph on its device (sort + dedup); the
# deduplicated per-PE arc lists are merged on the host.
# --------------------------------------------------------------------------


def _shard_quotient(indptr, indices, ew, m_local: int, c_ext, n_c: int):
    """One PE's deduplicated quotient arcs; ``c_ext`` holds the coarse id
    of every local-ext node (owned nodes, then ghosts)."""
    maxN, maxM = indptr.shape[0] - 1, indices.shape[0]
    arc = torch.arange(maxM, device=indices.device)
    src = torch.searchsorted(indptr, arc, right=True) - 1
    valid = arc < m_local
    cu = torch.where(valid, c_ext[torch.clamp(src, 0, maxN - 1)], 0)
    cv = torch.where(valid, c_ext[indices], 0)
    return contract_arcs(cu, cv, torch.where(valid, ew, 0.0), valid, n_c)


def contract_distributed(plan: DistLPPlan, labels_global: np.ndarray, *,
                         devices=None):
    """Returns ``(coarse GraphNP, fine->coarse map C)`` as ``contract`` does,
    with the O(m) quotient building on each PE's device.

    PE p's ghost j is local-ext node ``n_p + j``.  The reference reads it
    at ``maxN + j`` (it concatenates the padded local labels with the ghost
    labels), which is another node's id whenever ``n_p < maxN``, and so
    returns a wrong quotient there; the port reads it at ``n_p + j`` and
    equals the host ``contract`` for every P."""
    sg = plan.sg
    Pn = sg.P
    C_map, n_c = relabel(labels_global)
    mesh = make_mesh(Pn, devices)
    outs = []
    for p, dev in enumerate(mesh):
        n_p, g_p = int(sg.n_local[p]), int(sg.n_ghost[p])
        a = int(sg.range_start[p])
        c_ext = np.zeros(sg.max_local + sg.max_ghost, np.int64)
        c_ext[:n_p] = C_map[a : a + n_p]
        c_ext[n_p : n_p + g_p] = C_map[sg.ghost_global[p, :g_p]]

        def up(x, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(x))
            return t.to(device=dev, dtype=dtype or t.dtype)

        outs.append(_shard_quotient(
            up(sg.indptr[p]), up(sg.indices[p], torch.int64), up(sg.ew[p]),
            int(sg.m_local[p]), up(c_ext), n_c,
        ))
    cu, cv, w, v = (np.stack([o[i].cpu().numpy() for o in outs]) for i in range(4))
    keep = v.reshape(-1)
    nw_c = np.zeros(n_c, np.float64)
    np.add.at(nw_c, C_map, np.concatenate(
        [sg.nw[p, : int(sg.n_local[p])] for p in range(Pn)]))
    coarse = from_edges(n_c, cu.reshape(-1)[keep], cv.reshape(-1)[keep],
                        w.reshape(-1)[keep], nw=nw_c.astype(np.float32),
                        symmetrize=False, dedup=True)
    return coarse, C_map
