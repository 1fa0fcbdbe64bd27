"""Incremental repair rounds (dynamic subsystem, layer 2) — the torch twin
of ``repro.dynamic.repair``.

After a batch of edge/node updates only the h-hop neighbourhood of the
touched endpoints can profit from moving, so the repairer
(:func:`repair_lanes`)

1. expands the **affected region** (:func:`expand_region_device`: a
   frontier scatter per hop over the resident arc tensors; hops past the
   first only expand through nodes of degree <= ``deg_cap``),
2. runs the chunked LP sweep over a *region pack* against exact global
   block weights,
3. finishes with region-masked synchronous **gain** rounds
   (:func:`gain_round_device`, op for op ``fm.gain_round_np(region=...,
   influx_gate=True)``) and **balance-repair** rounds
   (:func:`balance_rounds_device`), behind a cut/feasibility guard.

Every function here works on an explicit leading lane axis: its tensors
are ``(B, ...)`` and its per-lane scalars (``n``, ``deg_cap``, ``Lmax``,
hash bases, seeds) sequences of length ``B``, so one launch sequence
serves all lanes of a ``SessionGroup`` bucket, and a session's repair
(:meth:`repro_torch.core.engine.LPEngine.repair`) is its one-lane case.
A program's solo caller passes unbatched tensors and python scalars and
gets unbatched results (the ``B = 1`` case).  The reference's ``lax.fori_loop`` over hops and rounds is
a Python loop; its ``mode="drop"`` scatters target indices that are always
in range here (block ``k`` of a ``k + 1``-wide block axis), and its clamped
gathers are clamped explicitly.  ``torch.argmax``/``argmin`` return the
first extreme index, as ``jnp.argmax``/``argmin`` do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core.label_propagation import hash_base_u32, hash_jitter, hash_mix, hash_u32_scalar
from ..core.label_propagation import lp_sweep_batched
from ..core.metrics import block_weights_dense, cut_from_arcs
from ..graph.csr import pow2
from ..graph.packing import gather_pack_device, plan_region_pack
from ..obs import span as _obs_span
from ..obs.memory import account as _mem_account

__all__ = [
    "RepairLane",
    "LaneRepairs",
    "repair_lanes",
    "expand_region_device",
    "gain_round_device",
    "balance_rounds_device",
    "TAG_DYN_GAIN",
    "TAG_DYN_GAIN_GATE",
    "TAG_DYN_BAL",
]

_NEG = -1e30
_HAS = float(np.float32(_NEG / 2))

# hash-stream tags for the repair rounds — a namespace disjoint from the
# evolution tags, so a repair round never collides with an evolution
# decision on the same seed
TAG_DYN_GAIN = 0xD7A401
TAG_DYN_GAIN_GATE = 0xD7A402
TAG_DYN_BAL = 0xD7A403


def _hash_unit(base, a, b):
    """Uniform-ish float32 in [0, 1) from integer coordinates."""
    h = hash_mix(hash_mix(base, a), b)
    return (h & 0xFFFFFF).to(torch.float32) / float(1 << 24)


def _lane(x, dev, dtype) -> torch.Tensor:
    """Per-lane scalars as a ``(B, 1)`` tensor (a python scalar -> B = 1)."""
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev).reshape(-1, 1)


def _rows(*ts):
    """Lift unbatched tensors to one lane; report whether that happened."""
    solo = ts[0].dim() == 1
    return solo, [t[None] if solo else t for t in ts]


def expand_region_device(touched, src, dst, indptr, n, hops: int, deg_cap, *, A: int):
    """h-hop frontier expansion over the resident arc tensors.

    Args:
      touched: ``(Tb,)`` int64 touched node ids, padded with ``n`` (inert).
      src, dst: ``(>= m,)`` int64 arc endpoints; padding arcs are (0, 0) and
        only re-mark node 0 from itself.
      indptr: ``(>= n + 1,)`` int64 CSR row pointers (per-arc source degrees).
      n: live node count.
      hops: hop count.
      deg_cap: hops past the first only expand through nodes of degree <=
        ``deg_cap`` (``0x7FFFFFFF`` disables the cap).
      A: mask length (the engine's arena size).

    Returns an ``(A,)`` bool mask of the nodes within ``hops`` hops of a
    touched node (hub-gated past hop 1); ``(B, A)`` with a lane axis.
    """
    solo, (touched, src, dst, indptr) = _rows(touched, src, dst, indptr)
    dev = src.device
    B = src.shape[0]
    n_t = _lane(n, dev, torch.int64)
    cap = _lane(deg_cap, dev, torch.int64)
    hit = torch.zeros((B, A), dtype=torch.int32, device=dev)
    mask = hit.scatter_add(1, touched, (touched < n_t).to(torch.int32)) > 0
    last = indptr.shape[1] - 1
    deg_src = (indptr.gather(1, torch.clamp(src + 1, max=last))
               - indptr.gather(1, src))
    gated = deg_src <= cap
    for i in range(int(hops)):
        allow = mask.gather(1, src)
        if i > 0:
            allow &= gated
        reach = hit.scatter_add(1, dst, allow.to(torch.int32)) > 0
        mask = mask | reach
    return mask[0] if solo else mask


def gain_round_device(src, dst, ew, nw, lab, region, n, k: int, Lmax,
                      base_score, base_gate, *, Kb: int):
    """One region-masked synchronous best-gain round: the device twin of
    ``fm.gain_round_np`` with ``region=..., influx_gate=True``.  Only
    ``region`` nodes move, and each block's net synchronous inflow is capped
    at its headroom in expectation.  Returns new labels (the input is not
    modified)."""
    solo, (src, dst, ew, nw, lab, region) = _rows(src, dst, ew, nw, lab, region)
    dev = lab.device
    B, Ab = lab.shape
    n_t = _lane(n, dev, torch.int64)
    L = _lane(np.asarray(Lmax, np.float32), dev, torch.float32)
    bs = _lane(base_score, dev, torch.int64)[:, :, None]
    bg = _lane(base_gate, dev, torch.int64)
    iota = torch.arange(Ab, dtype=torch.int64, device=dev)
    kio = torch.arange(Kb, dtype=torch.int64, device=dev)
    lab64 = lab.to(torch.int64)
    conn = torch.zeros((B, Ab * Kb), dtype=torch.float32, device=dev)
    conn.scatter_add_(1, src * Kb + lab64.gather(1, dst), ew)
    conn = conn.view(B, Ab, Kb)
    lab_c = torch.clamp(lab64, max=Kb - 1)
    own = conn.gather(2, lab_c[..., None])[..., 0]
    bw = torch.zeros((B, Kb), dtype=torch.float32, device=dev).scatter_add_(1, lab_c, nw)
    bwx = torch.where(kio < k, bw, float("inf"))
    jit = hash_jitter(bs, iota[None, :, None], kio[None, None, :])
    fits = bwx[:, None, :] + nw[:, :, None] <= L[:, :, None]
    elig = fits & (kio != lab64[..., None]) & (conn > own[..., None])
    score = torch.where(elig, conn + jit, _NEG)
    b = torch.argmax(score, dim=2)
    has = score.gather(2, b[..., None])[..., 0] > _HAS
    u = _hash_unit(bg, iota[None, :], 0)
    move = has & (u < 0.5) & (iota < n_t) & region
    # influx gate: accept a mover into block b with probability clip((Lmax -
    # w_b + outflow_b) / inflow_b, 0, 1), so each block's net inflow matches
    # its headroom in expectation
    mv_w = torch.where(move, nw, 0.0)
    zero = torch.zeros((B, Kb), dtype=torch.float32, device=dev)
    inflow = zero.scatter_add(1, torch.where(move, b, k), mv_w)
    outflow = zero.scatter_add(1, torch.where(move, lab_c, k), mv_w)
    head = L - bw + outflow
    p_in = torch.clamp(head / torch.clamp(inflow, min=1e-9), 0.0, 1.0)
    u2 = _hash_unit(bg, iota[None, :], 1)
    move &= u2 < p_in.gather(1, torch.clamp(b, max=k))
    out = torch.where(move, b, lab64).to(lab.dtype)
    return out[0] if solo else out


def balance_rounds_device(nw, lab, region, n, k: int, Lmax, seed, *, Kb: int,
                          rounds: int):
    """Region-masked synchronous balance-repair rounds: an overloaded block
    sheds ~1.5x its excess weight in expectation, carried by region nodes
    only, into the globally lightest block, whose synchronous inflow is
    capped at its own headroom.  ``seed`` is one int per lane.  Returns new
    labels."""
    solo, (nw, lab, region) = _rows(nw, lab, region)
    dev = lab.device
    B, Ab = lab.shape
    seeds = [int(s) for s in np.atleast_1d(np.asarray(seed))]
    n_t = _lane(n, dev, torch.int64)
    L = _lane(np.asarray(Lmax, np.float32), dev, torch.float32)
    iota = torch.arange(Ab, dtype=torch.int64, device=dev)
    kio = torch.arange(Kb, dtype=torch.int64, device=dev)
    live = (iota < n_t) & region
    lab64 = lab.to(torch.int64)
    zero = torch.zeros((B, Kb), dtype=torch.float32, device=dev)
    for r in range(int(rounds)):
        lab_c = torch.clamp(lab64, max=Kb - 1)
        lab_k = torch.clamp(lab64, max=k)
        bw = zero.scatter_add(1, lab_c, nw)
        bwx = torch.where(kio < k, bw, float("inf"))
        tgt = torch.argmin(bwx, dim=1, keepdim=True)
        over = bwx > L
        movable = live & over.gather(1, lab_k) & (lab64 != tgt)
        # shed ~1.5x the excess WEIGHT in expectation
        movw = zero.scatter_add(1, torch.where(movable, lab_c, k),
                                torch.where(movable, nw, 0.0))
        excess = torch.clamp(torch.where(kio < k, bw, 0.0) - L, min=0.0)
        p_shed = torch.clamp(1.5 * excess / torch.clamp(movw, min=1e-9), 0.0, 1.0)
        base_r = _lane([hash_u32_scalar(hash_base_u32(s, r, TAG_DYN_BAL), 0x9E3779B1)
                        for s in seeds], dev, torch.int64)
        u = _hash_unit(base_r, iota[None, :], 0)
        mv = movable & (u < p_shed.gather(1, lab_k))
        # cap the lightest block's inflow at its headroom (every mover of a
        # round targets the same block)
        inflow = torch.where(mv, nw, 0.0).sum(dim=1, keepdim=True)
        p_in = torch.clamp((L - bw.gather(1, tgt)) / torch.clamp(inflow, min=1e-9),
                           0.0, 1.0)
        u2 = _hash_unit(base_r, iota[None, :], 1)
        mv &= u2 < p_in
        lab64 = torch.where(mv, tgt, lab64)
    out = lab64.to(lab.dtype)
    return out[0] if solo else out


@dataclass
class RepairLane:
    """One graph's region repair, staged for :func:`repair_lanes` by
    :meth:`~repro_torch.core.engine.LPEngine.repair_lane`."""

    labels: torch.Tensor        # (A,) int32 arena labels
    nw: torch.Tensor            # (A,) float32 arena node weights, 0 beyond n
    indptr: torch.Tensor        # (>= n + 1,) int64 CSR row pointers
    src: torch.Tensor           # (M,) int64 arcs; padding arcs carry weight 0
    dst: torch.Tensor           # (M,) int64
    ew: torch.Tensor            # (M,) float32
    n: int
    U: float                    # the balance bound L_max
    seed: int
    cap: int                    # hop degree cap (0x7FFFFFFF: none)
    touched: np.ndarray         # unique touched ids in [0, n)
    pack: Tuple[int, int, int]  # the engine's (chunk nodes, edge request, block)


class LaneRepairs(NamedTuple):
    """What :func:`repair_lanes` returns, lane by lane."""

    labels: List[torch.Tensor]  # kept (A,) labels: the input tensor if rejected
    sizes: List[int]            # region sizes
    cuts: List[float]           # cut of the kept labels
    bws: List[np.ndarray]       # (k,) float32 block weights of the kept labels
    ews: np.ndarray             # (T,) float32 half the arc weight
    E: int                      # the edge bucket the region packs took
    h2d: int                    # bytes uploaded and downloaded
    d2h: int


def repair_lanes(lanes: Sequence[RepairLane], k: int, *, hops: int, iters: int,
                 gain_rounds: int, balance_rounds: int, E: int,
                 note: Callable[..., None]) -> LaneRepairs:
    """The region repair of ``T`` staged lanes — a session's (``T = 1``) or
    a ``SessionGroup`` bucket's — in one launch sequence: expand the
    regions, plan each region pack on the host (O(region)), gather them
    from the resident CSRs, sweep in refine mode against the exact global
    block weights and ``U = L_max``, run the gain and balance rounds, then
    guard: a lane keeps its repaired labels only if its cut did not worsen
    and its balance bound did not degrade, or if they restored a violated
    bound.  Every lane's cuts and block weights come down in one download.

    Lanes share one shape bucket (``A``, arc and row-pointer lengths, pack
    geometry).  One lane passes views (a stacked copy of a large graph's
    arcs would cost as much as the arcs); several are stacked.  ``E`` is
    the caller's sticky edge bucket, raised and returned; ``note(stage, T,
    *dims)`` takes each program's shape for the caller's own key scheme.
    Every lane touches a node, so no region is empty."""
    T = len(lanes)
    lane0 = lanes[0]
    dev = lane0.labels.device
    A = lane0.labels.shape[0]
    Np, e_req, block = lane0.pack
    Kb = k + 1
    ns = [ln.n for ln in lanes]
    Us = [ln.U for ln in lanes]
    seeds = [ln.seed for ln in lanes]
    lab, nw, ip, src, dst, ew = (
        torch.stack([getattr(ln, f) for ln in lanes]) if T > 1 else getattr(lane0, f)[None]
        for f in ("labels", "nw", "indptr", "src", "dst", "ew"))
    M, ipb = src.shape[1], ip.shape[1]
    # ---- h-hop affected regions (device frontier expansion) ----
    Tb = pow2(max(max(ln.touched.size, 8) for ln in lanes))
    tp = np.empty((T, Tb), np.int64)
    for i, ln in enumerate(lanes):
        tp[i] = ln.n
        tp[i, : ln.touched.size] = ln.touched
    note("expand", T, Tb, M, ipb, A)
    with _obs_span("repair.expand", cat="repair",
                   touched=sum(int(ln.touched.size) for ln in lanes), hops=int(hops)):
        mask = expand_region_device(torch.from_numpy(tp).to(dev), src, dst, ip, ns,
                                    hops, [ln.cap for ln in lanes], A=A)
        mask_np = mask.cpu().numpy()
    # ---- region packs: host O(region) plans, one device O(region m) gather
    with _obs_span("pack.plan", cat="pack", n=int(mask_np.sum())):
        orders = [np.random.default_rng(ln.seed).permutation(
            np.flatnonzero(mask_np[i, : ln.n])).astype(np.int64)
            for i, ln in enumerate(lanes)]
        opad = np.zeros((T, max(max(o.size for o in orders), 1)), np.int64)
        for i, o in enumerate(orders):
            opad[i, : o.size] = o
        # region degrees gathered on the device: O(region) is all the plan needs
        o_d = torch.from_numpy(opad).to(dev)
        deg = (ip.gather(1, o_d + 1) - ip.gather(1, o_d)).cpu().numpy()
        plans = [plan_region_pack(deg[i, : o.size], o, ns[i], max_nodes=Np,
                                  max_edges=e_req, block=block)
                 for i, o in enumerate(orders)]
        Cb = pow2(max(p[2] for p in plans))
        E = max(E, -(-max(p[4] for p in plans) // 512) * 512)
        nodes = np.empty((T, Cb, Np), np.int64)
        nv = np.zeros((T, Cb, Np), bool)
        for i, (nd, valid, C, N, _) in enumerate(plans):
            nodes[i] = ns[i]
            nodes[i, :C, :N] = nd
            nv[i, :C, :N] = valid
    with _obs_span("pack.upload", cat="pack"):
        nodes_d = torch.from_numpy(nodes).to(dev)
        nv_d = torch.from_numpy(nv).to(dev)
    sizes = [int(o.size) for o in orders]
    note("gather", T, Cb, Np, ipb, M, E)
    with _obs_span("repair.gather", cat="repair", region=sum(sizes)) as sp:
        pack = gather_pack_device(nodes_d, nv_d, ip, dst, ew,
                                  torch.tensor(ns, device=dev), E=E)
        sp.sync_on(pack[3])
    _mem_account("chunk_packs", nodes_d, nv_d, *pack, mask)
    # ---- LP sweep against exact global block weights ----
    bw0 = block_weights_dense(lab, nw, Kb)
    w0 = bw0.clone()
    w0[:, k] = float("inf")
    pack = (nodes_d, nv_d, *pack)
    if T == 1:      # one lane sweeps the unbatched pack: its chunks are views
        pack = tuple(t[0] for t in pack)
    note("sweep", T, Cb, Np, E, A, Kb, iters)
    with _obs_span("repair.sweep", cat="repair", iters=int(iters)) as sp:
        out, _, _ = lp_sweep_batched(
            *pack, lab, w0, nw, torch.zeros(1, dtype=torch.int32, device=dev),
            Us, [s & 0x7FFFFFFF for s in seeds], k, [p[2] for p in plans],
            iters=iters, refine_mode=True, use_restrict=False, permute_chunks=True,
        )
        sp.sync_on(out)
    # ---- region-masked gain + balance rounds ----
    with _obs_span("repair.gain", cat="repair", rounds=int(gain_rounds)) as sp:
        if gain_rounds:
            note("gain", T, A, M, Kb)
        for r in range(gain_rounds):
            out = gain_round_device(
                src, dst, ew, nw, out, mask, ns, k, Us,
                [hash_base_u32(s, r, TAG_DYN_GAIN) for s in seeds],
                [hash_base_u32(s, r, TAG_DYN_GAIN_GATE) for s in seeds], Kb=Kb,
            )
        sp.sync_on(out)
    if balance_rounds:
        note("balance", T, A, Kb, balance_rounds)
        with _obs_span("repair.balance", cat="repair",
                       rounds=int(balance_rounds)) as sp:
            out = balance_rounds_device(nw, out, mask, ns, k, Us,
                                        [s & 0x7FFFFFFF for s in seeds], Kb=Kb,
                                        rounds=balance_rounds)
            sp.sync_on(out)
    # ---- guard, every lane's cuts and block weights in one download ----
    note("score", T, M, A, Kb)
    scal = torch.cat([
        cut_from_arcs(lab, src, dst, ew)[:, None],
        cut_from_arcs(out, src, dst, ew)[:, None],
        ew.sum(dim=1, keepdim=True) / 2.0, bw0[:, :k],
        block_weights_dense(out, nw, Kb)[:, :k],
    ], dim=1).cpu().numpy()
    kept, cuts, bws = [], [], []
    for i, ln in enumerate(lanes):
        cut0, cut1 = float(scal[i, 0]), float(scal[i, 1])
        bw_old, bw_new = scal[i, 3:3 + k], scal[i, 3 + k:]
        old, new = float(bw_old.max()), float(bw_new.max())
        ok = (cut1 <= cut0 and new <= max(old, ln.U + 1e-6)) or old > ln.U >= new
        kept.append(out[i] if ok else ln.labels)
        cuts.append(cut1 if ok else cut0)
        bws.append(bw_new if ok else bw_old)
    return LaneRepairs(
        labels=kept, sizes=sizes, cuts=cuts, bws=bws, ews=scal[:, 2], E=E,
        h2d=tp.nbytes + opad.nbytes + nodes.nbytes + nv.nbytes,
        d2h=mask_np.nbytes + deg.nbytes + scal.nbytes,
    )
