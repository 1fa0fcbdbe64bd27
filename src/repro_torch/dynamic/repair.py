"""Incremental repair rounds (dynamic subsystem, layer 2) — the torch twin
of ``repro.dynamic.repair``.

After a batch of edge/node updates only the h-hop neighbourhood of the
touched endpoints can profit from moving, so the repairer

1. expands the **affected region** (:func:`expand_region_device`: a
   frontier scatter per hop over the resident arc tensors; hops past the
   first only expand through nodes of degree <= ``deg_cap``),
2. runs the chunked LP sweep over a *region pack* against exact global
   block weights (:meth:`repro_torch.core.engine.LPEngine.repair`),
3. finishes with region-masked synchronous **gain** rounds
   (:func:`gain_round_device`, op for op ``fm.gain_round_np(region=...,
   influx_gate=True)``) and **balance-repair** rounds
   (:func:`balance_rounds_device`).

Every function here works on an explicit leading lane axis: its tensors
are ``(B, ...)`` and its per-lane scalars (``n``, ``deg_cap``, ``Lmax``,
hash bases, seeds) sequences of length ``B``, so one launch sequence
serves all lanes of a ``SessionGroup`` bucket.  A solo caller passes
unbatched tensors and python scalars and gets unbatched results (the
``B = 1`` case).  The reference's ``lax.fori_loop`` over hops and rounds is
a Python loop; its ``mode="drop"`` scatters target indices that are always
in range here (block ``k`` of a ``k + 1``-wide block axis), and its clamped
gathers are clamped explicitly.  ``torch.argmax``/``argmin`` return the
first extreme index, as ``jnp.argmax``/``argmin`` do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.label_propagation import hash_base_u32, hash_jitter, hash_mix, hash_u32_scalar

__all__ = [
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
