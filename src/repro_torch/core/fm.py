"""Gain-based k-way local search (FM-style) for small graphs (numpy copy of
``repro.core.fm``).

KaFFPaE's combine runs a strong multilevel partitioner per individual; the
coarsest levels, which are small and replicated, get classic
Fiduccia–Mattheyses search instead: greedy best-gain moves under the
balance bound, hill-climbing through negative-gain plateaus with rollback
to the best state seen, node locking per pass.
"""

from __future__ import annotations

import heapq

import numpy as np

from ..graph.csr import GraphNP
from .label_propagation import hash_jitter_np, hash_unit_np
from .metrics import block_weights_np

__all__ = ["fm_refine", "gain_round_np"]


def gain_round_np(
    src: np.ndarray,
    dst: np.ndarray,
    ew: np.ndarray,
    nw: np.ndarray,
    labels: np.ndarray,
    n: int,
    k: int,
    Kb: int,
    Lmax,
    base_score: int,
    base_gate: int,
    region: np.ndarray | None = None,
    influx_gate: bool = False,
) -> np.ndarray:
    """One synchronous best-gain move round (the FM-lite step of the batched
    evolutionary refinement).  All nodes see the same stale state and move
    together: eligibility is a strict connection gain under the balance
    bound, tie-broken by stateless hash jitter and damped by a 0.5 move
    gate.  ``region`` restricts the movers; ``influx_gate`` caps each
    block's net synchronous inflow at its headroom in expectation.

    ``labels`` is an arena-sized (``Ab >= n + 1``) int32 array with label
    ``k`` beyond ``n``; arc arrays may carry trailing zero-weight padding.
    """
    Ab = labels.shape[0]
    iota = np.arange(Ab, dtype=np.int32)
    kio = np.arange(Kb, dtype=np.int32)
    conn = np.zeros((Ab, Kb), np.float32)
    np.add.at(conn, (src, labels[dst]), ew)
    own = conn[iota, np.minimum(labels, Kb - 1)]
    bw = np.zeros(Kb, np.float32)
    np.add.at(bw, labels, nw)
    bwx = np.where(kio < k, bw, np.float32(np.inf)).astype(np.float32)
    jit = hash_jitter_np(base_score, iota[:, None], kio[None, :])
    fits = bwx[None, :] + nw[:, None] <= np.float32(Lmax)
    elig = fits & (kio[None, :] != labels[:, None]) & (conn > own[:, None])
    score = np.where(elig, conn + jit, np.float32(-1e30)).astype(np.float32)
    b = np.argmax(score, axis=1).astype(np.int32)
    has = score[iota, b] > np.float32(-5e29)
    u = hash_unit_np(base_gate, iota, np.int32(0))
    move = has & (u < np.float32(0.5)) & (iota < n)
    if region is not None:
        move &= region
    if influx_gate:
        mv_w = np.where(move, nw, np.float32(0.0)).astype(np.float32)
        inflow = np.zeros(Kb, np.float32)
        outflow = np.zeros(Kb, np.float32)
        np.add.at(inflow, np.where(move, b, k), mv_w)
        np.add.at(outflow, np.where(move, np.minimum(labels, Kb - 1), k), mv_w)
        head = (np.float32(Lmax) - bw + outflow).astype(np.float32)
        with np.errstate(invalid="ignore", over="ignore"):
            p_in = np.clip(
                head / np.maximum(inflow, np.float32(1e-9)),
                np.float32(0.0), np.float32(1.0),
            )
        u2 = hash_unit_np(base_gate, iota, np.int32(1))
        move &= u2 < p_in[np.minimum(b, k)]
    return np.where(move, b, labels).astype(np.int32)


def fm_refine(
    g: GraphNP,
    labels: np.ndarray,
    k: int,
    Lmax: float,
    passes: int = 3,
    max_neg_width: int = 64,
    seed: int = 0,
) -> np.ndarray:
    """k-way FM local search; never returns a worse (feasible) partition."""
    rng = np.random.default_rng(seed)
    n = g.n
    labels = labels.astype(np.int64).copy()
    src = g.arc_sources().astype(np.int64)
    dst = g.indices.astype(np.int64)

    conn = np.zeros((n, k))
    np.add.at(conn, (src, labels[dst]), g.ew)
    bw = block_weights_np(g, labels, k).astype(np.float64)

    def node_best(v):
        """Returns (jittered score for ordering, true gain, target block)."""
        a = labels[v]
        gains = conn[v] - conn[v, a]
        gains[a] = -np.inf
        jittered = gains + rng.random(k) * 1e-3
        fits = bw + g.nw[v] <= Lmax
        fits[a] = False
        masked = np.where(fits, jittered, -np.inf)
        b = int(np.argmax(masked))
        return (masked[b], gains[b] if masked[b] > -np.inf else -np.inf, b)

    cur_cut = float(g.ew.sum() / 2.0 - conn[np.arange(n), labels].sum() / 2.0)

    for _ in range(passes):
        improved = False
        boundary = np.unique(src[labels[src] != labels[dst]])
        if boundary.size == 0:
            break
        locked = np.zeros(n, dtype=bool)
        heap = []
        for v in boundary:
            score, _, b = node_best(v)
            if score > -np.inf:
                heapq.heappush(heap, (-score, int(v), b, labels[v]))
        best_cut = cur_cut
        journal = []  # (v, from, to)
        neg_run = 0
        while heap and neg_run < max_neg_width:
            ns, v, b, frm = heapq.heappop(heap)
            if locked[v] or labels[v] != frm:
                continue
            score, gain, b = node_best(v)  # recompute (heap entries go stale)
            if score == -np.inf:
                continue
            if -ns > score + 1e-9:  # stale optimistic entry: reinsert fresh
                heapq.heappush(heap, (-score, v, b, labels[v]))
                continue
            a = labels[v]
            if bw[b] + g.nw[v] > Lmax:
                continue
            labels[v] = b
            bw[a] -= g.nw[v]
            bw[b] += g.nw[v]
            cur_cut -= gain
            journal.append((v, a, b))
            locked[v] = True
            lo, hi = g.indptr[v], g.indptr[v + 1]
            nbr = g.indices[lo:hi]
            w = g.ew[lo:hi]
            np.add.at(conn[:, a], nbr, -w)
            np.add.at(conn[:, b], nbr, +w)
            for u in nbr:
                if not locked[u]:
                    su, _, bu = node_best(u)
                    if su > -np.inf:
                        heapq.heappush(heap, (-su, int(u), bu, labels[u]))
            if cur_cut < best_cut - 1e-9:
                best_cut = cur_cut
                journal.clear()
                improved = True
                neg_run = 0
            else:
                neg_run += 1
        # rollback moves made after the best state
        for v, a, b in reversed(journal):
            labels[v] = a
            bw[b] -= g.nw[v]
            bw[a] += g.nw[v]
            lo, hi = g.indptr[v], g.indptr[v + 1]
            nbr = g.indices[lo:hi]
            w = g.ew[lo:hi]
            np.add.at(conn[:, b], nbr, -w)
            np.add.at(conn[:, a], nbr, +w)
        cur_cut = best_cut
        if not improved:
            break
    return labels.astype(np.int32)
