"""Initial partitioning helpers for the coarsest graph (numpy copy of
``repro.core.initial_partition``): greedy graph growing and the final
feasibility repair.
"""

from __future__ import annotations

import numpy as np

from ..graph.csr import GraphNP
from .metrics import block_weights_np

__all__ = ["greedy_growing", "repair_balance"]


def greedy_growing(g: GraphNP, k: int, Lmax: float, seed: int = 0) -> np.ndarray:
    """Grow k blocks from degree-biased random seeds under the balance bound:
    each unassigned frontier node joins the eligible adjacent block with
    the strongest connection."""
    rng = np.random.default_rng(seed)
    n = g.n
    if k >= n:
        # degenerate coarsest graph: every node founds its own block
        # round-robin (blocks >= n stay empty)
        return (np.arange(n) % max(k, 1)).astype(np.int32)
    labels = np.full(n, -1, dtype=np.int64)
    deg = g.degrees().astype(np.float64)
    # degree-biased seeds: grow from inside components, not isolated nodes
    p = (deg + 1.0) / (deg + 1.0).sum()
    seeds = rng.choice(n, size=k, replace=False, p=p)
    labels[seeds] = np.arange(k)
    bw = g.nw[seeds].astype(np.float64).copy()

    src = g.arc_sources()
    for _ in range(n):  # at most n frontier rounds
        unassigned = labels < 0
        if not unassigned.any():
            break
        # arcs from unassigned -> assigned
        m = unassigned[src] & (labels[g.indices] >= 0)
        if not m.any():
            # frontier died (disconnected graph): reseed the lightest block at
            # the highest-degree unassigned node; isolated leftovers go to
            # the lightest block (bin packing, no cut cost)
            rest = np.flatnonzero(unassigned)
            if deg[rest].max() == 0:
                for v in rest[np.argsort(-g.nw[rest], kind="stable")]:
                    b = int(np.argmin(bw))
                    labels[v] = b
                    bw[b] += g.nw[v]
                break
            v = rest[int(np.argmax(deg[rest] + rng.random(rest.size)))]
            b = int(np.argmin(bw))
            labels[v] = b
            bw[b] += g.nw[v]
            continue
        fsrc = src[m]
        flbl = labels[g.indices[m]]
        fw = g.ew[m].astype(np.float64)
        conn = np.zeros((n, k))
        np.add.at(conn, (fsrc, flbl), fw)
        frontier = np.unique(fsrc)
        rng.shuffle(frontier)
        for v in frontier:  # sequential for exact balance accounting
            c = conn[v] + rng.random(k) * 0.49
            c[bw + g.nw[v] > Lmax] = -np.inf
            b = int(np.argmax(c))
            if c[b] == -np.inf:
                continue  # no block fits; retry next round
            labels[v] = b
            bw[b] += g.nw[v]
        if (labels[frontier] < 0).all():
            # everything blocked on balance: relax by assigning to lightest
            for v in frontier:
                b = int(np.argmin(bw))
                labels[v] = b
                bw[b] += g.nw[v]
    return labels.astype(np.int32)


def repair_balance(
    g: GraphNP, labels: np.ndarray, k: int, Lmax: float, seed: int = 0
) -> np.ndarray:
    """Force feasibility: move lowest-internal-connection nodes out of
    overloaded blocks into the lightest block that fits."""
    labels = labels.astype(np.int64).copy()
    bw = block_weights_np(g, labels, k).astype(np.float64)
    if bw.max() <= Lmax:
        return labels.astype(np.int32)
    src = g.arc_sources()
    internal = np.zeros(g.n)
    same = labels[src] == labels[g.indices]
    np.add.at(internal, src[same], g.ew[same])
    order = np.argsort(internal, kind="stable")  # cheapest-to-move first
    for v in order:
        b = labels[v]
        if bw[b] <= Lmax:
            continue
        tgt = int(np.argmin(bw))
        if bw[tgt] + g.nw[v] > Lmax or tgt == b:
            continue
        labels[v] = tgt
        bw[b] -= g.nw[v]
        bw[tgt] += g.nw[v]
        if bw.max() <= Lmax:
            break
    return labels.astype(np.int32)
