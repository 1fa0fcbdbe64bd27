"""Modularity graph clustering via the paper's own machinery (numpy copy
of ``repro.core.modularity``; paper §VI: "It will be very interesting to
generalize our algorithm for graph clustering w.r.t. modularity").

Louvain-style multilevel: a sequential modularity-gain label propagation
(local-move) sweep — the SCLaP sweep with the size constraint replaced by
the modularity gain — followed by *our cluster contraction*, repeated until
Q stops improving.  Host numpy over the host :func:`contract`; the draw
order of ``modularity_lp`` (one permutation per sweep, then one
``rng.random`` per visited node) is the reference's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..graph.csr import GraphNP
from .contraction import contract, project_labels

__all__ = ["modularity", "modularity_lp", "louvain"]


def modularity(g: GraphNP, labels: np.ndarray) -> float:
    """Newman modularity Q of a clustering (weighted)."""
    m2 = float(g.ew.sum())  # = 2m for symmetric storage
    if m2 == 0:
        return 0.0
    src = g.arc_sources()
    internal = float(g.ew[labels[src] == labels[g.indices]].sum())
    deg = np.zeros(int(labels.max()) + 1)
    wdeg = np.bincount(src, weights=g.ew, minlength=g.n)
    np.add.at(deg, labels, wdeg)
    return internal / m2 - float((deg / m2) ** 2 @ np.ones_like(deg))


def modularity_lp(
    g: GraphNP, labels: np.ndarray, iters: int = 8, seed: int = 0
) -> np.ndarray:
    """Sequential modularity-gain local moves (the Louvain phase-1 sweep).

    Move v to the neighbouring cluster maximizing
    dQ ∝ k_{v,c} − k_v · Σ_tot(c) / 2m  (resolution 1)."""
    rng = np.random.default_rng(seed)
    labels = labels.astype(np.int64).copy()
    m2 = float(g.ew.sum())
    src = g.arc_sources()
    wdeg = np.bincount(src, weights=g.ew, minlength=g.n).astype(np.float64)
    sigma = np.zeros(g.n, dtype=np.float64)  # cluster total degree
    np.add.at(sigma, labels, wdeg)
    for it in range(iters):
        moved = 0
        for v in rng.permutation(g.n):
            lo, hi = g.indptr[v], g.indptr[v + 1]
            if hi == lo:
                continue
            nbr = g.indices[lo:hi]
            w = g.ew[lo:hi].astype(np.float64)
            own = labels[v]
            cand, inv = np.unique(labels[nbr], return_inverse=True)
            k_vc = np.zeros(cand.shape[0])
            np.add.at(k_vc, inv, w)
            sig = sigma[cand] - np.where(cand == own, wdeg[v], 0.0)
            gain = k_vc - wdeg[v] * sig / m2
            gain += rng.random(cand.shape[0]) * 1e-9
            best = int(np.argmax(gain))
            tgt = int(cand[best])
            own_i = np.nonzero(cand == own)[0]
            if tgt != own and (own_i.size == 0 or gain[best] > gain[own_i[0]] + 1e-12):
                sigma[own] -= wdeg[v]
                sigma[tgt] += wdeg[v]
                labels[v] = tgt
                moved += 1
        if moved == 0:
            break
    return labels


def louvain(g: GraphNP, seed: int = 0, max_levels: int = 20) -> Tuple[np.ndarray, float]:
    """Multilevel modularity clustering (local moves + cluster contraction)."""
    gg = g
    maps = []
    labels = np.arange(g.n, dtype=np.int64)
    for lev in range(max_levels):
        q0 = modularity(gg, np.arange(gg.n))
        lab = modularity_lp(gg, np.arange(gg.n), seed=seed + lev)
        coarse, C = contract(gg, lab)
        if coarse.n == gg.n:
            break
        maps.append(C)
        q1 = modularity(coarse, np.arange(coarse.n))
        gg = coarse
        if q1 <= q0 + 1e-9:
            break
    # project coarsest singleton clustering down the hierarchy
    lab = np.arange(gg.n, dtype=np.int64)
    for C in reversed(maps):
        lab = project_labels(lab, C)
    return lab.astype(np.int32), modularity(g, lab)
