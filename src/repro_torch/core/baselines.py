"""Baseline partitioners the paper compares against (numpy copy of
``repro.core.baselines``).

* :func:`hash_partition` — the hash-based strategy of cloud graph toolkits:
  acceptable balance, a very high cut (paper §II-B).
* :func:`random_balanced` — perfectly balanced random assignment.
* :func:`matching_multilevel` — the ParMetis stand-in: classic multilevel
  with *heavy-edge-matching* coarsening, greedy-growing initial
  partitioning and the same LP refinement as our system, so the two differ
  only in the coarsening scheme — the paper's claim under test: matching
  cannot shrink complex networks (a star of degree d matches one of its d
  edges per round), while cluster contraction shrinks them by orders of
  magnitude.

Everything is host numpy, as in the reference, except the refinement of
levels of 200,000 nodes or more: the chunked :func:`lp_refine` on the
device that :func:`matching_multilevel` resolves on entry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List

import numpy as np

from ..device import resolve_device
from ..graph.csr import GraphNP
from .contraction import contract, project_labels
from .initial_partition import greedy_growing, repair_balance
from .label_propagation import lp_refine, sclap_numpy
from .metrics import cut_np, imbalance_np, lmax

__all__ = ["hash_partition", "random_balanced", "matching_multilevel", "BaselineReport"]

#: Levels at or above this many nodes are refined on the device.
DEVICE_REFINE_MIN_N = 200_000


def hash_partition(n: int, k: int) -> np.ndarray:
    """Block of node i: a splitmix-style mix of i, mod k (numpy's wrapping
    uint64 multiplies; torch has no full uint64 arithmetic)."""
    ids = np.arange(n, dtype=np.uint64)
    h = ids * np.uint64(0x9E3779B97F4A7C15)
    h ^= h >> np.uint64(29)
    h *= np.uint64(0xBF58476D1CE4E5B9)
    h ^= h >> np.uint64(32)
    return (h % np.uint64(k)).astype(np.int32)


def random_balanced(n: int, k: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    lab = np.arange(n, dtype=np.int64) % k
    rng.shuffle(lab)
    return lab.astype(np.int32)


def _hem_round(g: GraphNP, match: np.ndarray, rng, heavy: bool = True) -> np.ndarray:
    """One handshaking round of heavy-edge (or random) matching."""
    n = g.n
    src = g.arc_sources().astype(np.int64)
    dst = g.indices.astype(np.int64)
    free = match < 0
    ok = free[src] & free[dst]
    if not ok.any():
        return match
    base = g.ew.astype(np.float64) if heavy else np.ones(g.m)
    w = base + rng.random(g.m) * (0.49 if heavy else 1.0)
    w = np.where(ok, w, -1.0)
    # per-source heaviest arc: sort by (src, -w), take first per src
    order = np.lexsort((-w, src))
    s_sorted = src[order]
    first = np.ones(s_sorted.shape[0], dtype=bool)
    first[1:] = s_sorted[1:] != s_sorted[:-1]
    cand_src = s_sorted[first]
    cand_dst = dst[order][first]
    cand_w = w[order][first]
    proposal = np.full(n, -1, dtype=np.int64)
    good = cand_w > 0
    proposal[cand_src[good]] = cand_dst[good]
    # mutual proposals are matched
    v = np.flatnonzero(proposal >= 0)
    mutual = proposal[proposal[v]] == v
    a = v[mutual]
    match = match.copy()
    match[a] = proposal[a]
    return match


@dataclass
class BaselineReport:
    labels: np.ndarray
    cut: float
    imbalance: float
    level_sizes: List[tuple]
    shrink_first: float
    coarsening_stalled: bool
    seconds: float


def matching_multilevel(
    g: GraphNP,
    k: int,
    eps: float = 0.03,
    seed: int = 0,
    coarsest_factor: int = 200,
    refine_iters: int = 6,
    max_levels: int = 64,
    stall: float = 0.97,
    *,
    device=None,
) -> BaselineReport:
    """Heavy-edge-matching multilevel partition of ``g`` into ``k`` blocks.

    Runs the refinement of large levels on CUDA unless ``device`` says
    otherwise, and raises without a CUDA device even when no level is that
    large."""
    dev = resolve_device(device)
    t0 = time.time()
    rng = np.random.default_rng(seed)
    L = lmax(g.total_node_weight, k, eps)
    coarsest_target = coarsest_factor * k

    hierarchy = []
    gg = g
    stalled = False
    shrink_first = 1.0
    for lev in range(max_levels):
        if gg.n <= coarsest_target:
            break
        match = np.full(gg.n, -1, dtype=np.int64)
        for _ in range(3):  # a few handshake rounds per level
            match = _hem_round(gg, match, rng, heavy=True)
        # ParMetis-style fallback: random matching among still-free nodes
        match = _hem_round(gg, match, rng, heavy=False)
        pair_label = np.where(
            match >= 0, np.minimum(np.arange(gg.n), match), np.arange(gg.n)
        )
        coarse, C = contract(gg, pair_label)
        if coarse.n >= stall * gg.n:
            stalled = True  # matching cannot shrink further (paper's ParMetis)
            break
        hierarchy.append((gg, C))
        if lev == 0:
            shrink_first = coarse.n / max(gg.n, 1)
        gg = coarse
    level_sizes = [(h[0].n, h[0].m) for h in hierarchy] + [(gg.n, gg.m)]

    lab = greedy_growing(gg, k, L, seed=seed)
    lab = sclap_numpy(
        gg, lab, U=L, iters=refine_iters, seed=seed, refine_mode=True, num_labels=k
    ).labels
    for gg_f, C in reversed(hierarchy):
        lab = project_labels(lab, C)
        if gg_f.n < DEVICE_REFINE_MIN_N:
            lab = sclap_numpy(
                gg_f, lab, U=L, iters=refine_iters, seed=seed,
                refine_mode=True, num_labels=k,
            ).labels
        else:  # keep the baseline's host refinement tractable
            lab = lp_refine(gg_f, lab, k=k, U=L, iters=refine_iters, seed=seed,
                            device=dev).labels
    lab = repair_balance(g, lab, k, L, seed=seed)
    return BaselineReport(
        labels=lab,
        cut=cut_np(g, lab),
        imbalance=imbalance_np(g, lab, k),
        level_sizes=level_sizes,
        shrink_first=shrink_first,
        coarsening_stalled=stalled,
        seconds=time.time() - t0,
    )
