"""Coarse-grained evolutionary algorithm (KaFFPaE, §II-C/IV-E), host path.

Numpy copy of the reference's sequential island GA (``repro.core.
evolutionary.evolve``): every island keeps a population of partitions of
the coarsest graph, applies combine or mutation each generation, and the
global best replaces every island's worst member (gossip).  The combine
protects both parents' cut edges: the overlay cells ``(P1(v), P2(v))`` are
clustered and contracted, the better parent seeds the coarse labels, and
refinement plus elitism never make the child worse than that parent.

The batched device GA (``evo_device`` and its numpy oracle
``evolve_batched_numpy``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..graph.csr import GraphNP
from .contraction import contract, project_labels
from .fm import fm_refine
from .initial_partition import greedy_growing, repair_balance
from .label_propagation import sclap_numpy
from .metrics import block_weights_np, cut_np

__all__ = ["EvoConfig", "evolve"]


@dataclass
class EvoConfig:
    k: int
    Lmax: float
    islands: int = 4            # simulated PEs
    pop_per_island: int = 3
    generations: int = 6
    refine_iters: int = 6
    cluster_iters: int = 2
    f_range: tuple = (10.0, 25.0)
    seed: int = 0
    seed_individuals: List[np.ndarray] = field(default_factory=list)


@dataclass
class _Ind:
    labels: np.ndarray
    cut: float
    feasible: bool


def _fitness_key(ind: _Ind):
    # feasible individuals always beat infeasible ones; then smaller cut
    return (0 if ind.feasible else 1, ind.cut)


def _mk(g: GraphNP, labels: np.ndarray, k: int, Lmax: float) -> _Ind:
    bw = block_weights_np(g, labels, k)
    return _Ind(labels=labels, cut=cut_np(g, labels), feasible=bool(bw.max() <= Lmax + 1e-6))


def _combine(
    g: GraphNP, p1: _Ind, p2: _Ind, cfg: EvoConfig, rng: np.random.Generator
) -> _Ind:
    k, Lmax = cfg.k, cfg.Lmax
    better, other = (p1, p2) if _fitness_key(p1) <= _fitness_key(p2) else (p2, p1)
    overlay = p1.labels.astype(np.int64) * k + p2.labels.astype(np.int64)
    f = rng.uniform(*cfg.f_range)
    U = max(g.nw.max(), Lmax / f)
    seed = int(rng.integers(1 << 30))
    clus = sclap_numpy(
        g, np.arange(g.n), U=U, iters=cfg.cluster_iters, seed=seed,
        restrict=overlay,
    ).labels
    coarse, C = contract(g, clus)
    # apply the better parent: every cluster lies inside one of its blocks
    rep = np.zeros(coarse.n, dtype=np.int64)
    rep[C] = np.arange(g.n)  # any representative fine node per coarse node
    lab_c = better.labels[rep].astype(np.int32)
    lab_c = sclap_numpy(
        coarse, lab_c, U=Lmax, iters=cfg.refine_iters, seed=seed + 1,
        refine_mode=True, num_labels=k,
    ).labels
    child = project_labels(lab_c, C)
    child = sclap_numpy(
        g, child, U=Lmax, iters=cfg.refine_iters, seed=seed + 2,
        refine_mode=True, num_labels=k,
    ).labels
    child = fm_refine(g, child, k, Lmax, seed=seed + 3)
    child = repair_balance(g, child, k, Lmax, seed=seed)
    ind = _mk(g, child, k, Lmax)
    return ind if _fitness_key(ind) <= _fitness_key(better) else better


def _mutate(g: GraphNP, p: _Ind, cfg: EvoConfig, rng: np.random.Generator) -> _Ind:
    """Perturb a boundary region, then refine."""
    k, Lmax = cfg.k, cfg.Lmax
    labels = p.labels.copy()
    src = g.arc_sources()
    boundary = np.unique(src[labels[src] != labels[g.indices]])
    if boundary.size:
        take = rng.choice(boundary, size=max(1, boundary.size // 8), replace=False)
        labels[take] = rng.integers(0, k, take.shape[0])
    seed = int(rng.integers(1 << 30))
    labels = sclap_numpy(
        g, labels, U=Lmax, iters=cfg.refine_iters, seed=seed,
        refine_mode=True, num_labels=k,
    ).labels
    labels = fm_refine(g, labels, k, Lmax, seed=seed + 1)
    labels = repair_balance(g, labels, k, Lmax, seed=seed)
    ind = _mk(g, labels, k, Lmax)
    return ind if _fitness_key(ind) <= _fitness_key(p) else p


def evolve(g: GraphNP, cfg: EvoConfig) -> np.ndarray:
    """Run the island GA; returns the best partition of the coarsest graph."""
    rng = np.random.default_rng(cfg.seed)
    islands: List[List[_Ind]] = []
    for isl in range(cfg.islands):
        pop: List[_Ind] = []
        for j in range(cfg.pop_per_island):
            if cfg.seed_individuals and j == 0:
                # V-cycle seeding: the previous solution joins every island
                seeded = cfg.seed_individuals[isl % len(cfg.seed_individuals)]
                pop.append(_mk(g, seeded.astype(np.int32), cfg.k, cfg.Lmax))
                continue
            s = int(rng.integers(1 << 30))
            lab = greedy_growing(g, cfg.k, cfg.Lmax, seed=s)
            lab = sclap_numpy(
                g, lab, U=cfg.Lmax, iters=cfg.refine_iters, seed=s,
                refine_mode=True, num_labels=cfg.k,
            ).labels
            lab = fm_refine(g, lab, cfg.k, cfg.Lmax, seed=s + 1)
            lab = repair_balance(g, lab, cfg.k, cfg.Lmax, seed=s)
            pop.append(_mk(g, lab, cfg.k, cfg.Lmax))
        islands.append(pop)

    for gen in range(cfg.generations):
        for pop in islands:
            if rng.random() < 0.7 and len(pop) >= 2:
                i, j = rng.choice(len(pop), size=2, replace=False)
                child = _combine(g, pop[i], pop[j], cfg, rng)
            else:
                child = _mutate(g, pop[int(rng.integers(len(pop)))], cfg, rng)
            worst = int(np.argmax([_fitness_key(x)[1] + 1e18 * _fitness_key(x)[0] for x in pop]))
            if _fitness_key(child) <= _fitness_key(pop[worst]):
                pop[worst] = child
        # gossip: global best replaces every island's worst (rumor spreading)
        best = min((ind for pop in islands for ind in pop), key=_fitness_key)
        for pop in islands:
            worst = int(np.argmax([_fitness_key(x)[1] + 1e18 * _fitness_key(x)[0] for x in pop]))
            if _fitness_key(best) < _fitness_key(pop[worst]):
                pop[worst] = best

    best = min((ind for pop in islands for ind in pop), key=_fitness_key)
    return best.labels
