"""Coarse-grained evolutionary algorithm (KaFFPaE, §II-C/IV-E), host path.

Numpy copy of the reference's sequential island GA (``repro.core.
evolutionary.evolve``): every island keeps a population of partitions of
the coarsest graph, applies combine or mutation each generation, and the
global best replaces every island's worst member (gossip).  The combine
protects both parents' cut edges: the overlay cells ``(P1(v), P2(v))`` are
clustered and contracted, the better parent seeds the coarse labels, and
refinement plus elitism never make the child worse than that parent.

The batched GA runs the same island model on the whole population at
once (:mod:`.evo_device`, driven by ``LPEngine.evolve_device``).  Its
sequential numpy oracle, :func:`evolve_batched_numpy`, is a copy of the
reference's and makes the same decisions one individual at a time: every
tie-break, gate and float32 operation matches the batched step bit for bit
on integral weights (whose float32 sums are exact in any order).  The
constants and hash tags below are shared by both.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..graph.csr import GraphNP, pow2
from .contraction import contract, project_labels
from .fm import fm_refine, gain_round_np
from .initial_partition import greedy_growing, repair_balance
from .label_propagation import (
    hash_base_u32,
    hash_jitter_np,
    hash_u32_np,
    hash_unit_np,
    sclap_numpy,
    sweep_refine_numpy,
)
from .metrics import block_weights_np, cut_np

__all__ = ["EvoConfig", "EvoInputs", "evolve", "evolve_batched_numpy"]


# --------------------------------------------------------------------------
# Batched-evolution constants, shared by the batched step (evo_device) and
# the numpy oracle below; the reference's values, which parity requires.
# --------------------------------------------------------------------------

GROW_ROUNDS = 16        # frontier-round FLOOR (see grow_rounds_bound)
CELL_ROUNDS = 2         # overlay-cell move rounds inside combine
GAIN_ROUNDS = 2         # synchronous best-gain (FM-lite) rounds per refine
REPAIR_ROUNDS = 3       # synchronous balance-repair rounds per refine
MUTATE_FRAC = 0.125     # boundary-node flip probability under mutation
COMBINE_PROB = 0.7      # combine-vs-mutate draw per island per generation
INFEAS_PENALTY = 1 << 30  # int32 fitness-key offset for infeasible labels

# hash-stream tags: every random decision draws from a stateless uint32
# stream keyed (seed, phase, tag, context, coordinates) — identical in both
# implementations, invariant to array padding
TAG_SEEDKEY = 0x5EED01      # greedy seed scoring
TAG_GROW = 0x5EED02         # growth-round tie-breaks
TAG_SWEEP = 0x5EED03        # per-individual LP sweep seed derivation
TAG_GAIN = 0x5EED04         # gain-round tie-breaks
TAG_GAIN_GATE = 0x5EED05    # gain-round move gate
TAG_REPAIR = 0x5EED06       # repair-round move gate
TAG_OP = 0x5EED07           # combine-vs-mutate draw
TAG_P1 = 0x5EED08           # first parent index
TAG_P2 = 0x5EED09           # second parent offset
TAG_MUT_FLIP = 0x5EED0A     # mutation boundary flips
TAG_MUT_LBL = 0x5EED0B      # mutation replacement labels
TAG_CELL = 0x5EED0C         # cell-move tie-breaks
TAG_CELL_GATE = 0x5EED0D    # cell-move gate


def grow_rounds_bound(n: int, k: int, m: int) -> int:
    """Frontier-round budget for batched greedy growing (shared by the
    device path and the numpy oracle — both must use the same bound).

    BFS from k seeds needs ~seed-eccentricity rounds; the legacy fixed
    ``GROW_ROUNDS = 16`` truncated deep (high-diameter, low-average-degree)
    coarsest graphs and dumped the unreached tail into round-robin
    leftovers — terrible cuts on path-like graphs.  The budget now scales
    with a degree-based diameter proxy (low average degree == deep graph),
    floored at the legacy constant and capped at ``n``.  The cap is never
    the binding *cost*: both implementations exit as soon as every node is
    assigned or a round makes no progress — a stalled frontier can never
    recover, because assignments are the only state a growth round reads.
    """
    if n <= 0:
        return GROW_ROUNDS
    avg_deg = m / n
    proxy = int(np.ceil(4.0 * n / max(k, 1) / max(avg_deg, 1.0)))
    return int(min(max(GROW_ROUNDS, proxy), n))


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


# --------------------------------------------------------------------------
# Batched-evolution numpy oracle
#
# One individual at a time, on the same inputs the batched step reads (the
# engine's chunk pack and arc arrays): the same hashes, float32 operations,
# selection and gossip order, so the two agree bit for bit.
# --------------------------------------------------------------------------


@dataclass
class EvoInputs:
    """Host (numpy) view of everything one evolution run reads.

    Pack arrays are bucket-padded exactly as dispatched on device (padding is
    semantically inert — see graph/packing.py); arc arrays may carry trailing
    zero-weight padding.  ``nw`` and ``deg`` are arena-sized (``Ab`` slots,
    inert beyond ``n``).
    """

    nodes: np.ndarray           # (C, N) int32
    node_valid: np.ndarray      # (C, N) bool
    edge_dst: np.ndarray        # (C, E) int32
    edge_w: np.ndarray          # (C, E) float32
    edge_src_slot: np.ndarray   # (C, E) int32
    edge_valid: np.ndarray      # (C, E) bool
    num_chunks: int
    src: np.ndarray             # (>= m,) int32 arc sources (pad: node 0, w 0)
    dst: np.ndarray             # (>= m,) int32 arc heads
    ew: np.ndarray              # (>= m,) float32
    nw: np.ndarray              # (Ab,) float32, 0 beyond n
    deg: np.ndarray             # (Ab,) int32, 0 beyond n
    n: int

    @property
    def Ab(self) -> int:
        return int(self.nw.shape[0])


def _bw_np(lab, nw, k: int, Kb: int):
    """(raw, +inf-padded) block-weight vectors of one individual."""
    bw = np.zeros(Kb, np.float32)
    np.add.at(bw, lab, nw)
    bwx = np.where(np.arange(Kb) < k, bw, np.float32(np.inf)).astype(np.float32)
    return bw, bwx


def _evaluate_np(inp: EvoInputs, lab, k: int, Kb: int, Lmax) -> tuple:
    """int32 fitness key (feasibility-first, then cut; exact for integral
    weights), plus (cut, feasible)."""
    diff = lab[inp.src] != lab[inp.dst]
    cut = np.where(diff, inp.ew, np.float32(0.0)).astype(np.float32).sum(
        dtype=np.float32
    ) / np.float32(2.0)
    _, bwx = _bw_np(lab, inp.nw, k, Kb)
    bwmax = np.max(np.where(np.arange(Kb) < k, bwx, np.float32(-np.inf)))
    feas = bool(bwmax <= np.float32(Lmax) + np.float32(1e-6))
    key = int(np.int32(cut)) + (0 if feas else INFEAS_PENALTY)
    return key, float(cut), feas


def _greedy_grow_np(inp: EvoInputs, s: int, seed: int, k: int, Kb: int, Lmax):
    """Batched greedy growing, one individual: hash-scored degree-biased
    seeds, degree/diameter-proportional synchronous frontier rounds
    (:func:`grow_rounds_bound`), round-robin leftovers."""
    n, Ab = inp.n, inp.Ab
    iota = np.arange(Ab, dtype=np.int32)
    kio = np.arange(Kb, dtype=np.int32)
    unit = hash_unit_np(hash_base_u32(seed, 0, TAG_SEEDKEY), iota, np.int32(s))
    skey = np.where(
        iota < n,
        unit * (inp.deg.astype(np.float32) + np.float32(1.0)),
        np.float32(-np.inf),
    ).astype(np.float32)
    order = np.argsort(-skey, kind="stable")
    rank = np.zeros(Ab, np.int32)
    rank[order] = iota
    lab = np.where((rank < k) & (iota < n), rank, np.int32(-1)).astype(np.int32)
    rounds = grow_rounds_bound(n, k, int(inp.deg[:n].sum()))
    prev_cnt = None
    for r in range(rounds):
        unas = (lab < 0) & (iota < n)
        cnt = int(unas.sum())
        if cnt == 0 or cnt == prev_cnt:
            break  # converged / stalled: further rounds are no-ops (the
            # device while_loop exits on exactly these conditions)
        prev_cnt = cnt
        conn = np.zeros((Ab, Kb), np.float32)
        tgt = lab[inp.dst]
        mask = tgt >= 0
        np.add.at(conn, (inp.src[mask], tgt[mask]), inp.ew[mask])
        asg = lab >= 0
        bw = np.zeros(Kb, np.float32)
        np.add.at(bw, lab[asg], inp.nw[asg])
        bwx = np.where(kio < k, bw, np.float32(np.inf)).astype(np.float32)
        base_r = int(
            hash_u32_np(hash_base_u32(seed, r, TAG_GROW), np.int32(s), np.int32(0))
        )
        jit = hash_jitter_np(base_r, iota[:, None], kio[None, :])
        fits = bwx[None, :] + inp.nw[:, None] <= np.float32(Lmax)
        elig = (conn > 0) & fits
        score = np.where(elig, conn + jit, np.float32(-1e30)).astype(np.float32)
        b = np.argmax(score, axis=1).astype(np.int32)
        has = score[iota, b] > np.float32(-5e29)
        lab = np.where(unas & has, b, lab).astype(np.int32)
    unas = (lab < 0) & (iota < n)
    pos = np.cumsum(unas.astype(np.int32), dtype=np.int64).astype(np.int32) - 1
    lab = np.where(unas, pos % np.int32(k), lab)
    return np.where(iota < n, lab, np.int32(k)).astype(np.int32)


def _repair_rounds_np(inp: EvoInputs, lab, ctx: int, phase: int, seed: int,
                      k: int, Kb: int, Lmax):
    """REPAIR_ROUNDS synchronous feasibility-repair rounds: overloaded blocks
    shed (in expectation) their excess into the globally lightest block."""
    n, Ab = inp.n, inp.Ab
    iota = np.arange(Ab, dtype=np.int32)
    for r in range(REPAIR_ROUNDS):
        _, bwx = _bw_np(lab, inp.nw, k, Kb)
        if not (bwx[:k] > np.float32(Lmax)).any():
            break  # further device rounds are no-ops
        tgt = np.int32(np.argmin(bwx))
        with np.errstate(invalid="ignore"):
            excess = np.clip(
                (bwx - np.float32(Lmax)) / np.maximum(bwx, np.float32(1.0)),
                np.float32(0.0), np.float32(1.0),
            )
        base_r = int(
            hash_u32_np(
                hash_base_u32(seed, phase, TAG_REPAIR), np.int32(ctx), np.int32(r)
            )
        )
        u = hash_unit_np(base_r, iota, np.int32(0))
        over = bwx > np.float32(Lmax)
        movable = (
            (iota < n)
            & over[np.minimum(lab, k)]
            & (lab != tgt)
            & (bwx[tgt] + inp.nw <= np.float32(Lmax))
        )
        with np.errstate(invalid="ignore"):
            gate = u < np.float32(1.5) * excess[np.minimum(lab, k)]
        lab = np.where(movable & gate, tgt, lab).astype(np.int32)
    return lab


def _mutate_init_np(inp: EvoInputs, lab, i: int, gen: int, seed: int, k: int):
    """Boundary perturbation: flip a hash-chosen eighth of boundary nodes."""
    n, Ab = inp.n, inp.Ab
    iota = np.arange(Ab, dtype=np.int32)
    bnd = np.zeros(Ab, bool)
    np.logical_or.at(bnd, inp.src, lab[inp.src] != lab[inp.dst])
    u = hash_unit_np(
        int(hash_u32_np(hash_base_u32(seed, gen + 1, TAG_MUT_FLIP),
                        np.int32(i), np.int32(0))),
        iota, np.int32(0),
    )
    newl = (
        hash_u32_np(
            int(hash_u32_np(hash_base_u32(seed, gen + 1, TAG_MUT_LBL),
                            np.int32(i), np.int32(0))),
            iota, np.int32(0),
        ) % np.uint32(k)
    ).astype(np.int32)
    flip = bnd & (u < np.float32(MUTATE_FRAC)) & (iota < n)
    return np.where(flip, newl, lab).astype(np.int32)


def _combine_init_np(inp: EvoInputs, lab1, lab2, lab_better, i: int, gen: int,
                     seed: int, k: int, Kb: int, Lmax):
    """Overlay-cell combine: cells = contiguous ids of ``(P1(v), P2(v))``
    (packed-key relabel, np.unique semantics), child seeded from the better
    parent, then CELL_ROUNDS synchronous cell-granular block moves — the
    quotient-level refinement without materializing a quotient graph."""
    n, Ab = inp.n, inp.Ab
    iota = np.arange(Ab, dtype=np.int32)
    kio = np.arange(Kb, dtype=np.int32)
    ov = lab1.astype(np.int64) * k + lab2
    _, cells = np.unique(ov[:n], return_inverse=True)
    cf = np.full(Ab, Ab - 1, np.int32)          # sentinel cell for pad slots
    cf[:n] = cells.astype(np.int32)
    blk_raw = np.full(Ab, -1, np.int32)
    np.maximum.at(blk_raw, cf, np.where(iota < n, lab_better, np.int32(-1)))
    blk = np.where(blk_raw >= 0, blk_raw, np.int32(k)).astype(np.int32)
    cw = np.zeros(Ab, np.float32)
    np.add.at(cw, cf, inp.nw)
    cu = cf[inp.src]
    cv = cf[inp.dst]
    mask = cu != cv
    for r in range(CELL_ROUNDS):
        bw = np.zeros(Kb, np.float32)
        np.add.at(bw, blk, cw)
        bwx = np.where(kio < k, bw, np.float32(np.inf)).astype(np.float32)
        conn = np.zeros((Ab, Kb), np.float32)
        np.add.at(conn, (cu[mask], blk[cv[mask]]), inp.ew[mask])
        own = conn[iota, np.minimum(blk, Kb - 1)]
        jit = hash_jitter_np(
            int(hash_u32_np(hash_base_u32(seed, gen + 1, TAG_CELL),
                            np.int32(i), np.int32(r))),
            iota[:, None], kio[None, :],
        )
        fits = bwx[None, :] + cw[:, None] <= np.float32(Lmax)
        elig = fits & (kio[None, :] != blk[:, None]) & (conn > own[:, None])
        score = np.where(elig, conn + jit, np.float32(-1e30)).astype(np.float32)
        b = np.argmax(score, axis=1).astype(np.int32)
        has = score[iota, b] > np.float32(-5e29)
        u = hash_unit_np(
            int(hash_u32_np(hash_base_u32(seed, gen + 1, TAG_CELL_GATE),
                            np.int32(i), np.int32(r))),
            iota, np.int32(0),
        )
        blk = np.where(has & (u < np.float32(0.5)), b, blk).astype(np.int32)
    return np.where(iota < n, blk[cf], np.int32(k)).astype(np.int32)


def _refine_np(inp: EvoInputs, lab, ctx: int, phase: int, seed: int,
               refine_iters: int, k: int, Kb: int, Lmax):
    """LP chunk sweep + gain rounds + repair rounds (one individual)."""
    sw = int(
        hash_u32_np(hash_base_u32(seed, phase, TAG_SWEEP), np.int32(ctx),
                    np.int32(0))
    ) & 0x7FFFFFFF
    bw = np.zeros(Kb, np.float32)
    np.add.at(bw, lab, inp.nw)
    weights = np.where(
        np.arange(Kb) < k, bw, np.float32(np.inf)
    ).astype(np.float32)
    lab, _ = sweep_refine_numpy(
        inp.nodes, inp.node_valid, inp.edge_dst, inp.edge_w,
        inp.edge_src_slot, inp.edge_valid,
        lab, weights, inp.nw, Lmax, sw, k, inp.num_chunks, refine_iters,
    )
    for r in range(GAIN_ROUNDS):
        base_s = int(
            hash_u32_np(hash_base_u32(seed, phase, TAG_GAIN), np.int32(ctx),
                        np.int32(r))
        )
        base_g = int(
            hash_u32_np(hash_base_u32(seed, phase, TAG_GAIN_GATE),
                        np.int32(ctx), np.int32(r))
        )
        lab = gain_round_np(
            inp.src, inp.dst, inp.ew, inp.nw, lab, inp.n, k, Kb, Lmax,
            base_s, base_g,
        )
    return _repair_rounds_np(inp, lab, ctx, phase, seed, k, Kb, Lmax)


def _worst_member_np(keys, i: int, P: int) -> int:
    """Max fitness key, first index — the replacement victim of island i."""
    return int(np.argmax(np.asarray(keys[i * P:(i + 1) * P])))


def evolve_batched_numpy(
    inp: EvoInputs, cfg: EvoConfig, trace: Optional[list] = None
) -> np.ndarray:
    """Sequential numpy oracle of the batched island GA (device spec twin).

    Returns the best partition (length ``n``) of the coarsest graph.  With
    ``trace`` given, appends ``(gen, island, base_key, child_key)`` per
    offspring *before* elitism — the offspring-never-worse-than-better-parent
    property is then ``min(child_key, base_key) <= base_key`` post-elitism,
    asserted in tests.
    """
    k, Lmax = cfg.k, np.float32(cfg.Lmax)
    Kb = pow2(k + 1)
    I, P, G = cfg.islands, cfg.pop_per_island, cfg.generations
    seed = int(cfg.seed) & 0x7FFFFFFF  # same masking as the device dispatch
    n, Ab = inp.n, inp.Ab
    labs: List[np.ndarray] = []
    keys: List[int] = []
    for s in range(I * P):
        isl, j = divmod(s, P)
        if cfg.seed_individuals and j == 0:
            lab = np.full(Ab, k, np.int32)
            lab[:n] = np.asarray(
                cfg.seed_individuals[isl % len(cfg.seed_individuals)][:n],
                dtype=np.int32,
            )
        else:
            lab = _greedy_grow_np(inp, s, seed, k, Kb, Lmax)
            lab = _refine_np(inp, lab, s, 0, seed, cfg.refine_iters, k, Kb, Lmax)
        labs.append(lab)
        keys.append(_evaluate_np(inp, lab, k, Kb, Lmax)[0])
    for gen in range(G):
        children = []
        for i in range(I):
            u_op = float(
                hash_unit_np(hash_base_u32(seed, gen + 1, TAG_OP),
                             np.int32(i), np.int32(0))
            )
            r1 = int(
                hash_u32_np(hash_base_u32(seed, gen + 1, TAG_P1),
                            np.int32(i), np.int32(0)) % np.uint32(P)
            )
            if P >= 2 and u_op < float(np.float32(COMBINE_PROB)):
                off = 1 + int(
                    hash_u32_np(hash_base_u32(seed, gen + 1, TAG_P2),
                                np.int32(i), np.int32(0))
                    % np.uint32(max(P - 1, 1))
                )
                p1, p2 = i * P + r1, i * P + (r1 + off) % P
                base_idx = p1 if keys[p1] <= keys[p2] else p2
                init = _combine_init_np(
                    inp, labs[p1], labs[p2], labs[base_idx], i, gen, seed,
                    k, Kb, Lmax,
                )
            else:
                base_idx = i * P + r1
                init = _mutate_init_np(inp, labs[base_idx], i, gen, seed, k)
            child = _refine_np(
                inp, init, i, gen + 1, seed, cfg.refine_iters, k, Kb, Lmax
            )
            ckey = _evaluate_np(inp, child, k, Kb, Lmax)[0]
            if trace is not None:
                trace.append((gen, i, keys[base_idx], ckey))
            if not ckey <= keys[base_idx]:      # elitism: never worse than
                child, ckey = labs[base_idx].copy(), keys[base_idx]  # baseline
            children.append((i, child, ckey))
        for i, child, ckey in children:        # synchronous replacement
            wi = i * P + _worst_member_np(keys, i, P)
            if ckey <= keys[wi]:
                labs[wi], keys[wi] = child, ckey
        b = int(np.argmin(np.asarray(keys)))   # gossip: global best
        for i in range(I):                     # replaces each island's worst
            wi = i * P + _worst_member_np(keys, i, P)
            if keys[b] < keys[wi]:
                labs[wi], keys[wi] = labs[b].copy(), keys[b]
    return labs[int(np.argmin(np.asarray(keys)))][:n].copy()
