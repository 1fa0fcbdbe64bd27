"""The overall multilevel system (paper §IV-E) with iterated V-cycles — the
port of ``repro.core.multilevel``.

Pipeline per V-cycle:

  coarsen:   l iterations of SCLaP (U = max(max_v c(v), L_max/f), degree
             order) -> cluster contraction, repeated until the graph has
             <= coarsest_factor * k nodes or contraction stalls.  On the
             engine path the chain stays on the device: clustering,
             contraction and the next level's pack gather run over a
             GraphDev hierarchy; only four scalars cross per level;
  initial:   the island evolutionary algorithm (KaFFPaE) on the coarsest
             graph — seeded with the projected current solution from the
             2nd V-cycle on, so quality never regresses;
  uncoarsen: project labels through the hierarchy, r iterations of SCLaP
             local search per level (U = L_max, random order) or dense
             kernel-scored rounds, final feasibility repair.

Presets mirror the paper §V-A: *fast* (2 V-cycles, GA gets only its
initial population), *eco* (5 V-cycles + GA generations), *minimal*.

Not ported yet: the batched device GA (``evo_engine="device"``; in this
port ``"auto"`` runs the host GA) and the distributed engine
(``engine="dist"``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..device import resolve_device
from ..graph.csr import GraphDev, GraphNP
from ..obs import span as _obs_span
from .contraction import CoarseMap, contract, project_labels
from .engine import LPEngine
from .evolutionary import EvoConfig, evolve
from .fm import fm_refine
from .initial_partition import repair_balance
from .label_propagation import sclap_numpy
from .metrics import cut_np, imbalance_np, lmax

__all__ = ["PartitionerConfig", "PartitionReport", "partition"]


@dataclass
class PartitionerConfig:
    """The reference's configuration, field for field."""

    k: int = 2
    eps: float = 0.03
    preset: str = "fast"            # fast | eco | minimal | strong
    graph_type: str = "auto"        # social | mesh | auto
    lp_iters_coarsen: int = 3
    lp_iters_refine: int = 6
    f_social: float = 14.0
    f_mesh: float = 20000.0
    # stop coarsening at coarsest_factor * k nodes; 0 = auto-scale to the
    # input: max(k, min(10000 * k, n // 8)); explicit values are honored
    coarsest_factor: int = 0
    max_levels: int = 64
    shrink_stall: float = 0.95      # stop if n' > stall * n
    seed: int = 0
    # engine: "auto"/"jnp" run the device engine (the reference's name is
    # kept so configurations carry across); "numpy" the sequential one
    engine: str = "auto"            # auto | jnp | numpy
    numpy_below: int = 4096         # use the sequential engine below this n
    target_chunks: int = 64
    # "device" chains cluster -> contract -> next-level pack on the device;
    # "host" round-trips each level through the numpy contract()
    coarsen_engine: str = "device"  # device | host
    # "chunked" = chunked-sequential LP sweep; "dense" = synchronous
    # kernel-scored dense rounds at levels >= dense_min_n nodes
    refine_engine: str = "chunked"  # chunked | dense
    dense_min_n: int = 4096
    # coarsest-stage evolutionary engine: only the host GA is ported, and
    # "auto" selects it
    evo_engine: str = "auto"        # auto | host
    # gain-based FM pass on the finest level (beyond the paper; "strong")
    fm_finest: bool = False
    fm_finest_max_n: int = 2_000_000
    # evolutionary budget (scaled by preset)
    islands: int = 2
    pop_per_island: int = 2
    generations: int = 0
    # seed the FIRST V-cycle with an existing k-way partition via the
    # restrict machinery (cycle 0 then behaves like cycle >= 2)
    initial_labels: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.preset == "eco":
            self.islands = max(self.islands, 4)
            self.pop_per_island = max(self.pop_per_island, 3)
            self.generations = max(self.generations, 8)
            self.vcycles = 5
        elif self.preset == "minimal":
            self.vcycles = 1
        elif self.preset == "strong":
            self.islands = max(self.islands, 4)
            self.pop_per_island = max(self.pop_per_island, 3)
            self.generations = max(self.generations, 8)
            self.vcycles = 5
            self.fm_finest = True
        else:  # fast
            self.vcycles = 2

    vcycles: int = field(default=2, init=False)


@dataclass
class PartitionReport:
    labels: np.ndarray
    cut: float
    imbalance: float
    feasible: bool
    level_sizes: List[tuple]        # [(n, m) per level incl. finest]
    shrink_first: float             # n_1 / n_0 after first contraction
    cycle_cuts: List[float]
    seconds: float
    engine_stats: Optional[dict] = None  # LPEngine counters (engine path only)


def _detect_type(g: GraphNP) -> str:
    deg = g.degrees().astype(np.float64)
    if deg.size == 0:
        return "mesh"
    cv = deg.std() / max(deg.mean(), 1e-9)
    return "social" if cv > 0.7 else "mesh"


def _f_value(cfg: PartitionerConfig, gtype: str, cycle: int, rng) -> float:
    if cycle > 0:
        return float(rng.uniform(10.0, 25.0))
    return cfg.f_social if gtype == "social" else cfg.f_mesh


def _use_numpy(g, cfg) -> bool:
    return cfg.engine == "numpy" or (cfg.engine == "auto" and g.n < cfg.numpy_below)


def _cluster(g, U, iters, seed, restrict, cfg, eng) -> np.ndarray:
    if _use_numpy(g, cfg):
        return sclap_numpy(
            g, np.arange(g.n), U=U, iters=iters, seed=seed, restrict=restrict
        ).labels
    return eng.cluster(g, U=U, iters=iters, seed=seed, restrict=restrict).cpu().numpy()


def _refine_numpy(g, labels, k, Lmax, iters, seed) -> np.ndarray:
    """Host-level refinement: sequential SCLaP, then FM (strong gain-based
    search on the small coarse levels, like KaFFPa)."""
    lab = sclap_numpy(
        g, labels, U=Lmax, iters=iters, seed=seed, refine_mode=True, num_labels=k
    ).labels
    return fm_refine(g, lab, k, Lmax, seed=seed)


def _uncoarsen(g, hierarchy, lab, k, L, cfg, rng, eng):
    """Project + refine through the hierarchy.  On engine levels the labels
    stay on the device (projection, sweep or dense rounds, and the
    monotonicity guard's cut and balance); host levels keep numpy."""
    lab_dev = None  # engine arena labels, device-resident once set
    for gg_f, C in reversed(hierarchy):
        seed_r = int(rng.integers(1 << 30))
        eng_level = eng is not None and not _use_numpy(gg_f, cfg)
        if eng_level:
            with _obs_span("vcycle.project", cat="vcycle", n=int(gg_f.n)) as sp:
                lab_dev = eng.project(
                    lab_dev if lab_dev is not None else lab, C, fill=k
                )
                sp.sync_on(lab_dev)
            lab = None
            before = eng.cut(gg_f, lab_dev)
            if cfg.refine_engine == "dense" and gg_f.n >= cfg.dense_min_n:
                ref = eng.refine_dense(
                    gg_f, lab_dev, k, L, cfg.lp_iters_refine, seed_r
                )
            else:
                ref = eng.refine(gg_f, lab_dev, k, L, cfg.lp_iters_refine, seed_r)
            # monotonicity guard: keep the refined labels only if they did
            # not worsen the cut (unless they restored feasibility)
            bw_ref = float(eng.block_weights(gg_f, ref, k).max())
            bw_old = float(eng.block_weights(gg_f, lab_dev, k).max())
            if eng.cut(gg_f, ref) <= before or bw_old > L >= bw_ref:
                lab_dev = ref
        else:
            with _obs_span("vcycle.host", cat="vcycle", n=int(gg_f.n), phase="refine"):
                gg_h = gg_f.to_host() if isinstance(gg_f, GraphDev) else gg_f
                C_np = C.host() if isinstance(C, CoarseMap) else C
                if lab is None:  # leaving the device path
                    lab = lab_dev.cpu().numpy()
                    lab_dev = None
                lab = project_labels(lab, C_np)
                before = cut_np(gg_h, lab)
                ref = _refine_numpy(gg_h, lab, k, L, cfg.lp_iters_refine, seed_r)
                bw_ref = np.bincount(ref, weights=gg_h.nw, minlength=k).max()
                bw_old = np.bincount(lab, weights=gg_h.nw, minlength=k).max()
                if cut_np(gg_h, ref) <= before or bw_old > L >= bw_ref:
                    lab = ref
    if lab is None:
        lab = eng.to_host(lab_dev, g.n)
    return np.asarray(lab)


def partition(g, cfg: PartitionerConfig, *, device=None) -> PartitionReport:
    """Iterated multilevel V-cycles on ``g`` (GraphNP or GraphDev).

    Runs on CUDA unless ``device`` says otherwise; raises when no CUDA
    device is present and none was named.  Returns the same report as the
    reference's ``partition``.
    """
    dev = resolve_device(device)
    if cfg.engine not in ("auto", "jnp", "numpy"):
        raise NotImplementedError(f"engine={cfg.engine!r} is not ported yet")
    if cfg.evo_engine not in ("auto", "host"):
        raise NotImplementedError(
            f"evo_engine={cfg.evo_engine!r} is not ported yet; use 'host'"
        )
    t0 = time.time()
    rng = np.random.default_rng(cfg.seed)
    k = cfg.k
    gh = g.to_host() if isinstance(g, GraphDev) else g
    L = lmax(gh.total_node_weight, k, cfg.eps)
    gtype = cfg.graph_type if cfg.graph_type != "auto" else _detect_type(gh)
    coarsest_target = (
        cfg.coarsest_factor * k
        if cfg.coarsest_factor > 0
        else max(k, min(10000 * k, gh.n // 8))
    )
    # one engine per run: owns packs and device-resident state for every
    # level of every V-cycle (the numpy engine needs none)
    eng = (
        LPEngine(g, target_chunks=cfg.target_chunks, seed=cfg.seed, device=dev)
        if cfg.engine != "numpy"
        else None
    )
    dev_coarsen = eng is not None and cfg.coarsen_engine == "device"

    best_labels: Optional[np.ndarray] = None
    best_cut = np.inf
    cycle_cuts: List[float] = []
    level_sizes: List[tuple] = []
    shrink_first = 1.0

    cur_labels: Optional[np.ndarray] = None
    if cfg.initial_labels is not None:
        il = np.asarray(cfg.initial_labels, dtype=np.int64).reshape(-1)
        if il.shape[0] != g.n:
            raise ValueError("initial_labels length must equal g.n")
        if il.size and (il.min() < 0 or il.max() >= k):
            raise ValueError("initial_labels must lie in [0, k)")
        cur_labels = il
    for cycle in range(cfg.vcycles):
        # ---------------- coarsening ----------------
        f = _f_value(cfg, gtype, cycle, rng)
        hierarchy = []  # [(graph, C)] — C is np or CoarseMap, graph NP or Dev
        gg = g
        restrict = cur_labels  # protect cut edges from the 2nd cycle on
        # ``restrict`` mirrors the level type: numpy on host levels, an
        # arena-sized device tensor on device levels
        for lev in range(cfg.max_levels):
            if gg.n <= coarsest_target:
                break
            seed = int(rng.integers(1 << 30))
            if isinstance(gg, GraphDev) and (_use_numpy(gg, cfg) or not dev_coarsen):
                # below the engine threshold (or host coarsening requested):
                # hand the level chain back to the host engines
                gg = gg.to_host()
                if restrict is not None and not isinstance(restrict, np.ndarray):
                    restrict = restrict[: gg.n].cpu().numpy().astype(np.int64)
            dev_level = dev_coarsen and not _use_numpy(gg, cfg)
            if dev_level:
                nw_max = gg.nw_max if isinstance(gg, GraphDev) else float(gg.nw.max())
                U = max(nw_max, L / f)
                if restrict is not None and isinstance(restrict, np.ndarray):
                    restrict = eng.to_arena(restrict, gg.n, fill=-1)
                clus = eng.cluster(
                    gg, U=U, iters=cfg.lp_iters_coarsen, seed=seed,
                    restrict=restrict,
                )
                coarse, C = eng.contract(gg, clus)
                # stall, or overshoot below k (the initial partitioner needs
                # at least k coarse nodes)
                if coarse.n >= cfg.shrink_stall * gg.n or coarse.n < k:
                    break
                hierarchy.append((gg, C))
                if restrict is not None:
                    restrict = eng.project_restrict(C, restrict)
            else:
                with _obs_span("vcycle.host", cat="vcycle", n=int(gg.n),
                               phase="coarsen"):
                    U = max(float(gg.nw.max()), L / f)
                    clus = _cluster(gg, U, cfg.lp_iters_coarsen, seed, restrict,
                                    cfg, eng)
                    coarse, C = contract(gg, clus)
                if coarse.n >= cfg.shrink_stall * gg.n or coarse.n < k:
                    break
                hierarchy.append((gg, C))
                if restrict is not None:
                    rc = np.zeros(coarse.n, dtype=np.int64)
                    rc[C] = restrict  # consistent: clusters never straddle blocks
                    restrict = rc
            if cycle == 0 and lev == 0:
                shrink_first = coarse.n / max(gg.n, 1)
            gg = coarse
        if cycle == 0:
            level_sizes = [(h[0].n, h[0].m) for h in hierarchy] + [(gg.n, gg.m)]

        # ---------------- initial partitioning ----------------
        seeds = []
        if cur_labels is not None:
            if not isinstance(restrict, np.ndarray):
                restrict = restrict[: gg.n].cpu().numpy().astype(np.int64)
            seeds.append(restrict.astype(np.int32))  # projected current solution
        evo = EvoConfig(
            k=k,
            Lmax=L,
            islands=cfg.islands,
            pop_per_island=cfg.pop_per_island,
            generations=cfg.generations,
            refine_iters=cfg.lp_iters_refine,
            seed=int(rng.integers(1 << 30)),
            seed_individuals=seeds,
        )
        with _obs_span("vcycle.evolve", cat="vcycle", n=int(gg.n)):
            lab = evolve(gg.to_host() if isinstance(gg, GraphDev) else gg, evo)

        # ---------------- uncoarsening + local search ----------------
        lab = _uncoarsen(g, hierarchy, lab, k, L, cfg, rng, eng)
        with _obs_span("vcycle.finish", cat="vcycle", n=int(g.n)):
            if cfg.fm_finest and g.n <= cfg.fm_finest_max_n:
                lab = fm_refine(gh, lab, k, L, seed=int(rng.integers(1 << 30)))
            lab = repair_balance(gh, lab, k, L, seed=cfg.seed)
            c = cut_np(gh, lab)
        cycle_cuts.append(c)
        cur_labels = lab.astype(np.int64)
        if c < best_cut:
            best_cut, best_labels = c, lab
        if eng is not None:
            eng.evict(keep=(g,))  # coarse graphs never recur across cycles

    return PartitionReport(
        labels=best_labels,
        cut=float(best_cut),
        imbalance=imbalance_np(gh, best_labels, k),
        feasible=bool(
            np.bincount(best_labels, weights=gh.nw, minlength=k).max() <= L + 1e-6
        ),
        level_sizes=level_sizes,
        shrink_first=shrink_first,
        cycle_cuts=cycle_cuts,
        seconds=time.time() - t0,
        engine_stats=eng.stats_dict() if eng is not None else None,
    )
