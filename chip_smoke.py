#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Phases, each of which fails the run:

1. print the card's name and power limit and build every hand-written
   kernel of the port from the sources in this checkout;
2. hold each kernel against its plain PyTorch version on the card (exact on
   integral weights at the dense path's finest shape, ``rtol=1e-5`` on
   float weights at small ragged shapes) and time both with CUDA events;
   The batched dense round must equal its one-row rounds on the card;
3. check on a small graph that ``partition()`` on the card returns the same
   labels as the port's CPU path (plain versions instead of kernels), once
   with the host GA and once with the default ``evo_engine`` (the batched
   GA);
4. drive ``partition()`` end to end on ``rmat(19, 16)`` without its
   isolated nodes, at k=16, with dense refinement: first with the default
   ``evo_engine``, whose coarsest stage must run the batched GA on the card
   in both V-cycles, then with the host GA.  Each run counts the kernel's
   launches from zero and must be feasible and beat a hash partition.
   Then the GA's generation step, which the fast preset skips: card == CPU
   on rmat(14, 16), and two generations on the full graph seeded with the
   run's partition, which must come out no worse than its seed;
5. time each kernel and its plain version on the main path's own input
   (the finest level's ELL pack with the run's labels);
6. the dynamic serving subsystem (``repro_torch.dynamic``): (a) a small
   mixed stream (edge churn, node adds, node removals) under the default
   and the throughput session config, and a three-tenant ``SessionGroup``,
   card == CPU after every batch; (b) a session on the phase-4 graph at
   k=16 under the reference benchmark's churn model at 0.1 %: every step
   feasible, the store's CSR equal to a numpy rebuild of the edge multiset,
   one full-width repair card == CPU, then one forced escalation with its
   ``lp_score_rows`` launches; (c) the throughput config on the reference
   benchmark's ba-16384 at 1 % and 0.1 % churn; (d) the reference
   benchmark's four-tenant group against the same sessions solo (labels
   equal after every step).  Then one JSON line with each kernel's numbers
   and, last, the device line.

Run from the repository root:  python3 chip_smoke.py
(``--scale``/``--edge-factor`` shrink the end-to-end graph for quick runs).
Without a CUDA device, or outside a checkout, it exits non-zero and prints
no result.  The span traces of phase 4 go to ``chiprun_out/``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and non-tensor-core float32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def _time_ms(fn, torch, warmup: int = 3, batches: int = 5, reps: int = 10) -> float:
    """Milliseconds per ``fn()`` call on the card: CUDA events around
    ``reps`` back-to-back calls (so the host's launch work overlaps the
    device's), the median over ``batches`` such runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def measure_lp_score_rows(torch, lbl, w, k: int) -> dict:
    """lp_score_rows against its plain version on one input: the max abs
    error, both times (CUDA events) and the bound for this input."""
    from repro_torch.kernels.lp_score import lp_score_rows, lp_score_rows_ref

    err = float((lp_score_rows(lbl, w, k) - lp_score_rows_ref(lbl, w, k)).abs().max())
    ms = _time_ms(lambda: lp_score_rows(lbl, w, k), torch)
    plain_ms = _time_ms(lambda: lp_score_rows_ref(lbl, w, k), torch)
    R, W = lbl.shape
    n_bytes = R * W * (4 + 4) + R * k * 4        # each input read, output written once
    n_ops = int(((lbl >= 0) & (lbl < k)).sum())  # one add per in-range slot
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                gbytes=n_bytes / 1e9)


def _report(tag: str, R: int, W: int, k: int, m: dict) -> None:
    print(f"lp_score_rows {tag} ({R}x{W}, k={k}): kernel {m['ms']:.4f} ms, "
          f"plain {m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
          f"({m['gbytes']:.3f} GB, {m['bound_by']}), "
          f"{m['gbytes'] / m['ms']:.3f} TB/s achieved, max_abs_err {m['max_abs_err']}",
          flush=True)


def check_lp_score_rows(torch, dev, R: int, W: int, k: int) -> None:
    """Phase 2 for lp_score_rows: exact at the path's finest shape ``(R, W)``
    on integral weights, rtol=1e-5 on float weights at small shapes."""
    from repro_torch.kernels.lp_score import lp_score_rows, lp_score_rows_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # uniform labels, including the sentinel k and out-of-range values
    lbl = torch.randint(-1, k + 2, (R, W), generator=gen, device=dev, dtype=torch.int32)
    w = torch.randint(0, 4, (R, W), generator=gen, device=dev).to(torch.float32)
    m = measure_lp_score_rows(torch, lbl, w, k)
    _report("uniform labels", R, W, k, m)
    if m["max_abs_err"] != 0.0:
        _fail(f"lp_score_rows differs from its plain version on integral weights: "
              f"{m['max_abs_err']}")
    # float weights: ragged W (scalar path) and W % 4 == 0 (vector path); the
    # kernel's atomics add in another order
    for (r, wd, kk) in ((1003, 37, 5), (4099, 128, 16), (77, 260, 300)):
        lb = torch.randint(-2, kk + 2, (r, wd), generator=gen, device=dev, dtype=torch.int32)
        ww = torch.rand((r, wd), generator=gen, device=dev)
        o = lp_score_rows(lb, ww, kk)
        e = lp_score_rows_ref(lb, ww, kk)
        torch.cuda.synchronize()
        if not torch.allclose(o, e, rtol=1e-5, atol=1e-6):
            _fail(f"lp_score_rows float mismatch at {(r, wd, kk)}: "
                  f"{float((o - e).abs().max())}")
        print(f"lp_score_rows float check {(r, wd, kk)}: max_abs_err="
              f"{float((o - e).abs().max()):.3e}", flush=True)
    del lbl, w
    torch.cuda.empty_cache()


def path_lp_score_rows(torch, g, labels: "np.ndarray", k: int) -> dict:
    """lp_score_rows on the main path's own finest-level input: the
    bucket-padded ELL pack of ``g`` with the labels the run returned (the
    last dense rounds of the finest level see nearly these)."""
    import numpy as np
    from repro_torch.graph import ell_pack, pow2

    ell = ell_pack(g)
    R = ell.rows
    Rb = pow2(R)
    lab_pad = np.concatenate([labels.astype(np.int32), np.array([k], np.int32)])
    lbl = np.full((Rb, ell.width), k, np.int32)
    lbl[:R] = lab_pad[ell.dst]
    w = np.zeros((Rb, ell.width), np.float32)
    w[:R] = ell.w
    m = measure_lp_score_rows(torch, torch.from_numpy(lbl).cuda(),
                              torch.from_numpy(w).cuda(), k)
    _report("main-path input", Rb, ell.width, k, m)
    if m["max_abs_err"] != 0.0:
        _fail(f"lp_score_rows differs from its plain version on the path's input: "
              f"{m['max_abs_err']}")
    torch.cuda.empty_cache()
    return m


def check_dense_round_batched(torch, g, k: int, B: int = 4) -> None:
    """Phase 2 for the batched dense round: ``B`` label rows on the finest
    level's ELL pack, scored with one kernel launch, must equal ``B``
    one-row rounds with the same seeds (integral weights: exact)."""
    import numpy as np
    from repro_torch.graph import ell_pack, pow2
    from repro_torch.kernels.lp_score import (
        dense_round_device,
        dense_round_device_batched,
        lp_score_rows,
    )

    ell = ell_pack(g)
    Rb = pow2(ell.rows)
    dev = torch.device("cuda")
    dst = torch.full((Rb, ell.width), g.n, dtype=torch.int64, device=dev)
    dst[: ell.rows] = torch.from_numpy(ell.dst).to(dev)
    w = torch.zeros((Rb, ell.width), dtype=torch.float32, device=dev)
    w[: ell.rows] = torch.from_numpy(ell.w).to(dev)
    row_node = torch.full((Rb,), g.n, dtype=torch.int64, device=dev)
    row_node[: ell.rows] = torch.from_numpy(ell.row_node).to(dev)
    nb = pow2(g.n + 1)
    lab = np.full((B, nb), k, np.int32)
    lab[:, : g.n] = np.random.default_rng(5).integers(0, k, (B, g.n))
    labs = torch.from_numpy(lab).to(dev)
    nw = torch.zeros(nb, dtype=torch.float32, device=dev)
    nw[: g.n] = torch.from_numpy(g.nw).to(dev)
    U = float(np.ceil(g.nw.sum() / k) * 1.03)
    seeds = [11 + b for b in range(B)]
    before = lp_score_rows.launches
    got = dense_round_device_batched(dst, w, row_node, labs, nw, U, seeds, 0.5, g.n, k=k)
    torch.cuda.synchronize()
    if lp_score_rows.launches != before + 1:
        _fail("the batched dense round did not score its rows with one launch")
    moved = 0
    for b in range(B):
        one = dense_round_device(dst, w, row_node, labs[b], nw, U, seeds[b], 0.5, g.n, k=k)
        if not torch.equal(got[b], one):
            _fail(f"batched dense round row {b} differs from its one-row round: "
                  f"{int((got[b] != one).sum())} labels")
        moved += int((got[b, : g.n] != labs[b, : g.n]).sum())
    if moved == 0:
        _fail("the batched dense round moved no node")
    print(f"dense_round_device_batched ({B} x {Rb}x{ell.width}, k={k}): one launch, "
          f"every row == its one-row round, {moved} moves", flush=True)
    del dst, w, labs, got
    torch.cuda.empty_cache()


def check_small_parity(torch) -> None:
    """Phase 3: on a small integral graph the card's path (kernel, device
    sorts and atomics) must give the CPU path's labels exactly, with the
    host GA and with the default ``evo_engine`` (the batched GA)."""
    from repro_torch.core import PartitionerConfig, partition
    from repro_torch.graph import rmat

    g = rmat(12, 8, seed=3)
    base = dict(k=8, preset="fast", refine_engine="dense", coarsest_factor=40,
                dense_min_n=256, numpy_below=256, seed=0)
    for evo in ("host", "auto"):
        cfg = dict(base, evo_engine=evo)
        on_card = partition(g, PartitionerConfig(**cfg), device="cuda")
        on_cpu = partition(g, PartitionerConfig(**cfg), device="cpu")
        st = on_card.engine_stats
        if st["dense_rounds"] == 0:
            _fail(f"small parity run (evo_engine={evo}) made no dense rounds")
        if (st["evo_calls"] > 0) != (evo == "auto"):
            _fail(f"small parity run (evo_engine={evo}): evo_calls {st['evo_calls']}")
        if not (on_card.labels == on_cpu.labels).all() or on_card.cut != on_cpu.cut:
            _fail(f"card and CPU partitions differ (evo_engine={evo}): "
                  f"cut {on_card.cut} vs {on_cpu.cut}")
        print(f"small parity rmat(12, 8) k=8 evo_engine={evo}: card == cpu, "
              f"cut {on_card.cut}, evo_calls {st['evo_calls']}, "
              f"levels {on_card.level_sizes}", flush=True)


def _evo_key(g, lab, k: int, Lmax: float) -> int:
    """The GA's fitness key of ``lab`` on the host: the cut, plus the
    penalty if a block is heavier than ``Lmax``."""
    import numpy as np
    from repro_torch.core.evolutionary import INFEAS_PENALTY
    from repro_torch.core.metrics import cut_np

    bw = np.bincount(lab, weights=g.nw, minlength=k).astype(np.float32)
    return int(cut_np(g, lab)) + (0 if (bw <= np.float32(Lmax)).all() else INFEAS_PENALTY)


def check_ga_generations(torch, g, seed_labels, k: int = 16, generations: int = 2) -> None:
    """Phase 4 for the GA's generation step, which the fast preset never
    runs (it has no generations): (a) card == CPU on rmat(14, 16) without
    isolated nodes with the eco preset's population (4 islands x 3) over
    ``generations`` generations; (b) the fast preset's population (2 x 2)
    over ``generations`` generations on the full graph ``g`` (Ab = 2^19,
    the shape gate's limit), seeded with ``seed_labels``: the best key must
    be no worse than the seed's.  Prints the seconds and the peak device
    memory of (b)."""
    import numpy as np
    from repro_torch.core import LPEngine
    from repro_torch.core.evolutionary import EvoConfig
    from repro_torch.core.metrics import lmax
    from repro_torch.graph import pow2, rmat

    small = drop_isolated(rmat(14, 16, seed=1))
    cfg = EvoConfig(k=k, Lmax=lmax(float(small.nw.sum()), k, 0.03), islands=4,
                    pop_per_island=3, generations=generations, refine_iters=6, seed=7)
    card = LPEngine(small, seed=0)
    if not card.can_evolve_device(small, k, cfg.islands, cfg.pop_per_island):
        _fail("the batched GA's gate refuses rmat(14, 16)")
    card._evo_arrays(small)    # pack and upload before the clock starts
    torch.cuda.synchronize()
    t = time.perf_counter()
    on_card = card.evolve_device(small, cfg).cpu()
    card_s = time.perf_counter() - t
    on_cpu = LPEngine(small, seed=0, device="cpu").evolve_device(small, cfg)
    if card.stats.evo_calls != 1 + generations:
        _fail(f"GA generations on rmat(14, 16): evo_calls {card.stats.evo_calls}")
    if not torch.equal(on_card, on_cpu):
        _fail(f"GA generations on rmat(14, 16): card and CPU differ in "
              f"{int((on_card != on_cpu).sum())} labels")
    print(f"GA 4x3, {generations} generations, rmat(14, 16) n={small.n}: card == cpu, "
          f"key {_evo_key(small, on_card.numpy(), k, cfg.Lmax)}, card {card_s:.3f} s",
          flush=True)

    L = lmax(float(g.nw.sum()), k, 0.03)
    cfg = EvoConfig(k=k, Lmax=L, islands=2, pop_per_island=2, generations=generations,
                    refine_iters=6, seed=7, seed_individuals=[seed_labels])
    eng = LPEngine(g, seed=0)
    if not eng.can_evolve_device(g, k, cfg.islands, cfg.pop_per_island):
        _fail(f"the batched GA's gate refuses the full graph (n={g.n})")
    eng._evo_arrays(g)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    lab = eng.evolve_device(g, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    lab = lab.cpu().numpy()
    seed_key = _evo_key(g, np.asarray(seed_labels, np.int32), k, L)
    best_key = _evo_key(g, lab, k, L)
    print(f"GA 2x2, {generations} generations, full graph n={g.n} (Ab={pow2(g.n + 1)}), "
          f"seeded: {secs:.3f} s, evo_calls {eng.stats.evo_calls}, best key {best_key} "
          f"(seed {seed_key}), peak device memory {peak / 2**30:.3f} GiB "
          f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before)",
          flush=True)
    if eng.stats.evo_calls != 1 + generations:
        _fail(f"GA generations on the full graph: evo_calls {eng.stats.evo_calls}")
    if best_key > seed_key:
        _fail(f"GA generations on the full graph: best key {best_key} worse than "
              f"the seed's {seed_key}")
    del eng
    torch.cuda.empty_cache()


def drop_isolated(g):
    """The subgraph of ``g`` on its nodes of degree > 0 (ids renumbered in
    order, so every CSR row stays sorted)."""
    import numpy as np
    from repro_torch.graph import GraphNP

    deg = g.degrees()
    keep = np.flatnonzero(deg > 0)
    new_id = np.full(g.n, -1, np.int64)
    new_id[keep] = np.arange(keep.size)
    return GraphNP(
        indptr=np.concatenate([[0], np.cumsum(deg[keep])]).astype(np.int64),
        indices=new_id[g.indices].astype(np.int32),
        ew=g.ew,
        nw=g.nw[keep],
    )


def make_graph(scale: int, edge_factor: int):
    """The end-to-end input: ``rmat(scale, edge_factor, seed=1)`` without
    its isolated nodes.  R-MAT leaves about a third of its 2^scale ids
    without an edge; an isolated node can join no cluster, so with them the
    coarsening stalls near their count and the host GA would see hundreds of
    thousands of nodes.  The web graphs rmat stands in for have none."""
    from repro_torch.graph import rmat

    t = time.perf_counter()
    g_full = rmat(scale, edge_factor, seed=1)
    g = drop_isolated(g_full)
    print(f"rmat({scale}, {edge_factor}): {g_full.n} ids, {g.n} with edges, "
          f"m={g.m} arcs, generated in {time.perf_counter() - t:.1f} s", flush=True)
    return g


def run_partition(torch, g, out_dir: Path, evo_engine: str) -> dict:
    """Phase 4: the port's main path end to end with the given GA engine;
    the kernel's launch count is set to 0 just before and read just
    after."""
    from repro_torch.core import PartitionerConfig, partition
    from repro_torch.core.metrics import cut_np
    from repro_torch.kernels.lp_score import lp_score_rows
    from repro_torch.obs import Tracer, set_tracer
    cfg = PartitionerConfig(k=16, preset="fast", refine_engine="dense",
                            evo_engine=evo_engine, coarsest_factor=100, seed=0)
    tracer = Tracer()
    set_tracer(tracer)
    torch.cuda.synchronize()
    lp_score_rows.launches = 0
    t = time.perf_counter()
    rep = partition(g, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = lp_score_rows.launches
    set_tracer(None)

    k = cfg.k
    hash_lab = ((torch.arange(g.n, dtype=torch.int64) * 2654435761) % (1 << 32) % k).numpy()
    hash_cut = cut_np(g, hash_lab)
    tag = f"[evo_engine={evo_engine}]"
    print(f"{tag} partition: {wall:.3f} s wall ({rep.seconds:.3f} s in partition), "
          f"cut {rep.cut} ({rep.cut / hash_cut:.4f} of hash cut {hash_cut}), "
          f"imbalance {rep.imbalance:.5f}, feasible {rep.feasible}", flush=True)
    print(f"{tag} level_sizes {rep.level_sizes}", flush=True)
    print(f"{tag} cycle_cuts {rep.cycle_cuts}", flush=True)
    print(f"{tag} engine_stats {json.dumps(rep.engine_stats)}", flush=True)
    print(f"{tag} lp_score_rows launches {launches}", flush=True)

    # where the time went, by span (spans do not nest on this path)
    groups = {}
    evolves = []
    for ev in tracer.events:
        a = ev.get("args", {})
        if ev["name"] == "vcycle.pack":
            key = "pack.host" if a.get("host") else (
                "pack.ell" if a.get("mode") == "ell" else "pack.gather")
        elif ev["name"] == "vcycle.sweep":
            key = f"sweep.{a.get('mode')}"
        elif ev["name"] == "vcycle.evolve":
            key = f"evolve.{a.get('engine')}"
            evolves.append((a.get("engine"), a.get("n"), ev["dur"] / 1e6))
        else:
            key = ev["name"].split(".", 1)[1]
        groups[key] = groups.get(key, 0.0) + ev["dur"] / 1e6
    groups["other"] = rep.seconds - sum(groups.values())
    print(f"{tag} breakdown_s " + json.dumps({k_: round(v, 4) for k_, v in sorted(groups.items())}),
          flush=True)
    print(f"{tag} evolve spans (engine, coarsest n, s): {evolves}", flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    tracer.export_chrome(str(out_dir / f"chip_smoke_trace_{evo_engine}.json"))

    if not rep.feasible or rep.imbalance > cfg.eps + 1e-9:
        _fail(f"{tag} infeasible partition: imbalance {rep.imbalance}")
    if not rep.cut < hash_cut:
        _fail(f"{tag} cut {rep.cut} not below the hash partition's {hash_cut}")
    if launches <= 0:
        _fail(f"{tag} the main path never launched lp_score_rows")
    if launches != rep.engine_stats["dense_rounds"]:
        _fail(f"{tag} {launches} launches for {rep.engine_stats['dense_rounds']} dense rounds")
    want_engine = "host" if evo_engine == "host" else "device"
    if len(evolves) != cfg.vcycles or any(e[0] != want_engine for e in evolves):
        _fail(f"{tag} want the {want_engine} GA in all {cfg.vcycles} V-cycles, "
              f"got {evolves}")
    return dict(rep=rep, launches=launches, wall=wall,
                evolve_s=sum(e[2] for e in evolves), evolves=evolves)


# --------------------------------------------------------------------------
# phase 6: the dynamic serving subsystem
# --------------------------------------------------------------------------


def _pcts(xs) -> str:
    import numpy as np

    a = np.asarray(xs, np.float64)
    return (f"p50 {np.percentile(a, 50):.4f} s, p99 {np.percentile(a, 99):.4f} s, "
            f"min {a.min():.4f} s, max {a.max():.4f} s")


def churn_batches(g, rng, nb: int, n_now):
    """The reference benchmark's churn model (``benchmarks/run.py``,
    ``_churn_stream``): per batch ``nb`` random adds plus ``nb`` removals of
    surviving original edges, each of weight 1, so the edge-weight sum
    stays constant.  ``n_now()`` gives the current node count.  Yields
    ``(update, (add_u, add_v), (rem_u, rem_v))``."""
    import numpy as np
    from repro_torch.dynamic import GraphUpdate

    src0 = g.arc_sources()
    removed = src0 >= g.indices        # canonical (src < dst) arcs only
    while True:
        n = n_now()
        au = rng.integers(0, n, nb)
        av = (au + 1 + rng.integers(0, n - 1, nb)) % n
        cand = rng.permutation(np.flatnonzero(~removed))[:nb]
        removed[cand] = True
        ru, rv = src0[cand], g.indices[cand]
        upd = GraphUpdate.add_edges(au, av).merged(GraphUpdate.remove_edges(ru, rv))
        yield upd, (au, av), (ru, rv)


def _small_stream(g, seed: int):
    """Phase 6a's six actions on ``g``: edge churn, 32 added nodes, 24 of
    them wired in, the 8 left isolated removed."""
    import numpy as np
    from repro_torch.dynamic import GraphUpdate

    rng = np.random.default_rng(seed)
    n0 = g.n
    batches = churn_batches(g, rng, 24, lambda: n0)
    acts = [("update", next(batches)[0]), ("update", next(batches)[0])]
    acts.append(("update", GraphUpdate.add_nodes(np.ones(32, np.int64)).merged(
        next(batches)[0])))
    new = np.arange(n0, n0 + 24)
    acts.append(("update", GraphUpdate.add_edges(new, rng.integers(0, n0, 24)).merged(
        next(batches)[0])))
    acts.append(("update", next(batches)[0]))
    acts.append(("remove_nodes", np.arange(n0 + 24, n0 + 32)))
    return acts


def _same_step(tag, a, b, la, lb):
    import numpy as np

    if not np.array_equal(la, lb):
        _fail(f"{tag}: card and CPU labels differ in {int((la != lb).sum())} nodes")
    for f in ("cut", "region_size", "imbalance", "feasible", "escalated", "used_view", "n", "m"):
        if getattr(a, f) != getattr(b, f):
            _fail(f"{tag}: {f} {getattr(a, f)} on the card, {getattr(b, f)} on the CPU")


def check_dynamic_small(torch) -> None:
    """Phase 6a: a small mixed stream on the card and on the CPU, under the
    default and the throughput session config, then a three-tenant group
    (one tenant at k=3): labels, cuts and region sizes equal after every
    batch."""
    import numpy as np
    from repro_torch.dynamic import PartitionSession, SessionConfig, SessionGroup
    from repro_torch.graph import barabasi_albert

    g = barabasi_albert(1024, 4, seed=5)
    acts = _small_stream(g, seed=1)
    for name, cfg in (("default", dict()), ("throughput", dict(compact_fraction=0.02))):
        make = SessionConfig.throughput if name == "throughput" else SessionConfig
        sess = {d: PartitionSession(g, make(k=4, seed=0, **cfg), device=d)
                for d in ("cuda", "cpu")}
        _same_step(f"6a {name} start", sess["cuda"].trajectory[0], sess["cpu"].trajectory[0],
                   sess["cuda"].labels_np(), sess["cpu"].labels_np())
        views = 0
        for i, (kind, x) in enumerate(acts):
            res = {d: (s.update(x) if kind == "update" else s.remove_nodes(x))
                   for d, s in sess.items()}
            _same_step(f"6a {name} batch {i}", res["cuda"], res["cpu"],
                       sess["cuda"].labels_np(), sess["cpu"].labels_np())
            views += int(res["cuda"].used_view)
        c = sess["cuda"]
        if c.n != g.n + 24 or c.store.stats.vacuum_calls != 1:
            _fail(f"6a {name}: n {c.n}, vacuum_calls {c.store.stats.vacuum_calls}")
        print(f"6a {name}: 6 batches on ba-1024 k=4 (churn, +32 nodes, 24 wired, 8 removed): "
              f"card == cpu, cut {c.cut}, view steps {views}, "
              f"repair_calls {c.stats()['repair_calls']}", flush=True)
    tenants = {f"t{i}": (barabasi_albert(1024, 4, seed=5 + i), k) for i, k in enumerate((4, 4, 3))}
    groups, last = {}, {}
    for d in ("cuda", "cpu"):
        groups[d] = SessionGroup({
            name: PartitionSession(gi, SessionConfig(k=k, seed=i, repair_iters=2), device=d)
            for i, (name, (gi, k)) in enumerate(tenants.items())})
    streams = {name: churn_batches(gi, np.random.default_rng(20 + i), 16, lambda gi=gi: gi.n)
               for i, (name, (gi, _)) in enumerate(tenants.items())}
    for step in range(4):
        batch = [(name, next(st)[0]) for name, st in streams.items()]
        for d, grp in groups.items():
            last[d] = grp.update_many(batch)
        for name in tenants:
            _same_step(f"6a group step {step} tenant {name}", last["cuda"][name],
                       last["cpu"][name], groups["cuda"].sessions[name].labels_np(),
                       groups["cpu"].sessions[name].labels_np())
    sd = groups["cuda"].stats_dict()
    if sd["lanes_repaired"] != 12:
        _fail(f"6a group: lanes_repaired {sd['lanes_repaired']}, want 12")
    print(f"6a group of 3 tenants (k=4, 4, 3), 4 steps: card == cpu, {json.dumps(sd)}",
          flush=True)


def _span_ms(tracer) -> dict:
    out = {}
    for ev in tracer.events:
        out[ev["name"]] = round(out.get(ev["name"], 0.0) + ev["dur"] / 1e3, 3)
    return out


def _traced(torch, fn):
    """Run ``fn()`` once with span tracing on (spans synchronize the card at
    their close); returns ``(result, {span: ms})``."""
    from repro_torch.obs import Tracer, set_tracer

    tracer = Tracer()
    set_tracer(tracer)
    try:
        res = fn()
        torch.cuda.synchronize()
    finally:
        set_tracer(None)
    return res, _span_ms(tracer)


def _report_batch(tag, res) -> None:
    print(f"{tag}: {res.seconds:.4f} s, region {res.region_size}, cut {res.cut}, "
          f"imbalance {res.imbalance:.5f}, feasible {res.feasible}, view {res.used_view}, "
          f"escalated {res.escalated}, span_ms "
          + json.dumps({k: round(v, 3) for k, v in res.span_ms.items()}), flush=True)


def check_dynamic_full(torch, g, warm: int = 2, timed: int = 8) -> dict:
    """Phase 6b: a session on the phase-4 graph at k=16 (dense refinement
    at session start and in escalations) under the reference churn model
    at 0.1 % of the edges per batch.  Checks feasibility at every step, the
    store's CSR against a numpy rebuild of the edge multiset, one full-width
    repair card == CPU, and runs one forced escalation."""
    import numpy as np
    from repro_torch.core import LPEngine, PartitionerConfig, partition
    from repro_torch.dynamic import PartitionSession, SessionConfig
    from repro_torch.graph import from_edges, to_device_csr
    from repro_torch.kernels.lp_score import lp_score_rows

    k = 16
    pcfg = PartitionerConfig(k=k, preset="fast", refine_engine="dense", coarsest_factor=100)
    nb = g.m // 2 // 1000
    torch.cuda.synchronize()
    lp_score_rows.launches = 0
    t = time.perf_counter()
    sess = PartitionSession(g, SessionConfig(k=k, seed=0, partition_cfg=pcfg))
    torch.cuda.synchronize()
    print(f"6b session start on n={g.n}, m={g.m}: {time.perf_counter() - t:.3f} s, "
          f"cut {sess.cut}, lp_score_rows launches {lp_score_rows.launches}", flush=True)
    batches = churn_batches(g, np.random.default_rng(11), nb, lambda: sess.n)
    adds, rems, secs, last_touched = [], [], [], None
    for i in range(warm + timed):
        upd, a, r = next(batches)
        last_upd = upd
        adds.append(a)
        rems.append(r)
        if i == warm + timed - 1:
            res, spans = _traced(torch, lambda: sess.update(upd))
            print(f"6b traced batch spans_ms {json.dumps(spans)}", flush=True)
        else:
            res = sess.update(upd)
        last_touched = np.concatenate([a[0], a[1], r[0], r[1]])
        _report_batch(f"6b batch {i} ({nb} adds + {nb} removals)", res)
        if not res.feasible:
            _fail(f"6b batch {i} infeasible: imbalance {res.imbalance}")
        if i >= warm and i < warm + timed - 1:
            secs.append(res.seconds)
    print(f"6b per-update seconds over {len(secs)} untraced timed batches: {_pcts(secs)}",
          flush=True)
    print(f"6b stats {json.dumps(sess.stats(), default=str)}", flush=True)
    time_store_programs(torch, sess.store.base, last_upd)

    # ---- the store's CSR against a numpy rebuild of the edge multiset
    t = time.perf_counter()
    gh = sess.store.csr_host()
    src0 = g.arc_sources()
    canon = src0 < g.indices
    u = np.concatenate([src0[canon]] + [x[0] for x in adds] + [x[0] for x in rems])
    v = np.concatenate([g.indices[canon]] + [x[1] for x in adds] + [x[1] for x in rems])
    w = np.concatenate([g.ew[canon], np.ones(sum(x[0].size for x in adds)),
                        -np.ones(sum(x[0].size for x in rems))])
    lo, hi = np.minimum(u, v).astype(np.int64), np.maximum(u, v).astype(np.int64)
    keys, inv = np.unique(lo * g.n + hi, return_inverse=True)
    net = np.bincount(inv, weights=w)
    live = net > 0
    want = from_edges(g.n, keys[live] // g.n, keys[live] % g.n, net[live], nw=g.nw)
    for name in ("indptr", "indices", "ew", "nw"):
        if not np.array_equal(getattr(gh, name), getattr(want, name)):
            _fail(f"6b store CSR differs from the numpy rebuild in {name}")
    print(f"6b store CSR == numpy rebuild of the edge multiset (m={gh.m}, "
          f"{time.perf_counter() - t:.1f} s)", flush=True)

    # ---- one full-width repair, card against CPU, from the same state
    U = sess._lmax()
    kw = dict(hops=sess.cfg.hops, iters=sess.cfg.repair_iters, seed=12345,
              hop_degree_cap=sess._hop_cap())
    lab = sess.labels_np()
    outs = {}
    for d in ("cuda", "cpu"):
        eng = LPEngine(g, target_chunks=sess.cfg.target_chunks, seed=0, device=d)
        eng._repair_E = sess.engine._repair_E
        gd = sess.store.graph() if d == "cuda" else to_device_csr(gh, "cpu")
        t = time.perf_counter()
        out, rsize, cut, bw = eng.repair(gd, lab, last_touched, k, U, **kw)
        if d == "cuda":
            torch.cuda.synchronize()
        outs[d] = (out.cpu().numpy(), rsize, cut, bw, time.perf_counter() - t)
    a, b = outs["cuda"], outs["cpu"]
    if not np.array_equal(a[0], b[0]):
        _fail(f"6b full-width repair: card and CPU labels differ in "
              f"{int((a[0] != b[0]).sum())} nodes")
    if a[1] != b[1] or a[2] != b[2] or not np.array_equal(a[3], b[3]):
        _fail(f"6b full-width repair: region/cut/weights differ: {a[1:4]} vs {b[1:4]}")
    print(f"6b one repair at full width (region {a[1]} of {g.n}): card == cpu, cut {a[2]}, "
          f"card {a[4]:.3f} s, cpu {b[4]:.3f} s", flush=True)

    # ---- one forced escalation
    upd, _, _ = next(batches)
    sess.cfg.escalate_cut_ratio = 0.0
    torch.cuda.synchronize()
    before = lp_score_rows.launches
    res = sess.update(upd)
    torch.cuda.synchronize()
    esc_launches = lp_score_rows.launches - before
    sess.cfg.escalate_cut_ratio = 1.6
    _report_batch("6b forced escalation", res)
    if not res.escalated or not res.feasible:
        _fail(f"6b forced escalation: escalated {res.escalated}, feasible {res.feasible}")
    total = lp_score_rows.launches
    t = time.perf_counter()
    fresh = partition(sess.store.csr_host(), PartitionerConfig(
        k=k, preset="fast", refine_engine="dense", coarsest_factor=100, seed=0))
    print(f"6b escalation: {res.seconds:.3f} s, lp_score_rows launches {esc_launches}, "
          f"cut {res.cut} against a fresh partition() of the final graph: {fresh.cut} "
          f"({res.cut / fresh.cut:.4f}; fresh run {time.perf_counter() - t:.3f} s)",
          flush=True)
    print(f"6b lp_score_rows launches over session start, stream and escalation: {total}",
          flush=True)
    if esc_launches <= 0 or total <= 0:
        _fail("6b: the dynamic path never launched lp_score_rows")
    return dict(secs=secs, esc_s=res.seconds, esc_launches=esc_launches, launches=total)


def time_store_programs(torch, b, upd) -> None:
    """CUDA-event times of the store's three device programs on the base
    CSR ``b`` with one batch's overlay: the merge, the view (timed here
    although the session's view gate refuses this node bucket) and a
    vacuum pass that keeps every node."""
    import numpy as np
    from repro_torch.dynamic.store import (
        merge_overlay_device,
        overlay_view_device,
        vacuum_device,
    )
    from repro_torch.graph import pow2

    u, v, w = upd.arcs()
    r = u.size
    Rb = pow2(max(r, 8))

    dev = b.indptr.device

    def pad(a, dt):
        return torch.from_numpy(np.concatenate([a, np.zeros(Rb - r, a.dtype)]).astype(dt)).to(dev)

    ou, ov, ow = pad(u, np.int64), pad(v, np.int64), pad(w, np.float32)
    Nb = b.indptr.shape[0] - 1
    newid = torch.arange(Nb, device=dev)
    keep = torch.ones(Nb, dtype=torch.bool, device=dev)
    kw = dict(warmup=1, batches=3, reps=3)
    ms = dict(
        merge=_time_ms(lambda: merge_overlay_device(
            b.src, b.indices, b.ew, ou, ov, ow, b.nw, b.n, b.m, r), torch, **kw),
        view=_time_ms(lambda: overlay_view_device(
            b.indptr, b.src, b.indices, b.ew, ou, ov, ow, b.n, b.m, r), torch, **kw),
        vacuum=_time_ms(lambda: vacuum_device(
            b.src, b.indices, b.ew, newid, keep, b.nw, b.m), torch, **kw),
    )
    print(f"6b store programs on the card (Mb={b.indices.shape[0]}, Rb={Rb}, Nb={Nb}), "
          f"ms: {json.dumps({k_: round(v_, 4) for k_, v_ in ms.items()})}", flush=True)


def check_dynamic_throughput(torch, warm: int = 2, timed: int = 8) -> None:
    """Phase 6c: the reference benchmark's throughput rows — ba-16384,
    k=4, ``SessionConfig.throughput`` at 1 % and then 0.1 % churn."""
    import numpy as np
    from repro_torch.dynamic import PartitionSession, SessionConfig
    from repro_torch.graph import barabasi_albert

    g = barabasi_albert(16384, 6, seed=3)
    sess = PartitionSession(g, SessionConfig.throughput(k=4, seed=0))
    for tag, nb, rng_seed, n_warm in (("1%", max(g.m // 2 // 200, 64), 11, warm),
                                      ("0.1%", max(g.m // 2 // 2000, 8), 13, 1)):
        batches = churn_batches(g, np.random.default_rng(rng_seed), nb, lambda: sess.n)
        for _ in range(n_warm):
            sess.update(next(batches)[0])
        secs = []
        for i in range(timed):
            res = sess.update(next(batches)[0])
            secs.append(res.seconds)
            if not res.feasible:
                _fail(f"6c {tag} batch {i} infeasible")
        res, spans = _traced(torch, lambda: sess.update(next(batches)[0]))
        _report_batch(f"6c {tag} traced batch", res)
        print(f"6c {tag} traced batch spans_ms {json.dumps(spans)}", flush=True)
        st = sess.stats()
        print(f"6c ba-16384 k=4 throughput config, {tag} churn ({nb} adds + {nb} removals): "
              f"per-update {_pcts(secs)}; view_hits {st['view_hits']}, "
              f"compact_deferred {st['compact_deferred']}, compact_calls "
              f"{st['compact_calls']}, escalations {st['escalations']}, cut {sess.cut}",
              flush=True)


def check_dynamic_group(torch, warm: int = 2, timed: int = 8) -> None:
    """Phase 6d: the reference benchmark's multi-tenant row — 4 tenants
    ba-4096 at k=4, repair_iters=2, ``4096 * 6 // 200`` random adds per
    tenant per step — as a group and as the same sessions solo; labels
    equal after every step."""
    import numpy as np
    from repro_torch.dynamic import GraphUpdate, PartitionSession, SessionConfig, SessionGroup
    from repro_torch.graph import barabasi_albert

    Ngt, Tn = 4096, 4
    gs = {f"t{i}": barabasi_albert(Ngt, 6, seed=20 + i) for i in range(Tn)}

    def tenants():
        return {name: PartitionSession(gi, SessionConfig(k=4, seed=i, repair_iters=2))
                for i, (name, gi) in enumerate(gs.items())}

    solo, grp = tenants(), tenants()
    group = SessionGroup(grp)
    rng = np.random.default_rng(17)
    nbt = max(Ngt * 6 // 200, 16)
    t_solo, t_grp = [], []
    for s in range(warm + timed + 1):
        batch = []
        for name in gs:
            au = rng.integers(0, Ngt, nbt)
            batch.append((name, GraphUpdate.add_edges(
                au, (au + 1 + rng.integers(0, Ngt - 1, nbt)) % Ngt)))
        torch.cuda.synchronize()
        t = time.perf_counter()
        for name, upd in batch:
            solo[name].update(upd)
        torch.cuda.synchronize()
        dt_solo = (time.perf_counter() - t) / Tn
        if s == warm + timed:
            _, spans = _traced(torch, lambda: group.update_many(batch))
            print(f"6d traced group step spans_ms {json.dumps(spans)}", flush=True)
        else:
            t = time.perf_counter()
            group.update_many(batch)
            torch.cuda.synchronize()
            dt_grp = (time.perf_counter() - t) / Tn
            if s >= warm:
                t_solo.append(dt_solo)
                t_grp.append(dt_grp)
        for name in gs:
            if not np.array_equal(solo[name].labels_np(), grp[name].labels_np()):
                _fail(f"6d step {s} tenant {name}: group and solo labels differ")
    print(f"6d {Tn} tenants ba-{Ngt} k=4, {nbt} adds each per step: group == solo after "
          f"every step; per-update solo {_pcts(t_solo)}; group (amortized) {_pcts(t_grp)}; "
          f"{json.dumps(group.stats_dict())}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=19)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.graph import plan_ell_rows, pow2
    from repro_torch.kernels import build
    from repro_torch.kernels.lp_score import lp_score

    t_start = time.perf_counter()
    card = _card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- phase 1: build every kernel from the checkout's sources
    sources = [lp_score.SOURCE]
    t = time.perf_counter()
    for src in sources:
        build.load(src)
        log = (build.BUILD_DIR / f"{src.stem}.log").read_text().strip()
        print(f"built {src.name}: {log}", flush=True)
    print(f"build: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- phase 2: each kernel against its plain version, at the shapes the
    # main path gives it: the finest level's ELL pack of the input
    g = make_graph(args.scale, args.edge_factor)
    rows = plan_ell_rows(g.indptr, g.n)[0].shape[0]
    check_lp_score_rows(torch, dev, R=pow2(rows), W=128, k=16)
    check_dense_round_batched(torch, g, k=16)

    # ---- phase 3: card vs CPU on a small graph, host GA and batched GA
    check_small_parity(torch)

    # ---- phase 4: the main path with the batched GA (this slice's path),
    # then the host GA (the earlier path), launch counts read around each
    print(f"edge-weight sum {float(g.ew.sum())} (the batched GA needs < 2^24 = "
          f"{2**24}), node-weight sum {float(g.nw.sum())}", flush=True)
    runs = {evo: run_partition(torch, g, Path(args.out), evo) for evo in ("auto", "host")}
    print("device GA vs host GA: " + json.dumps({
        evo: dict(wall_s=round(r["wall"], 3), partition_s=round(r["rep"].seconds, 3),
                  cut=r["rep"].cut, evolve_s=round(r["evolve_s"], 4),
                  launches=r["launches"])
        for evo, r in runs.items()}), flush=True)
    rep = runs["auto"]["rep"]
    # the GA's generation step at full width, seeded with the run's result
    check_ga_generations(torch, g, rep.labels)

    # ---- phase 5: the kernels' numbers on the main path's own input
    m = path_lp_score_rows(torch, g, rep.labels, k=16)

    # ---- phase 6: the dynamic serving subsystem (this slice's path)
    t = time.perf_counter()
    check_dynamic_small(torch)
    check_dynamic_full(torch, g)
    check_dynamic_throughput(torch)
    check_dynamic_group(torch)
    print(f"phase 6: {time.perf_counter() - t:.1f} s", flush=True)
    kernels = [dict(
        name="lp_score_rows",
        route="cuda",
        source="src/repro_torch/kernels/lp_score/lp_score_rows.cu",
        replaces="src/repro/kernels/lp_score/lp_score.py:61",
        launches=runs["auto"]["launches"],
        max_abs_err=m["max_abs_err"],
        ms=m["ms"],
        plain_ms=m["plain_ms"],
        bound_ms=m["bound_ms"],
        bound_by=m["bound_by"],
        library_ms=None,   # no single PyTorch call computes the masked row histogram
    )]
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
