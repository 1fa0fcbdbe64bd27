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
   (the finest level's ELL pack with the run's labels) and print one JSON
   line with each kernel's numbers and, last, the device line.

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
