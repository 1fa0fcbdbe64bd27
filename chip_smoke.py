#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Phases, each of which fails the run:

1. print the card's name and power limit and build every hand-written
   kernel of the port from the sources in this checkout;
2. hold each kernel against its plain PyTorch version on the card (exact on
   integral weights at the dense path's finest shape, ``rtol=1e-5`` on
   float weights at small ragged shapes) and time both with CUDA events;
3. check on a small graph that ``partition()`` on the card returns the same
   labels as the port's CPU path (plain versions instead of kernels);
4. drive ``partition()`` end to end — ``rmat(20, 16)`` without its
   isolated nodes, at k=16, with dense refinement and the host GA —
   counting the kernel's launches, and check the result is feasible and
   beats a hash partition;
5. time each kernel and its plain version on the main path's own input
   (the finest level's ELL pack with the run's labels) and print one JSON
   line with each kernel's numbers and, last, the device line.

Run from the repository root:  python3 chip_smoke.py
(``--scale``/``--edge-factor`` shrink the end-to-end graph for quick runs).
Without a CUDA device, or outside a checkout, it exits non-zero and prints
no result.  The span trace of phase 4 goes to ``chiprun_out/``.
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


def check_small_parity(torch) -> None:
    """Phase 3: on a small integral graph the card's path (kernel, device
    sorts and atomics) must give the CPU path's labels exactly."""
    from repro_torch.core import PartitionerConfig, partition
    from repro_torch.graph import rmat

    g = rmat(12, 8, seed=3)
    cfg = dict(k=8, preset="fast", refine_engine="dense", evo_engine="host",
               coarsest_factor=40, dense_min_n=256, numpy_below=256, seed=0)
    on_card = partition(g, PartitionerConfig(**cfg), device="cuda")
    on_cpu = partition(g, PartitionerConfig(**cfg), device="cpu")
    if on_card.engine_stats["dense_rounds"] == 0:
        _fail("small parity run made no dense rounds")
    if not (on_card.labels == on_cpu.labels).all() or on_card.cut != on_cpu.cut:
        _fail(f"card and CPU partitions differ: cut {on_card.cut} vs {on_cpu.cut}")
    print(f"small parity rmat(12, 8) k=8: card == cpu, cut {on_card.cut}, "
          f"levels {on_card.level_sizes}", flush=True)


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


def run_partition(torch, g, out_dir: Path) -> dict:
    """Phase 4: the port's main path end to end; returns launch counts."""
    from repro_torch.core import PartitionerConfig, partition
    from repro_torch.core.metrics import cut_np
    from repro_torch.kernels.lp_score import lp_score_rows
    from repro_torch.obs import Tracer, set_tracer
    cfg = PartitionerConfig(k=16, preset="fast", refine_engine="dense",
                            evo_engine="host", coarsest_factor=100, seed=0)
    tracer = Tracer()
    set_tracer(tracer)
    lp_score_rows.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    rep = partition(g, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = lp_score_rows.launches
    set_tracer(None)

    k = cfg.k
    hash_lab = ((torch.arange(g.n, dtype=torch.int64) * 2654435761) % (1 << 32) % k).numpy()
    hash_cut = cut_np(g, hash_lab)
    print(f"partition: {wall:.3f} s wall ({rep.seconds:.3f} s in partition), "
          f"cut {rep.cut} ({rep.cut / hash_cut:.4f} of hash cut {hash_cut}), "
          f"imbalance {rep.imbalance:.5f}, feasible {rep.feasible}", flush=True)
    print(f"level_sizes {rep.level_sizes}", flush=True)
    print(f"cycle_cuts {rep.cycle_cuts}", flush=True)
    print(f"engine_stats {json.dumps(rep.engine_stats)}", flush=True)
    print(f"lp_score_rows launches {launches}", flush=True)

    # where the time went, by span (spans do not nest on this path)
    groups = {}
    for ev in tracer.events:
        a = ev.get("args", {})
        if ev["name"] == "vcycle.pack":
            key = "pack.host" if a.get("host") else (
                "pack.ell" if a.get("mode") == "ell" else "pack.gather")
        elif ev["name"] == "vcycle.sweep":
            key = f"sweep.{a.get('mode')}"
        else:
            key = ev["name"].split(".", 1)[1]
        groups[key] = groups.get(key, 0.0) + ev["dur"] / 1e6
    groups["other"] = rep.seconds - sum(groups.values())
    print("breakdown_s " + json.dumps({k_: round(v, 4) for k_, v in sorted(groups.items())}),
          flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    tracer.export_chrome(str(out_dir / "chip_smoke_trace.json"))

    if not rep.feasible or rep.imbalance > cfg.eps + 1e-9:
        _fail(f"infeasible partition: imbalance {rep.imbalance}")
    if not rep.cut < hash_cut:
        _fail(f"cut {rep.cut} not below the hash partition's {hash_cut}")
    if launches <= 0:
        _fail("the main path never launched lp_score_rows")
    if launches != rep.engine_stats["dense_rounds"]:
        _fail(f"{launches} launches for {rep.engine_stats['dense_rounds']} dense rounds")
    return rep, {"lp_score_rows": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=20)
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

    # ---- phase 3: card vs CPU on a small graph
    check_small_parity(torch)

    # ---- phase 4: the main path, launch counts read around it
    rep, counts = run_partition(torch, g, Path(args.out))

    # ---- phase 5: the kernels' numbers on the main path's own input
    m = path_lp_score_rows(torch, g, rep.labels, k=16)
    kernels = [dict(
        name="lp_score_rows",
        route="cuda",
        source="src/repro_torch/kernels/lp_score/lp_score_rows.cu",
        replaces="src/repro/kernels/lp_score/lp_score.py:61",
        launches=counts["lp_score_rows"],
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
