"""The one traffic generator: a mix file names its loop and sets its
parameters.

``partition``: one client calls ``repro_torch.core.partition`` back to back
on a pool of inputs, each the configuration's graph under its own renaming
of the nodes and with its own partitioner seed.  The pool is the same for
every ``--seed`` (drawn from the configuration's ``graph_seed``), the seed
sets the order of its calls, and the window ends on a whole rotation of the
pool: every run partitions each input equally often, so every seed does
the same work.  The warm calls take inputs of their own.  Mix keys:
``pool`` (inputs in the window's rotation), ``warm_calls``.

``session``: one client feeds ``repro_torch.dynamic.PartitionSession.update``
(on the configuration's graph under a renaming drawn from the seed) a
stream of edge churn drawn in set-up: every batch adds ``per_mille`` of
the edge count as pairs of uniform distinct nodes and removes as many
surviving original edges, all of weight 1.  Mix keys: ``per_mille``,
``warm_batches``, ``batches`` (the stream's length).

Both time each call or update on the host from its start to a
``torch.cuda.synchronize()`` after it, and keep what it returned for the
reference, which judges it once the window has closed."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict

import numpy as np
import torch

from ..gen import graphs
from ..gen.csr import csr_arrays
from ..gen.seeds import PARTITION, PERM, SAMPLE, STREAM, derive, torch_generator
from ..reference import lp_score as ref_scores
from ..reference import partition as ref_partition
from ..reference.stream import EdgeStream, array_gap
from .capture import KernelCapture
from .devtrace import DeviceTrace
from .record import Run
from .stats import percentile


@dataclass
class Context:
    cell: str
    config: dict             # the configuration's file
    mix: dict                # the traffic mix's file
    workload: dict           # the cell's file
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float           # perf_counter at process start
    control: bool = False    # run the cell's control in the program's place
    log: Callable = field(default=lambda *a: print(*a, file=sys.stderr, flush=True))

    def partitioner(self) -> dict:
        p = dict(self.config["partitioner"])
        if self.control:
            p.update(self.workload["control"])
        return p


@dataclass
class Outcome:
    run: Run
    checks: Dict[str, float]
    attempted: int
    failed: int


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak_reset(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _quantiles(xs) -> str:
    return " ".join(f"p{q} {percentile(xs, q):.4f}" for q in (0, 10, 50, 90, 100))


class _Window:
    """Tracing (program spans and the device timeline) around the window,
    when the run is traced."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.spans = []
        self.timeline = None

    def __enter__(self):
        if self.ctx.trace:
            from repro_torch.obs import Tracer, set_tracer

            a = time.perf_counter()
            self.tracer = Tracer()
            self.origin = 0.5 * (a + time.perf_counter())
            set_tracer(self.tracer)
            self.dev = DeviceTrace(self.ctx.device).__enter__()
        return self

    def __exit__(self, *exc):
        if self.ctx.trace:
            from repro_torch.obs import set_tracer

            self.dev.__exit__(*exc)
            set_tracer(None)
            self.timeline = self.dev.timeline
            self.spans = [
                (e["name"], self.origin + e["ts"] * 1e-6,
                 self.origin + (e["ts"] + e["dur"]) * 1e-6)
                for e in self.tracer.events if e.get("ph") == "X"
            ]
        return False


def call_order(seed: int, P: int) -> list:
    """The order in which a run takes the ``P`` inputs of the pool."""
    return [int(i) for i in np.random.default_rng(derive(seed, PERM)).permutation(P)]


def run_partition(ctx: Context) -> Outcome:
    from repro_torch.core import PartitionerConfig, partition
    from repro_torch.graph import GraphNP

    dev = ctx.device
    base = graphs.build(ctx.config, dev)
    ctx.log(f"perfbench: graph n={base.n} edges={base.edges}")
    P = int(ctx.mix["pool"])
    warm = int(ctx.mix["warm_calls"])
    fixed = int(ctx.config["graph_seed"])
    pool = []
    for i in range(warm + P):
        perm = torch.randperm(base.n, generator=torch_generator(fixed, PERM, i, dev),
                              device=dev)
        pool.append((GraphNP(**csr_arrays(base.n, base.lo, base.hi, perm)),
                     perm.cpu().numpy(), derive(fixed, PARTITION, i) & 0x7FFFFFFF))
        del perm
    order = call_order(ctx.seed, P)
    del base.lo, base.hi        # the benchmark's device copy: not in the window's peak
    pcfg = ctx.partitioner()
    for g, _, s in pool[:warm]:
        partition(g, PartitionerConfig(**pcfg, seed=s), device=dev)
    _sync(dev)
    cap = KernelCapture(ctx.workload["kernel_rows"], derive(ctx.seed, SAMPLE)).install()
    calls = []
    durations = []
    rounds = 0
    _peak_reset(dev)
    setup_s = time.perf_counter() - ctx.t_start
    with _Window(ctx) as win:
        t_w = time.perf_counter()
        j = 0
        while True:
            idx = warm + order[j % P]
            g, _, s = pool[idx]
            cfg = PartitionerConfig(**pcfg, seed=s)
            t = time.perf_counter()
            rep = partition(g, cfg, device=dev)
            _sync(dev)
            durations.append(time.perf_counter() - t)
            calls.append((idx, rep.labels, rep.cut))
            rounds += int((rep.engine_stats or {}).get("dense_rounds", 0))
            cap.drain()
            j += 1
            if j % P == 0 and time.perf_counter() - t_w >= ctx.seconds:
                break
        window_s = time.perf_counter() - t_w
    missed = cap.missed(rounds)
    cap.uninstall()
    peak = _peak(dev)
    ctx.log("perfbench: calls (input, seconds) " + " ".join(
        f"({idx - warm}, {d:.4f})" for (idx, _, _), d in zip(calls, durations)))
    ctx.log(f"perfbench: call seconds {_quantiles(durations)}")
    perms = [perm for _, perm, _ in pool]
    del pool
    _free(dev)

    # the reference, once the window has closed
    k, eps = int(pcfg["k"]), float(ctx.config["partitioner"]["eps"])
    checks = dict(bad_labels=0.0, overload=0.0, cut_gap=0.0)
    failed = 0
    for idx, labels, cut in calls:
        got = ref_partition.judge(labels, cut, base.n, base.lo_np, base.hi_np, k, eps,
                                  perm=perms[idx])
        failed += any(v > ctx.workload["limits"][name] for name, v in got.items())
        for name, v in got.items():
            checks[name] = max(checks[name], float(v))
    checks["score_gap"] = ref_scores.score_gap(cap.samples)
    checks["kernel_unchecked"] = float(missed)
    ctx.log(f"perfbench: {len(calls)} calls, {len(cap.shapes)} lp_score_rows launches "
            f"({rounds} dense rounds), {sum(s[0].shape[0] for s in cap.samples)} score "
            f"rows compared")
    run = Run(loop="partition", cell=ctx.cell, durations=durations, window_s=window_s,
              setup_s=setup_s, memory_peak_bytes=peak,
              series=dict(cut_frac=[c / base.edges for _, _, c in calls]),
              spans=win.spans, timeline=win.timeline, launches=cap.shapes)
    return Outcome(run=run, checks=checks, attempted=len(calls), failed=failed)


def churn_stream(base, mix: dict, seed: int):
    """The stream's batches: ``(add_u, add_v, removed)``, ``removed``
    indexing the original edges (one permutation of them, in slices)."""
    rng = np.random.default_rng(derive(seed, STREAM))
    n, E = base.n, base.edges
    nb = max(1, round(E * float(mix["per_mille"]) / 1000.0))
    T = int(mix["batches"])
    if T * nb > E:
        raise ValueError(f"a stream of {T} batches of {nb} removals outruns {E} edges")
    au = rng.integers(0, n, (T, nb))
    av = (au + 1 + rng.integers(0, n - 1, (T, nb))) % n
    rem = rng.permutation(E)[: T * nb].reshape(T, nb)
    return nb, [(au[t], av[t], rem[t]) for t in range(T)]


def run_session(ctx: Context) -> Outcome:
    from repro_torch.core import PartitionerConfig
    from repro_torch.dynamic import GraphUpdate, PartitionSession, SessionConfig
    from repro_torch.graph import GraphNP

    dev = ctx.device
    base = graphs.build(ctx.config, dev)
    ctx.log(f"perfbench: graph n={base.n} edges={base.edges}")
    base = graphs.renamed(base, torch.randperm(
        base.n, generator=torch_generator(ctx.seed, PERM, 0, dev), device=dev))
    g = GraphNP(**csr_arrays(base.n, base.lo, base.hi))
    del base.lo, base.hi        # the benchmark's device copy: not in the window's peak
    nb, batches = churn_stream(base, ctx.mix, ctx.seed)
    ref = EdgeStream(base.n, base.lo_np, base.hi_np)
    updates = []
    for au, av, rem in batches:
        updates.append(GraphUpdate.add_edges(au, av).merged(
            GraphUpdate.remove_edges(base.lo_np[rem], base.hi_np[rem])))
        ref.push(au, av, rem)
    pcfg = ctx.partitioner()
    s = derive(ctx.seed, PARTITION, 0) & 0x7FFFFFFF
    sess = PartitionSession(g, SessionConfig(
        k=int(pcfg["k"]), eps=float(pcfg["eps"]), seed=s,
        partition_cfg=PartitionerConfig(**pcfg, seed=s)), device=dev)
    del g
    warm = int(ctx.mix["warm_batches"])
    for t in range(warm):
        sess.update(updates[t])
    _sync(dev)
    steps = []
    durations = []
    _peak_reset(dev)
    setup_s = time.perf_counter() - ctx.t_start
    with _Window(ctx) as win:
        t_w = time.perf_counter()
        t = warm
        while t < len(updates):
            a = time.perf_counter()
            res = sess.update(updates[t])
            _sync(dev)
            durations.append(time.perf_counter() - a)
            steps.append((t, sess.labels_np(), res.cut, res.escalated))
            t += 1
            if time.perf_counter() - t_w >= ctx.seconds:
                break
        window_s = time.perf_counter() - t_w
    peak = _peak(dev)
    ctx.log(f"perfbench: update seconds {_quantiles(durations)}")
    if t == len(updates) and window_s < ctx.seconds:
        ctx.log(f"perfbench: the stream of {len(updates)} batches ran out after "
                f"{window_s:.3f} s")
    store = sess.store.csr_host()
    store = dict(indptr=store.indptr, indices=store.indices, ew=store.ew, nw=store.nw)
    del sess
    _free(dev)

    k, eps = int(pcfg["k"]), float(ctx.config["partitioner"]["eps"])
    checks = dict(bad_labels=0.0, overload=0.0, cut_gap=0.0)
    failed = 0
    for step, labels, cut, _ in steps:
        got = ref.judge(step, labels, cut, k, eps)
        failed += any(v > ctx.workload["limits"][name] for name, v in got.items())
        for name, v in got.items():
            checks[name] = max(checks[name], float(v))
    checks["store_gap"] = float(array_gap(store, ref.csr_after(t - 1)))
    ctx.log(f"perfbench: {len(steps)} updates of {nb} adds and {nb} removals, "
            f"{sum(e for *_, e in steps)} escalated")
    run = Run(loop="session", cell=ctx.cell, durations=durations, window_s=window_s,
              setup_s=setup_s, memory_peak_bytes=peak, spans=win.spans,
              timeline=win.timeline)
    return Outcome(run=run, checks=checks, attempted=len(steps), failed=failed)


LOOPS = dict(partition=run_partition, session=run_session)
