"""A cell of the benchmark cut to a size the CPU runs in a second or two,
for the tests: the same loops, generator, capture and reference, with the
program on ``device="cpu"`` (its kernels' plain versions)."""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from perfbench.benchlib import manifest, runner  # noqa: E402

SEED = 2**31 + 12345          # larger than 32 signed bits hold


def context(cell: str, seed: int = SEED, control: bool = False, trace: bool = False):
    torch.set_num_threads(1)
    bench = manifest.benchmark()
    ctx = runner.context(bench, cell, seed, 0.05, trace, "cpu", time.perf_counter(),
                         control=control)
    ctx.config["scale"] = 9 if ctx.config["family"] == "kron" else 10
    ctx.config["partitioner"].update(k=4, dense_min_n=128, numpy_below=128,
                                     coarsest_factor=30)
    if ctx.mix["loop"] == "partition":
        ctx.mix.update(pool=2)
    else:
        ctx.mix.update(batches=6, per_mille=10)
    ctx.log = lambda *a: None
    return ctx


def run(cell: str, **kw):
    ctx = context(cell, **kw)
    out = runner.execute(ctx)
    return ctx, out, runner.correct(out, ctx.workload["limits"])
