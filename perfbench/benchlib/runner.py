"""One run of one cell: the loop its mix names, the metrics its readers
give, the checks against the cell's limits, and the result line."""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Optional

from . import manifest
from .devtrace import name_gaps, top
from .loops import LOOPS, Context, Outcome

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def context(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device: str,
            t_start: float, control: bool = False, root=manifest.ROOT) -> Context:
    entry = manifest.workload_entry(bench, cell)
    return Context(cell=cell, config=manifest.config_file(bench, entry["config"], root),
                   mix=manifest.mix_file(entry["traffic"], root),
                   workload=manifest.cell_file(cell, root), seed=seed, seconds=seconds,
                   trace=trace, device=device, t_start=t_start, control=control)


def execute(ctx: Context) -> Outcome:
    return LOOPS[ctx.mix["loop"]](ctx)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's, the JAX
    package's or its benchmark's."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def checks_block(out: Outcome, limits: dict) -> dict:
    return {name: {"value": v, "limit": limits[name]} for name, v in out.checks.items()}


def correct(out: Outcome, limits: dict) -> bool:
    return out.failed == 0 and all(v <= limits[name] for name, v in out.checks.items())


def metrics_block(bench: dict, out: Outcome, trace: bool, root=manifest.ROOT) -> dict:
    wanted = manifest.metrics_for(bench, out.run.cell, trace)
    block = {}
    for m in wanted:
        v = manifest.reader(m["name"], root)(out.run)
        if v is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing in "
                                   f"{out.run.cell}")
            continue
        block[m["name"]] = {"value": v, "unit": m["unit"]}
    return block


def breakdown(out: Outcome) -> Optional[dict]:
    tl = out.run.timeline
    if tl is None:
        return None
    return dict(device_ops=top(tl.by_name()),
                idle_gaps=top(name_gaps(tl.idle(), out.run.spans)))


def card(device: str) -> dict:
    import torch

    return dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=1)


def card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def result(bench: dict, ctx: Context, out: Outcome, dev_info: dict) -> dict:
    limits = ctx.workload["limits"]
    line = dict(correct=correct(out, limits), attempted=out.attempted, failed=out.failed,
                metrics=metrics_block(bench, out, ctx.trace),
                device=dict(dev_info, memory_peak_bytes=out.run.memory_peak_bytes))
    if ctx.trace:
        tl = out.run.timeline
        if tl is None:
            raise RuntimeError("the profiler recorded no device activity in the window")
        line["device"]["busy_s"] = tl.busy_s
        line["device"]["window_s"] = tl.window_s
        line["breakdown"] = breakdown(out)
    line["checks"] = checks_block(out, limits)
    return line


def finish(bench: dict, ctx: Context, out: Outcome, device: str) -> int:
    """Build the result line in full (every metric reader loaded), then
    look for the JAX stack in the process, and print the line only where
    none of it was loaded."""
    line = result(bench, ctx, out, card(device))
    ctx.log(f"perfbench: card {card_line()}")
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}: the port must not use the JAX stack",
              file=sys.stderr)
        return 3
    emit(line)
    return 0


def emit(line: dict, log=lambda s: print(s, file=sys.stderr, flush=True)) -> None:
    """The checks as the last lines on standard error, then the result as
    the last line on standard output."""
    for name, c in line["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
