"""Readings of a cell's checks over many seeds in one process, for setting
the limits: the program as the configuration states it, or with
``--control`` the cell's control in its place (the program with the
balance bound relaxed to the cell file's ``control`` settings, judged
against the configuration's own bound).  The benchmark's runs never run
this.

    python3 perfbench/readings.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--control]

Prints one JSON line per seed, then the largest reading of each check.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.benchlib import manifest, runner

    if not torch.cuda.is_available():
        print("perfbench: readings need a CUDA card", file=sys.stderr)
        return 2
    bench = manifest.benchmark()
    worst = {}
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = runner.context(bench, args.workload, seed, args.seconds, False, "cuda:0", t,
                             control=args.control)
        out = runner.execute(ctx)
        limits = ctx.workload["limits"]
        e2e = runner.metrics_block(bench, out, False)
        print(json.dumps(dict(seed=seed, control=args.control,
                              correct=runner.correct(out, limits), attempted=out.attempted,
                              failed=out.failed, checks=out.checks,
                              metrics={k: v["value"] for k, v in e2e.items()},
                              seconds=time.perf_counter() - t)), flush=True)
        for name, v in out.checks.items():
            worst[name] = max(worst.get(name, 0.0), v)
        del out
        torch.cuda.empty_cache()
    print(json.dumps(dict(workload=args.workload, control=args.control, seeds=args.seeds,
                          largest=worst)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
