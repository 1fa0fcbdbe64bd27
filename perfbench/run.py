"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON result line last on standard output; the checks against
the reference, each beside its limit, go last on standard error.  Exits
non-zero, with no result line, without a CUDA card, when the program cannot
be imported, or when the JAX stack was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch

    from perfbench.benchlib import manifest, runner

    bench = manifest.benchmark()
    entry = manifest.workload_entry(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"perfbench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = "cuda:0"
    torch.cuda.set_device(0)
    ctx = runner.context(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                         device, T_START)
    return runner.finish(bench, ctx, runner.execute(ctx), device)


if __name__ == "__main__":
    sys.exit(main())
