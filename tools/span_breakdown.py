#!/usr/bin/env python3
"""Per-span seconds of one ``repro_torch`` ``partition()`` run on the GPU.

Partitions ``rmat(scale, edge_factor, seed=1)`` without its isolated nodes
(the graph of ``chip_smoke.py``) at k=16 with dense refinement and prints
one JSON line: the card, the tree's source directory, the run's seconds,
and for each span group its call count, total seconds and per-call
seconds.  ``--src`` picks the ``src`` directory the package is imported
from, so two versions of the port can be compared on one card, each in
its own process:

    python3 tools/span_breakdown.py --src src --evo-engine host
    python3 tools/span_breakdown.py --src /path/to/other/checkout/src --evo-engine host

Run them in the order A, B, B, A inside one machine session and compare
the groups (``sweep.cluster``, ``sweep.dense``, ...) only within it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def group_of(ev: dict) -> str:
    """The group a span belongs to, as ``chip_smoke.py`` prints them."""
    a = ev.get("args", {})
    if ev["name"] == "vcycle.pack":
        return "pack.ell" if a.get("mode") == "ell" else "pack.gather"
    if ev["name"] == "vcycle.sweep":
        return f"sweep.{a.get('mode')}"
    if ev["name"] == "vcycle.evolve":
        return f"evolve.{a.get('engine', 'host')}"
    return ev["name"].split(".", 1)[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True, help="directory that holds repro_torch")
    ap.add_argument("--scale", type=int, default=19)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--preset", default="fast")
    ap.add_argument("--evo-engine", default="auto")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("span_breakdown: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import _card_line, make_graph
    from repro_torch.core import PartitionerConfig, partition
    from repro_torch.obs import Tracer, set_tracer

    g = make_graph(args.scale, args.edge_factor)
    cfg = PartitionerConfig(k=args.k, preset=args.preset, refine_engine="dense",
                            evo_engine=args.evo_engine, coarsest_factor=100, seed=0)
    tracer = Tracer()
    set_tracer(tracer)
    torch.cuda.synchronize()
    t = time.perf_counter()
    rep = partition(g, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    set_tracer(None)

    groups = {}
    for ev in tracer.events:
        groups.setdefault(group_of(ev), []).append(ev["dur"] / 1e6)
    print(json.dumps({
        "card": _card_line(),
        "src": str(src),
        "graph": f"rmat({args.scale}, {args.edge_factor}) without isolated nodes, n={g.n}",
        "config": dict(k=args.k, preset=args.preset, evo_engine=args.evo_engine),
        "wall_s": wall,
        "partition_s": rep.seconds,
        "cut": rep.cut,
        "dense_rounds": rep.engine_stats["dense_rounds"],
        "spans": {name: dict(calls=len(d), total_s=sum(d), per_call_s=d)
                  for name, d in sorted(groups.items())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
