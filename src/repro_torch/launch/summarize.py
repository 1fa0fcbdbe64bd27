"""Render the dry-run and roofline tables from ``results/dryrun/`` (the
torch twin of ``repro.launch.summarize``).  The port's records carry the
reference's keys; where a record has no value (the port compiles nothing,
so ``t_compile_s`` is null) the table prints "–"."""

from __future__ import annotations

import glob
import json
import sys


def load(out_dir="results/dryrun", variant="base"):
    rows = []
    for f in sorted(glob.glob(f"{out_dir}/*__{variant}.json")):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def _cell(v):
    return "–" if v is None else v


def fmt_dryrun(rows):
    out = ["| arch | shape | mesh | status | GiB/dev | lower s | compile s | collective mix |",
           "|---|---|---|---|---|---|---|---|"]
    for d in sorted(rows, key=lambda d: (d["arch"], d["shape"], d["mesh"])):
        if d["status"] == "skip":
            out.append(f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
                       f"skip ({d['reason'][:40]}...) | – | – | – | – |")
            continue
        if d["status"] != "ok":
            out.append(f"| {d['arch']} | {d['shape']} | {d['mesh']} | ERROR | – | – | – | – |")
            continue
        r = d["roofline"]
        mix = ", ".join(f"{k.replace('all-','a').replace('reduce-scatter','rs').replace('collective-permute','cp')}:"
                        f"{v/2**30:.2f}G"
                        for k, v in sorted(r["collectives"].items(),
                                           key=lambda kv: -kv[1])[:3])
        gib = d["gib_per_device"]
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | ok | "
            f"{'–' if gib is None else f'{gib:.1f}'} | {_cell(d['t_lower_s'])} | "
            f"{_cell(d['t_compile_s'])} | {mix} |")
    return "\n".join(out)


def fmt_roofline(rows, mesh="single"):
    out = ["| arch | shape | compute s | memory s | collective s | dominant | "
           "MODEL/HLO flops | roofline frac | one-line fix |",
           "|---|---|---|---|---|---|---|---|---|"]
    for d in sorted(rows, key=lambda d: (d["arch"], d["shape"])):
        if d.get("mesh") != mesh or d["status"] != "ok":
            continue
        r = d["roofline"]
        dom = r["dominant"].replace("_s", "")
        fix = {
            "compute": "cut remat recompute / raise arithmetic intensity",
            "memory": "fuse more, bf16 intermediates, fewer materialized temps",
            "collective": "shard KV/state so decode reads stay local; overlap",
        }[dom]
        ur = r.get("useful_ratio")
        rf = r.get("roofline_fraction")
        out.append(
            f"| {d['arch']} | {d['shape']} | {r['compute_s']:.3g} | "
            f"{r['memory_s']:.3g} | {r['collective_s']:.3g} | {dom} | "
            f"{ur:.3f} | {rf:.4f} | {fix} |"
            if ur is not None and rf is not None else
            f"| {d['arch']} | {d['shape']} | {r['compute_s']:.3g} | "
            f"{r['memory_s']:.3g} | {r['collective_s']:.3g} | {dom} | "
            f"n/a | n/a | {fix} |")
    return "\n".join(out)


def main(out_dir="results/dryrun"):
    rows = load(out_dir)
    print("## Dry-run\n")
    print(fmt_dryrun(rows))
    print("\n## Roofline (single-pod 16x16)\n")
    print(fmt_roofline(rows, "single"))
    print("\n## Roofline (multi-pod 2x16x16)\n")
    print(fmt_roofline(rows, "multi"))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun")
