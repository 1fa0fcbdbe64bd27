"""Re-derive the roofline terms of every stored dry-run cell from the
counts its record keeps (the torch twin of ``repro.launch.reanalyze``,
which re-parses each cell's saved HLO text; the port's records carry the
per-device counts of ``launch.hlo_analysis.count_step`` under
``"counts"``).  Records without counts (skips, errors) are left alone."""

import glob
import json
import sys

from ..configs import SHAPES, get_config
from .hlo_analysis import HloCosts
from .roofline import roofline, roofline_terms


def main(out_dir="results/dryrun"):
    for jf in sorted(glob.glob(f"{out_dir}/*.json")):
        with open(jf) as f:
            d = json.load(f)
        if d.get("status") != "ok" or "counts" not in d:
            continue
        hc = HloCosts(**d["counts"])
        if d["arch"] == "paper-sclap":
            d["roofline"].update(roofline_terms(hc))
        else:
            cfg = get_config(d["arch"])
            if d.get("smoke"):
                cfg = cfg.smoke()
            shape = SHAPES[d["shape"]]
            old = d["roofline"]
            rl = roofline(hc, d["n_chips"], cfg, shape)
            rl["xla_cost_analysis_flops"] = old.get("xla_cost_analysis_flops")
            rl["xla_cost_analysis_bytes"] = old.get("xla_cost_analysis_bytes")
            rl["unknown_trip_loops"] = hc.unknown_trip_loops
            d["roofline"] = rl
        with open(jf, "w") as f:
            json.dump(d, f, indent=1)
        print(jf.split("/")[-1], "mem=%.3g" % d["roofline"]["memory_s"])


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun")
