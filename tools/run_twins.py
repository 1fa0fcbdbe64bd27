#!/usr/bin/env python3
"""Run the port's example twins (``examples/torch``) one after another, each
in its own process with ``--device``, and time each from start to exit.

Prints one line per twin (exit code, seconds, last line of its output)
and then one JSON line with the card's name and power limit and every
twin's exit code and seconds; exits non-zero if a twin failed:

    python3 tools/run_twins.py                          # all eleven, on the card
    python3 tools/run_twins.py partition_stream partition_dr --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TWINS = sorted(p.stem for p in (ROOT / "examples" / "torch").glob("*.py"))


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("twins", nargs="*", default=TWINS, choices=TWINS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    card = _card()
    print(card, flush=True)
    rows = {}
    for name in args.twins:
        t = time.perf_counter()
        try:
            p = subprocess.run(
                [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"),
                 "--device", args.device],
                capture_output=True, text=True, timeout=args.timeout, env=env, cwd=ROOT)
            rc, out, err = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = 124, e.stdout or "", f"timed out after {args.timeout} s"
        secs = time.perf_counter() - t
        lines = (out if isinstance(out, str) else out.decode()).strip().splitlines()
        print(f"{name}: exit {rc}, {secs:.1f} s; last line: "
              f"{lines[-1] if lines else ''}", flush=True)
        if rc != 0:
            print(err[-2000:] if isinstance(err, str) else err, file=sys.stderr, flush=True)
        rows[name] = dict(rc=rc, seconds=round(secs, 3))
    print(json.dumps({"card": card, "device": args.device, "twins": rows}), flush=True)
    return 0 if all(r["rc"] == 0 for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
