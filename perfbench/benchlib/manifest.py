"""``BENCHMARK.json`` and the files it names.

Every configuration, traffic mix, cell and metric is a file of its own,
found by its name: ``perfbench/configs/<config>.json``,
``perfbench/mixes/<traffic>.json``, ``perfbench/workloads/<cell>.json`` and
``perfbench/metrics/<metric>.py``."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "perfbench"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload named {cell!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config named {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str, root: Path = ROOT) -> dict:
    return load_json(root / config_entry(bench, name)["file"])


def mix_file(traffic: str, root: Path = ROOT) -> dict:
    return load_json(root / "perfbench" / "mixes" / f"{traffic}.json")


def cell_file(cell: str, root: Path = ROOT) -> dict:
    return load_json(root / "perfbench" / "workloads" / f"{cell}.json")


def metric_path(name: str, root: Path = ROOT) -> Path:
    return root / "perfbench" / "metrics" / f"{name}.py"


def reader(name: str, root: Path = ROOT) -> Callable:
    """The ``read(run)`` function of ``perfbench/metrics/<name>.py``."""
    path = metric_path(name, root)
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reports(cell: str, metric: dict, end_to_end: Optional[List[str]] = None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, else (end-to-end) every cell, else (per-layer) every cell that
    reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" not in metric:
        return True
    return metric["moves"] in (end_to_end or [])


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    e2e = [m for m in bench["end_to_end"] if reports(cell, m)]
    if not trace:
        return e2e
    names = [m["name"] for m in e2e]
    return [m for m in bench["per_layer"] if reports(cell, m, names)]
