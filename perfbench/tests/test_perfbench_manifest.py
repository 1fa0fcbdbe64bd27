"""BENCHMARK.json against the benchmark's contract and its own files."""

import json
import re
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _perfbench_tiny import ROOT, manifest  # noqa: E402

BENCH = manifest.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CHECKS = dict(partition={"bad_labels", "overload", "cut_gap", "score_gap",
                         "kernel_unchecked"},
              session={"bad_labels", "overload", "cut_gap", "store_gap"})


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]


def test_run_seconds_fit_the_check_with_24_cells():
    s = BENCH["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert manifest.NAME.match(n), n
    for m in METRICS:
        assert manifest.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert manifest.NAME.match(w["traffic"]) and manifest.NAME.match(w["config"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert 1 <= len(c["source"]) <= 200
        assert all(manifest.NAME.match(k) for k in c["reduced"])


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    entry = manifest.workload_entry(BENCH, cell)
    wl = manifest.cell_file(cell)
    assert (wl["config"], wl["traffic"]) == (entry["config"], entry["traffic"])
    cfg = manifest.config_file(BENCH, entry["config"])
    mix = manifest.mix_file(entry["traffic"])
    assert set(wl["limits"]) == CHECKS[mix["loop"]]
    assert cfg["name"] == entry["config"]
    names = {m["name"] for m in manifest.metrics_for(BENCH, cell, False)}
    assert "setup_s" in names and len(names) >= 2
    assert manifest.metrics_for(BENCH, cell, True)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file_states_source_reduced_assumed(name):
    entry = manifest.config_entry(BENCH, name)
    cfg = manifest.config_file(BENCH, name)
    assert entry["file"].startswith("perfbench/configs/")
    assert cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    assert all(k in cfg for k in cfg["reduced"])
    assert "assumed" in cfg and "partitioner" in cfg


@pytest.mark.parametrize("name", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(name):
    assert callable(manifest.reader(name))


def test_layer_metrics_list_the_cells_that_report_what_they_move():
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        reporting = moved.get("workloads", CELLS)
        assert sorted(m["workloads"]) == sorted(reporting), m["name"]
    for c in CELLS:
        assert manifest.metrics_for(BENCH, c, True)


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "perfbench").rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or rel.startswith("perfbench/out"):
            continue
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
        if p.suffix == ".json":
            json.loads(p.read_text())
