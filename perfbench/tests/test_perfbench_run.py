"""``run.py`` end to end on the CPU: no card, no result; what it imports;
and the checks, which pass on sound runs and fail on the control and on
faults planted underneath the timed path."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _perfbench_tiny as tiny  # noqa: E402

import torch  # noqa: E402

ROOT = tiny.ROOT
PARTITION_CELLS = ["kron19-simple.partition", "rgg20.partition"]
ENV = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


def test_no_card_no_result():
    res = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
                          "kron19-simple.partition", "--seed", str(tiny.SEED), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT, env=ENV,
                         timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_a_run_loads_no_jax_and_the_reference_no_program():
    """A fresh interpreter drives one tiny cell of each loop through the
    program on the CPU, loads every metric reader as a run does, and
    reports the loaded top-level names; a second one imports every module
    of the reference."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import _perfbench_tiny as t; from perfbench.benchlib import manifest, runner;"
        "[runner.execute(t.context(c)) for c in ('kron19-simple.partition',"
        " 'kron19-simple.churn')];"
        "b = manifest.benchmark();"
        "[manifest.reader(m['name']) for m in b['end_to_end'] + b['per_layer']];"
        "print(sorted({m.split('.')[0] for m in sys.modules}))"
    )
    res = subprocess.run([sys.executable, "-c", code, str(Path(__file__).parent)],
                         capture_output=True, text=True, cwd=ROOT, env=ENV, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    tops = set(ast.literal_eval(res.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import perfbench.reference.partition, perfbench.reference.stream,"
            " perfbench.reference.lp_score;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    res = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, cwd=ROOT, env=ENV, timeout=120)
    tops = set(ast.literal_eval(res.stdout.strip().splitlines()[-1]))
    assert not tops & {"torch", "repro_torch", "jax", "repro"}


def test_reference_sources_import_only_numpy():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or "."] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] in ("numpy", "math", "__future__"), (path, name)


@pytest.mark.parametrize("cell", PARTITION_CELLS + ["kron19-simple.churn"])
def test_sound_runs_are_correct(cell):
    ctx, out, ok = tiny.run(cell)
    assert ok, out.checks
    assert out.attempted >= 1 and out.failed == 0
    assert set(out.checks) == set(ctx.workload["limits"])
    if ctx.mix["loop"] == "partition":
        assert out.run.launches, "the dense refinement never launched lp_score_rows"


def test_every_seed_takes_the_same_inputs_in_another_order():
    """The window ends on a whole rotation of the pool, so seeds that take
    the inputs in other orders partition the same inputs equally often."""
    from perfbench.benchlib.loops import call_order

    orders = {tuple(call_order(tiny.SEED + s, 4)) for s in range(6)}
    assert all(sorted(o) == [0, 1, 2, 3] for o in orders) and len(orders) > 1
    first = call_order(tiny.SEED, 2)[0]              # the tiny cells' pool holds 2
    other = next(s for s in range(1, 100) if call_order(s, 2)[0] != first)
    a = tiny.run("kron19-simple.partition", seed=other)[1]
    b = tiny.run("kron19-simple.partition", seed=tiny.SEED)[1]
    assert a.run.calls % 2 == 0 and b.run.calls % 2 == 0
    assert a.run.series["cut_frac"][:2] == b.run.series["cut_frac"][1::-1]
    assert sorted(a.run.series["cut_frac"]) == sorted(b.run.series["cut_frac"])


@pytest.mark.parametrize("cell", PARTITION_CELLS + ["kron19-simple.churn"])
def test_control_is_not_correct(cell):
    """The control: the program with its balance bound relaxed to the
    cell's control eps, judged against the configuration's 3 %."""
    _, out, ok = tiny.run(cell, control=True)
    assert not ok and out.checks["overload"] > 0


def _altered_partition(monkeypatch):
    import repro_torch.core as core

    inner = core.partition

    def fault(g, cfg, **kw):
        rep = inner(g, cfg, **kw)
        v = int(np.argmax(g.degrees()))           # a hub moves, its cut does not
        lab = rep.labels.copy()
        lab[v] = (lab[v] + 1) % cfg.k
        return dataclasses.replace(rep, labels=lab)

    monkeypatch.setattr(core, "partition", fault)


def _altered_scores(monkeypatch):
    from repro_torch.kernels.lp_score import ops

    inner = ops.lp_score_rows
    monkeypatch.setattr(ops, "lp_score_rows", lambda lbl, w, k: inner(lbl, w, k) + 1.0)


def _bypassed_kernel(monkeypatch):
    """The dense round reaches the kernel by its own module's name, not the
    name the capture wraps."""
    import importlib

    from repro_torch.kernels.lp_score import ops

    direct = importlib.import_module("repro_torch.kernels.lp_score.lp_score").lp_score_rows
    inner = ops._row_scores

    def fault(*a, **kw):
        wrapped = ops.lp_score_rows
        ops.lp_score_rows = direct
        try:
            return inner(*a, **kw)
        finally:
            ops.lp_score_rows = wrapped

    monkeypatch.setattr(ops, "_row_scores", fault)


def _session_fault(monkeypatch, kind):
    from repro_torch.dynamic import PartitionSession

    inner = PartitionSession.update

    def fault(self, upd):
        if kind == "unchanged":
            return self.trajectory[-1]
        if kind == "half":
            h = len(upd.add_u) // 2
            upd = dataclasses.replace(upd, add_u=upd.add_u[:h], add_v=upd.add_v[:h],
                                      add_w=upd.add_w[:h], rem_u=upd.rem_u[:h],
                                      rem_v=upd.rem_v[:h], rem_w=upd.rem_w[:h])
            return inner(self, upd)
        res = inner(self, upd)
        lab = self.labels.clone()
        lab[0] = (lab[0] + 1) % self.k
        self.labels = lab
        return res

    monkeypatch.setattr(PartitionSession, "update", fault)


PARTITION_FAULTS = dict(answer=(_altered_partition, "cut_gap"),
                        kernel=(_altered_scores, "score_gap"),
                        bypass=(_bypassed_kernel, "kernel_unchecked"))


@pytest.mark.parametrize("cell", PARTITION_CELLS)
@pytest.mark.parametrize("fault", sorted(PARTITION_FAULTS))
def test_partition_faults_are_caught(monkeypatch, cell, fault):
    plant, check = PARTITION_FAULTS[fault]
    plant(monkeypatch)
    _, out, ok = tiny.run(cell)
    assert not ok
    assert out.checks[check] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "answer"])
def test_churn_faults_are_caught(monkeypatch, fault):
    _session_fault(monkeypatch, fault)
    _, out, ok = tiny.run("kron19-simple.churn")
    assert not ok
    gap = "cut_gap" if fault == "answer" else "store_gap"
    assert out.checks[gap] > 0


def test_result_line_carries_the_checks_last(capsys):
    from perfbench.benchlib import runner

    ctx, out, _ = tiny.run("kron19-simple.partition")
    out.run.memory_peak_bytes = 1
    line = runner.result(tiny.manifest.benchmark(), ctx, out, dict(platform="gpu",
                         kind="test", count=1))
    runner.emit(line, log=print)
    printed = capsys.readouterr().out.strip().splitlines()
    last = json.loads(printed[-1])
    assert list(last)[-1] == "checks" and last["correct"] is True
    assert set(last["metrics"]) == {"partition_s", "cut_frac", "peak_mem_gib", "setup_s"}
    assert set(last["checks"]) == {"bad_labels", "overload", "cut_gap", "score_gap",
                                   "kernel_unchecked"}
    assert printed[-2].startswith("check ")


def test_a_module_loaded_while_the_line_is_built_stops_the_result(monkeypatch, capsys):
    """The look for the JAX stack comes after every metric reader and the
    card's description are loaded, just before the line is printed."""
    import types

    from perfbench.benchlib import runner

    ctx, out, _ = tiny.run("kron19-simple.partition")
    out.run.memory_peak_bytes = 1
    bench = tiny.manifest.benchmark()
    planted = "perfbench_planted_jax"     # a test process may hold the real one already
    monkeypatch.setattr(runner, "FORBIDDEN", (planted,))

    def card(device):
        monkeypatch.setitem(sys.modules, planted, types.ModuleType(planted))
        return dict(platform="gpu", kind="test", count=1)

    monkeypatch.setattr(runner, "card", card)
    monkeypatch.setattr(runner, "card_line", lambda: "test")
    assert runner.finish(bench, ctx, out, "cpu") != 0
    captured = capsys.readouterr()
    assert captured.out.strip() == "" and planted in captured.err
    monkeypatch.delitem(sys.modules, planted)
    monkeypatch.setattr(runner, "card", lambda device: dict(platform="gpu", kind="test",
                                                            count=1))
    assert runner.finish(bench, ctx, out, "cpu") == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"]


@pytest.mark.cuda
def test_one_short_run_on_the_card(card):
    res = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
                          "kron19-simple.partition", "--seed", str(tiny.SEED), "--seconds",
                          "1", "--trace", "1"], capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
