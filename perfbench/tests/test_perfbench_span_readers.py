"""The readers of the finer program spans (the host finish's halves, the
pack builders' planning and uploads, the sweeps' chunk steps, the
contraction) on synthetic runs: the value per call or update, nothing
without spans, and nothing in the other loop."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _perfbench_tiny import manifest  # noqa: E402

from perfbench.benchlib.record import Run  # noqa: E402

PARTITION_SPANS = [
    ("vcycle.pack", 0.0, 1.0), ("pack.plan", 0.1, 0.6), ("pack.upload", 0.6, 0.9),
    ("pack.plan", 1.0, 1.5), ("pack.upload", 1.5, 1.75), ("vcycle.pack", 1.75, 2.0),
    ("vcycle.sweep", 2.0, 3.0), ("lp.step", 2.0, 2.25), ("lp.step", 2.25, 2.5),
    ("lp.step", 2.5, 3.0), ("vcycle.contract", 3.0, 3.5), ("vcycle.evolve", 3.5, 4.0),
    ("lp.step", 3.5, 3.75),
    ("vcycle.finish", 4.0, 6.0), ("finish.balance", 4.0, 5.5), ("finish.cut", 5.5, 6.0),
]
SESSION_SPANS = [
    ("session.update", 0.0, 2.0), ("repair.expand", 0.0, 0.25), ("pack.plan", 0.25, 0.5),
    ("pack.upload", 0.5, 0.625), ("repair.gather", 0.625, 0.75),
    ("repair.sweep", 0.75, 1.75), ("lp.step", 0.75, 1.0), ("lp.step", 1.0, 1.5),
    ("lp.step", 1.5, 1.75),
]

# name -> (loop, spans, value over two calls or updates)
CASES = {
    "balance_s.partition": ("partition", PARTITION_SPANS, 0.75),
    "finish_cut_s.partition": ("partition", PARTITION_SPANS, 0.25),
    "pack_plan_s.partition": ("partition", PARTITION_SPANS, 0.5),
    "pack_upload_s.partition": ("partition", PARTITION_SPANS, 0.275),
    "lp_steps.partition": ("partition", PARTITION_SPANS, 2.0),
    "contract_s.partition": ("partition", PARTITION_SPANS, 0.25),
    "lp_steps.update": ("session", SESSION_SPANS, 1.5),
    "lp_step_us.update": ("session", SESSION_SPANS, 1e6 / 3.0),
    "pack_plan_s.update": ("session", SESSION_SPANS, 0.125),
}


def _run(loop, spans):
    return Run(loop=loop, cell="c", durations=[3.0, 5.0], window_s=8.0, setup_s=1.0,
               memory_peak_bytes=1, spans=list(spans))


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_value_per_call_or_update(name):
    loop, spans, value = CASES[name]
    assert manifest.reader(name)(_run(loop, spans)) == pytest.approx(value)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_reads_nothing_without_its_spans(name):
    loop, spans, _ = CASES[name]
    assert manifest.reader(name)(_run(loop, [])) is None
    # the parents alone, as a program without the finer spans records them
    parents = [s for s in spans if s[0].startswith(("vcycle.", "repair.", "session."))]
    if name != "contract_s.partition":
        assert manifest.reader(name)(_run(loop, parents)) is None


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_reads_nothing_in_the_other_loop(name):
    loop, spans, _ = CASES[name]
    other = "session" if loop == "partition" else "partition"
    assert manifest.reader(name)(_run(other, spans)) is None


def test_finish_halves_add_up_to_the_finish():
    run = _run("partition", PARTITION_SPANS)
    halves = (manifest.reader("balance_s.partition")(run)
              + manifest.reader("finish_cut_s.partition")(run))
    assert halves == pytest.approx(manifest.reader("finish_s.partition")(run))
