"""The aggregation arithmetic and the metric readers on synthetic runs."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _perfbench_tiny import manifest  # noqa: E402

from perfbench.benchlib import devtrace, peaks, stats  # noqa: E402
from perfbench.benchlib.devtrace import Timeline  # noqa: E402
from perfbench.benchlib.record import Run  # noqa: E402


def read(name, run):
    return manifest.reader(name)(run)


def test_percentile_and_mean_take_every_sample():
    xs = list(np.random.default_rng(0).exponential(1.0, 71))
    for q in (50, 90, 95):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))
    assert stats.mean(xs) == pytest.approx(float(np.mean(xs)))
    run = Run(loop="session", cell="c", durations=xs, window_s=sum(xs), setup_s=3.0,
              memory_peak_bytes=2**31)
    assert read("update_p90_s", run) == pytest.approx(float(np.percentile(xs, 90)))
    assert read("peak_mem_gib", run) == 2.0
    assert read("setup_s", run) == 3.0
    assert read("partition_s", run) is None


def test_partition_metrics_are_whole_window_means():
    run = Run(loop="partition", cell="c", durations=[9.0, 11.0, 10.0, 12.0], window_s=42.0,
              setup_s=1.0, memory_peak_bytes=1, series=dict(cut_frac=[0.5, 0.7, 0.6, 0.6]))
    assert read("partition_s", run) == 10.5
    assert read("cut_frac", run) == pytest.approx(0.6)
    assert read("update_p90_s", run) is None


def test_busy_idle_and_gaps_of_a_synthetic_timeline():
    ops = [("k1", 1.0, 2.0), ("k2", 1.5, 2.5), ("k1", 4.0, 4.5), ("copy", 9.0, 9.5)]
    tl = Timeline(window_s=10.0, t0=0.0, t1=10.0, ops=ops)
    assert tl.busy_s == pytest.approx(2.5)
    assert tl.idle() == [(0.0, 1.0), (2.5, 4.0), (4.5, 9.0), (9.5, 10.0)]
    assert tl.op_seconds("k1") == (1.5, 2)
    spans = [("session.update", 0.6, 9.8), ("repair.sweep", 2.4, 4.2)]
    named = devtrace.name_gaps(tl.idle(), spans)
    assert named == pytest.approx({"no span": 1.0, "repair.sweep": 1.5,
                                   "session.update": 4.5 + 0.5})
    run = Run(loop="session", cell="c", durations=[1.0], window_s=10.0, setup_s=1.0,
              memory_peak_bytes=1, timeline=tl, spans=spans)
    assert read("device_idle.update", run) == pytest.approx(75.0)
    assert read("device_idle.partition", run) is None
    assert devtrace.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0], ["c", 2.0]]


def test_span_metrics_per_call():
    spans = [("vcycle.pack", 0.0, 1.0), ("vcycle.pack", 2.0, 2.5), ("vcycle.sweep", 3.0, 5.0),
             ("repair.gather", 0.0, 0.25), ("repair.sweep", 1.0, 1.5)]
    run = Run(loop="partition", cell="c", durations=[4.0, 6.0], window_s=10.0, setup_s=1.0,
              memory_peak_bytes=1, spans=spans)
    assert read("pack_s.partition", run) == 0.75
    assert read("sweep_s.partition", run) == 1.0
    assert read("evolve_s.partition", run) is None
    run.loop = "session"
    assert read("repair_s.update", run) == 0.375


def test_cut_frac_is_the_mean_over_the_calls():
    run = Run(loop="partition", cell="c", durations=[4.0, 6.0, 5.0, 5.0], window_s=20.0,
              setup_s=1.0, memory_peak_bytes=1,
              series=dict(cut_frac=[0.5, 0.7, 0.7, 0.5]))
    assert read("cut_frac", run) == pytest.approx(0.6)
    run.loop = "session"
    assert read("cut_frac", run) is None


def test_lp_score_rows_bytes_and_roofline():
    assert peaks.lp_score_rows_bytes(256, 128, 16) == 256 * 128 * 8 + 256 * 16 * 4
    launches = [(1 << 20, 128, 16), (1 << 19, 128, 16)]
    need = sum(peaks.lp_score_rows_bytes(*s) for s in launches)
    t = need / peaks.HBM_BYTES_PER_S / 0.7
    tl = Timeline(window_s=1.0, t0=0.0, t1=1.0,
                  ops=[("lp_score_rows_kernel<true>", 0.1, 0.1 + t / 2),
                       ("lp_score_rows_kernel<true>", 0.5, 0.5 + t / 2), ("other", 0.8, 0.9)])
    run = Run(loop="partition", cell="c", durations=[1.0], window_s=1.0, setup_s=1.0,
              memory_peak_bytes=1, timeline=tl, launches=launches)
    assert read("lp_score_rows.roofline", run) == pytest.approx(70.0)
    run.launches = launches[:1]           # a launch the capture missed: no reading
    assert read("lp_score_rows.roofline", run) is None
