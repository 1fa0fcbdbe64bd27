"""The finer spans of the port's host work on the CPU: ``finish.balance``
and ``finish.cut`` inside ``vcycle.finish``, ``pack.plan`` and
``pack.upload`` in every pack builder and in the repair's region plan,
and ``lp.step`` around each chunk step of the batched sweep.

Each new span appears and nests where it belongs; no new name takes the
``vcycle.`` or ``repair.`` prefix that the span readers sum over; and a
traced run returns bit for bit what an untraced one does."""

import numpy as np
import pytest
import torch

from repro_torch.core import PartitionerConfig, partition
from repro_torch.dynamic import GraphUpdate, PartitionSession, SessionConfig
from repro_torch.graph.generators import rmat
from repro_torch.obs import Tracer, set_tracer

torch.set_num_threads(1)

CPU = "cpu"
# the spans the port opened before the finer ones
PARENTS = {
    "vcycle.pack", "vcycle.sweep", "vcycle.contract", "vcycle.project", "vcycle.host",
    "vcycle.evolve", "vcycle.finish", "repair.expand", "repair.gather", "repair.sweep",
    "repair.gain", "repair.balance", "session.update", "store.compact", "store.view",
    "store.vacuum",
}
NEW = {"finish.balance", "finish.cut", "pack.plan", "pack.upload", "lp.step"}
SWEEPS = ("vcycle.sweep", "vcycle.evolve", "repair.sweep")
EPS_US = 1e-3          # ts + dur is rounded once more than the parent's end


@pytest.fixture(autouse=True)
def no_tracer():
    set_tracer(None)
    yield
    set_tracer(None)


def _graph():
    return rmat(11, 8, seed=3)


def _cfg(engine):
    # every level on the device engine, the dense rounds from 128 nodes:
    # the ELL and chunk-pack gathers of the finest level and of the coarse
    # ones run
    return PartitionerConfig(k=4, preset="fast", coarsest_factor=30, numpy_below=128,
                             dense_min_n=128, refine_engine=engine)


def _traced(fn):
    tr = Tracer()
    set_tracer(tr)
    try:
        out = fn()
    finally:
        set_tracer(None)
    return out, [e for e in tr.events if e.get("ph") == "X"]


def _iv(e):
    return e["ts"], e["ts"] + e["dur"]


def _inside(child, parent):
    a, b = _iv(child)
    pa, pb = _iv(parent)
    return pa - EPS_US <= a and b <= pb + EPS_US


def _enclosed(ev, events, names):
    return any(p["name"] in names and _inside(ev, p) for p in events if p is not ev)


def _updates(n, count=3, seed=0):
    rng = np.random.default_rng(seed)
    return [GraphUpdate.add_edges(rng.integers(0, n, 24), rng.integers(0, n, 24))
            for _ in range(count)]


@pytest.fixture(scope="module")
def partition_runs():
    g = _graph()
    out = {}
    for engine in ("dense", "chunked"):
        plain = partition(g, _cfg(engine), device=CPU)
        traced, events = _traced(lambda: partition(g, _cfg(engine), device=CPU))
        out[engine] = (plain, traced, events)
    return out


@pytest.fixture(scope="module")
def session_runs():
    g = _graph()

    def serve():
        sess = PartitionSession(g, SessionConfig(k=4, seed=0), device=CPU)
        res = [sess.update(u) for u in _updates(g.n)]
        return sess, res

    plain = serve()
    traced, events = _traced(serve)
    return plain, traced, events


@pytest.mark.parametrize("engine", ["dense", "chunked"])
def test_partition_opens_every_new_span(partition_runs, engine):
    names = {e["name"] for e in partition_runs[engine][2]}
    assert NEW <= names


@pytest.mark.parametrize("engine", ["dense", "chunked"])
def test_partition_spans_nest_where_they_belong(partition_runs, engine):
    events = partition_runs[engine][2]
    finishes = [e for e in events if e["name"].startswith("finish.")]
    assert len(finishes) == 2 * sum(e["name"] == "vcycle.finish" for e in events)
    assert all(_enclosed(e, events, {"vcycle.finish"}) for e in finishes)
    steps = [e for e in events if e["name"] == "lp.step"]
    assert steps and all(_enclosed(e, events, SWEEPS) for e in steps)
    # every builder plans, then uploads
    plans = sum(e["name"] == "pack.plan" for e in events)
    assert plans == sum(e["name"] == "pack.upload" for e in events) > 0
    assert not any("args" in e for e in steps)


@pytest.mark.parametrize("engine", ["dense", "chunked"])
def test_partition_is_bit_identical_with_the_tracer_on(partition_runs, engine):
    plain, traced, _ = partition_runs[engine]
    np.testing.assert_array_equal(plain.labels, traced.labels)
    assert plain.cut == traced.cut
    assert plain.cycle_cuts == traced.cycle_cuts
    assert plain.engine_stats == traced.engine_stats


def test_session_update_opens_the_region_spans_in_order(session_runs):
    events = session_runs[2]
    names = {e["name"] for e in events}
    assert {"pack.plan", "pack.upload", "lp.step"} <= names
    for upd in (e for e in events if e["name"] == "session.update"):
        inner = sorted((e for e in events if _inside(e, upd) and e is not upd),
                       key=lambda e: e["ts"])
        order = [e["name"] for e in inner]
        i_exp, i_gat = order.index("repair.expand"), order.index("repair.gather")
        plan = next(e for e in inner if e["name"] == "pack.plan")
        assert i_exp < order.index("pack.plan") < i_gat
        assert _iv(plan)[0] >= _iv(inner[i_exp])[1] - EPS_US
        assert _iv(plan)[1] <= inner[i_gat]["ts"] + EPS_US
        assert order.index("pack.upload") < i_gat
        # the steps of an update are the region sweep's
        steps = [e for e in inner if e["name"] == "lp.step"]
        assert steps and all(_enclosed(e, inner, {"repair.sweep"}) for e in steps)
    # the session's first partition() sweeps under the V-cycle's spans
    steps = [e for e in events if e["name"] == "lp.step"]
    assert all(_enclosed(e, events, SWEEPS) for e in steps)


def test_session_is_bit_identical_with_the_tracer_on(session_runs):
    (s0, r0), (s1, r1), _ = session_runs
    np.testing.assert_array_equal(s0.labels_np(), s1.labels_np())
    assert [r.cut for r in r0] == [r.cut for r in r1]
    assert [(r.region_size, r.escalated) for r in r0] == [
        (r.region_size, r.escalated) for r in r1]
    assert s0.engine.stats_dict() == s1.engine.stats_dict()


def test_no_new_span_takes_a_summed_prefix(partition_runs, session_runs):
    names = {e["name"] for e in session_runs[2]}
    for _, _, events in partition_runs.values():
        names |= {e["name"] for e in events}
    new = names - PARENTS
    assert new == NEW
    assert not any(n.startswith(("vcycle.", "repair.")) for n in new)


def test_lp_step_is_the_shared_noop_when_off():
    from repro_torch.obs import span
    from repro_torch.obs.trace import _NOOP

    assert span("lp.step") is _NOOP
    tr = Tracer(enabled=False)
    set_tracer(tr)
    assert span("lp.step") is _NOOP
