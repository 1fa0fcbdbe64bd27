"""Port parity for the rest of obs: repro_torch.obs (memory accounting,
the shape-bucket watchdog, the static registration checks, SLO export and
the tracer's memory hook) on the CPU against repro.obs on the same inputs.

The accountant counts storages, not views; the SLO export equals the
reference's byte for byte; the watchdog's per-family bucket counts equal
the reference's on the same partition() and session stream; the
accounted total covers the live tensors of a served stream within the
reference's oracle bounds [0.85, 1.001]; and estimate_footprint is within
its stated tolerance of the measured family peaks."""

import gc
import json
import os
import time
import warnings

import numpy as np
import pytest
import torch

import repro.graph as R
import repro.obs as ref_obs
import repro.obs.export as ref_export
from repro.core import PartitionerConfig as RefPartitionerConfig
from repro.core import partition as ref_partition
from repro.dynamic import GraphUpdate as RefUpdate
from repro.dynamic import PartitionSession as RefSession
from repro.dynamic import SessionConfig as RefConfig

import repro_torch.obs as obs
import repro_torch.obs.export as port_export
from repro_torch.core import LPEngine, PartitionerConfig, partition
from repro_torch.dynamic import GraphUpdate, PartitionSession, SessionConfig
from repro_torch.graph import from_reference
from repro_torch.kernels import build
from repro_torch.obs import (
    MEMORY_FAMILIES, CompileWatchdog, MetricsRegistry, Tracer, WatchdogError,
    account, accountant, estimate_footprint, pin, set_accounting, set_tracer,
    watchdog, will_fit,
)
from repro_torch.obs.memory import FOOTPRINT_TOLERANCE
from repro_torch.obs.static_check import (
    check_alloc_registration, check_registration, stale_alloc_sites,
    stale_jit_sites,
)

torch.set_num_threads(1)

CPU = "cpu"
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src", "repro_torch")
_FIELDS = ("add_u", "add_v", "add_w", "rem_u", "rem_v", "rem_w", "add_node_w")


@pytest.fixture(autouse=True)
def fresh_obs():
    """The accountant and the watchdog are process-global, and xdist runs
    a whole file in one worker: every test starts and ends with both
    reset, disabled and lenient."""
    a, wd = accountant(), watchdog()
    a.reset()
    set_accounting(False)
    a.registry = None
    wd.reset()
    wd.set_strict(False)
    wd.unseal()
    yield
    set_tracer(None)
    set_accounting(False)
    a.reset()
    a.registry = None
    wd.reset()
    wd.set_strict(False)
    wd.unseal()


def _port(g):
    return from_reference(g.indptr, g.indices, g.ew, g.nw)


def _twin(upd):
    return GraphUpdate(**{f: getattr(upd, f) for f in _FIELDS})


def _stream(n, batches, nb, seed):
    """Edge adds and removals of the reference's memory-oracle test."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        u = rng.integers(0, n, nb)
        v = rng.integers(0, n, nb)
        keep = u != v
        out.append(RefUpdate.add_edges(u[keep], v[keep]))
        out.append(RefUpdate.remove_edges(u[keep], v[keep]))
    return out


# ---------------------------------------------------------------- accountant


def test_register_release_pin_and_idempotence():
    a = accountant()
    set_accounting(True)
    x = torch.zeros(1024, dtype=torch.int32)
    nb = x.untyped_storage().nbytes()
    a.register("base_csr", x)
    assert a.bytes_by_family["base_csr"] == nb == a.total
    a.register("base_csr", x)                  # idempotent per buffer
    a.register("chunk_packs", x)               # even across families
    assert a.total == nb and a.bytes_by_family["chunk_packs"] == 0
    pin("snapshot_refs", x)
    assert a.pinned_by_family["snapshot_refs"] == nb
    assert a.total == nb                       # pins never add to the total
    with pytest.raises(KeyError):
        a.register("not_a_family", torch.zeros(8))
    del x
    gc.collect()
    assert a.total == 0 and a.bytes_by_family["base_csr"] == 0
    assert a.pinned_by_family["snapshot_refs"] == 0
    assert a.peak_by_family["base_csr"] == nb  # peaks survive release


def test_views_of_one_buffer_count_once_and_keep_it_live():
    a = accountant()
    set_accounting(True)
    t = torch.arange(4096, dtype=torch.int64)
    account("label_arenas", t, t[:10], t.view(-1), t[6:].view(2, -1)[0])
    assert a.total == 4096 * 8 and len(a._live) == 1
    tail = t[100:200]                          # a view outlives the registration
    del t
    gc.collect()
    assert a.total == 4096 * 8                 # the storage is still live
    account("chunk_packs", tail)               # and still known
    assert a.bytes_by_family["chunk_packs"] == 0
    del tail
    gc.collect()
    assert a.total == 0
    # the storage object is stable: a finalizer per call would have fired
    u = torch.ones(16)
    assert u.untyped_storage() is u.untyped_storage()
    account("base_csr", u)
    gc.collect()
    assert a.total == 64


def test_disabled_accounting_is_inert_and_cheap():
    a = accountant()
    assert not a.enabled
    x = torch.zeros(4096, dtype=torch.int32)
    account("base_csr", x)
    pin("snapshot_refs", x)
    assert a.total == 0 and a.calls == 0 and not a._live and not a._pins
    n = 50_000
    t0 = time.perf_counter()
    for _ in range(n):
        account("base_csr", x)
    ns = (time.perf_counter() - t0) / n * 1e9
    assert ns < 5_000, f"disabled account() {ns:.0f} ns/call"


def test_registry_gauges_and_counter_events_follow_accounting():
    reg = MetricsRegistry("t")
    tr = Tracer()
    set_tracer(tr)
    with obs.span("off.span"):
        pass
    assert [e["ph"] for e in tr.events] == ["X"]          # accounting off
    assert not accountant().span_marks
    set_accounting(True, registry=reg)
    x = torch.zeros(256, dtype=torch.int64)
    with obs.span("on.span", n=7) as sp:
        account("overlay_chunks", x)
        sp.sync_on(x)
    assert reg.get_gauge("mem.overlay_chunks_bytes") == 2048
    assert reg.get_gauge("mem.total_bytes") == 2048
    assert [e["ph"] for e in tr.events] == ["X", "X", "C"]
    c = tr.events[-1]
    assert c["name"] == "device_memory" and c["args"]["overlay_chunks"] == 2048
    assert set(c["args"]) == set(MEMORY_FAMILIES)
    (mark,) = accountant().span_marks
    assert mark["name"] == "on.span" and mark["n"] == 7 and mark["total"] == 2048


# ------------------------------------------------------------------ watchdog


def test_watchdog_strict_seal_and_snapshot():
    wd = CompileWatchdog()
    assert wd.note("engine.sweep", ("b", 1)) is True
    assert wd.note("engine.sweep", ("b", 1)) is False
    assert wd.note("engine.sweep", ("b", 2)) is True
    assert wd.compile_count("engine.sweep") == 2 == wd.bucket_count("engine.sweep")
    assert wd.snapshot()["kernels"]["engine.sweep"]["compiles"] == 2
    wd.set_strict(True)
    with pytest.raises(WatchdogError, match="undeclared kernel family"):
        wd.note("rogue.kernel", ("k",))
    wd.set_strict(False)
    assert wd.note("rogue.kernel", ("k",)) is True
    wd.seal()
    assert wd.note("engine.sweep", ("b", 2)) is False     # known: fine
    with pytest.raises(WatchdogError, match="sealed bucket set"):
        wd.note("engine.sweep", ("b", 3))
    wd.unseal()
    assert wd.note("engine.sweep", ("b", 3)) is True
    wd.reset()
    assert wd.compile_count() == 0 and wd.bucket_count() == 0


def test_watchdog_env_strict(monkeypatch):
    import sys

    wmod = sys.modules["repro_torch.obs.watchdog"]
    monkeypatch.setattr(wmod, "_watchdog", None)
    monkeypatch.setenv("REPRO_OBS_STRICT", "1")
    assert wmod.watchdog().strict is True


def test_kernel_build_notes_its_family(monkeypatch, tmp_path):
    """A build notes ("kernel.build", (stem, digest)); a cached library is
    noted with 0 ms, and a sealed watchdog refuses an unknown one."""
    import hashlib

    from repro_torch.kernels.lp_score import lp_score

    src = lp_score.SOURCE
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(build.NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    (tmp_path / f"{src.stem}-{digest}.so").write_bytes(b"")
    wd = watchdog()
    wd.set_strict(True)
    assert build.build(src) == tmp_path / f"{src.stem}-{digest}.so"
    (rec,) = wd.records
    assert rec.kernel == "kernel.build" and rec.key == (src.stem, digest)
    assert rec.wall_ms == 0.0
    assert wd.snapshot()["kernels"]["kernel.build"]["buckets"] == 1
    wd.reset()
    wd.seal()
    with pytest.raises(WatchdogError, match="kernel.build"):
        build.build(src)


def _bucket_counts():
    return {f: d["buckets"] for f, d in watchdog().snapshot()["kernels"].items()}


def _ref_bucket_counts():
    return {f: d["buckets"]
            for f, d in ref_obs.watchdog().snapshot()["kernels"].items()}


def test_bucket_counts_match_reference_on_partition_and_session():
    """The same partition() and the same session stream (ba-2048, k = 4)
    note the same number of buckets per family in both packages.  Only
    kernel.build differs: it is the port's own family (nvcc builds, none on
    the CPU).  One V-cycle and engine levels down to 1024 nodes keep the
    reference's compiles few while every engine family still fires."""
    g = R.barabasi_albert(2048, 4, seed=5)
    kw = dict(k=4, preset="minimal", refine_engine="dense", dense_min_n=1024,
              numpy_below=1024, coarsest_factor=50, seed=0)
    rwd = ref_obs.watchdog()
    rwd.reset()
    ref_partition(g, RefPartitionerConfig(**kw))
    rs = RefSession(g, RefConfig(k=4, seed=0, repair_iters=2,
                                 partition_cfg=RefPartitionerConfig(**kw)))
    for upd in _stream(g.n, 1, 48, seed=3):
        rs.update(upd)
    want = _ref_bucket_counts()
    rwd.reset()

    watchdog().set_strict(True)
    gp = _port(g)
    partition(gp, PartitionerConfig(**kw), device=CPU)
    ps = PartitionSession(gp, SessionConfig(k=4, seed=0, repair_iters=2,
                                            partition_cfg=PartitionerConfig(**kw)),
                          device=CPU)
    for upd in _stream(g.n, 1, 48, seed=3):
        ps.update(_twin(upd))
    np.testing.assert_array_equal(ps.labels_np(), rs.labels_np())
    got = _bucket_counts()
    assert got.pop("kernel.build") == 0
    assert got == want
    assert sum(want.values()) > 10
    assert {"engine.sweep", "engine.dense", "engine.contract", "engine.evo",
            "engine.repair", "store.compact"} <= {f for f, b in got.items() if b}


# -------------------------------------------------------------- SLO export


def test_slo_export_equals_reference_byte_for_byte(tmp_path, monkeypatch):
    """Same stats dict, same registry contents, same watchdog snapshot:
    identical JSON snapshot, Prometheus text and files."""
    snap = dict(strict=False, sealed=False, total_compiles=3,
                unattributed_compiles=0, kernels={
                    "engine.sweep": dict(buckets=2, compiles=2, wall_ms=0.0),
                    "store.compact": dict(buckets=1, compiles=1, wall_ms=12.5)})

    class _Wd:
        def snapshot(self):
            return json.loads(json.dumps(snap))

    monkeypatch.setattr(port_export, "watchdog", lambda: _Wd())
    monkeypatch.setattr(ref_export, "watchdog", lambda: _Wd())
    stats = dict(updates_applied=4, view_hits=1, tx_committed=3,
                 tx_rollbacks=1, tx_quarantined=0, escalations=2,
                 dr_wal_records_since_checkpoint=5,
                 dr_last_restore_seconds=0.25, slo_budget_remaining=0.9,
                 mode="solo", **{"weird-key.x": 7})
    regs = []
    for mk in (MetricsRegistry, ref_obs.MetricsRegistry):
        r = mk("session")
        r.inc("escalations", 2)
        r.gauge("mem.base_csr_bytes", 4096)
        for v in (0.001, 0.02, 0.3, 2.27):
            r.observe("update_seconds", v)
        r.series_inc("span_ms", {"phase": "repair"}, 12.5)
        regs.append(r)
    assert obs.slo_snapshot(stats, [regs[0]]) == ref_obs.slo_snapshot(stats, [regs[1]])
    text = obs.to_prometheus(stats, [regs[0]])
    assert text == ref_obs.to_prometheus(stats, [regs[1]])
    assert "repro_updates_applied 4" in text and "_bucket{le=" in text
    a = obs.write_slo(str(tmp_path / "port"), stats, [regs[0]])
    b = ref_obs.write_slo(str(tmp_path / "ref"), stats, [regs[1]])
    for key in ("json", "prom"):
        assert open(a[key], "rb").read() == open(b[key], "rb").read()


# ------------------------------------------------------- accounting coverage


def _assert_within(est, peaks):
    total = sum(peaks.values())
    assert abs(est["total"] - total) <= FOOTPRINT_TOLERANCE * total
    held = 0
    for f in MEMORY_FAMILIES:
        meas = peaks[f]
        if max(meas, est[f]) < 0.01 * total:
            continue
        held += 1
        assert abs(est[f] - meas) <= FOOTPRINT_TOLERANCE * meas, (f, est[f], meas)
    assert held >= 2


def _live_storages():
    """{id: storage} of every live torch tensor's storage."""
    with warnings.catch_warnings():
        # isinstance() on a deprecated torch alias in gc's list warns
        warnings.simplefilter("ignore", FutureWarning)
        return {id(s): s for s in (o.untyped_storage() for o in gc.get_objects()
                                   if isinstance(o, torch.Tensor) and not o.is_meta)}


def test_family_totals_match_live_tensor_oracle():
    """The accounted total of a served ba-4096 stream lies within [0.85,
    1.001] of the storage bytes of the live tensors it created (the port's
    twin of the reference's jax.live_arrays() oracle), and the stream's
    family peaks lie within FOOTPRINT_TOLERANCE of the dynamic estimate."""
    g = R.barabasi_albert(4096, 6, seed=3)
    gp = _port(g)
    gc.collect()
    base = _live_storages()     # held, so no later storage reuses an id
    a = accountant()
    set_accounting(True)
    cfg = SessionConfig(k=4, seed=0)
    sess = PartitionSession(gp, cfg, device=CPU)
    a.reset_peaks()
    for upd in _stream(g.n, 4, 128, seed=11):
        sess.update(_twin(upd))
    gc.collect()
    oracle = sum(s.nbytes() for key, s in _live_storages().items() if key not in base)
    snap = a.snapshot()
    assert snap["total"] == sum(snap["by_family"].values())
    assert snap["total"] <= oracle * 1.001, (snap["total"], oracle)
    assert snap["total"] >= 0.85 * oracle, (snap["total"], oracle)
    _assert_within(estimate_footprint(g.n, g.m, 4, cfg, workload="dynamic"),
                   snap["peak_by_family"])
    del sess


# ------------------------------------------------------------ capacity planning


def test_estimate_footprint_within_tolerance_of_measured_peaks():
    """partition() on the smoke's configuration (dense refinement,
    coarsest_factor 100) over ba-8192 at k = 4: each family of 1 % or more
    of the measured total within FOOTPRINT_TOLERANCE of its peak (phase 9
    of chip_smoke.py holds the same on rmat(19, 16) at k = 16)."""
    g = _port(R.barabasi_albert(8192, 6, seed=3))
    a = accountant()
    set_accounting(True)
    cfg = PartitionerConfig(k=4, preset="fast", refine_engine="dense",
                            coarsest_factor=100, seed=0)
    partition(g, cfg, device=CPU)
    gc.collect()
    _assert_within(estimate_footprint(g.n, g.m, 4, cfg), a.snapshot()["peak_by_family"])
    with pytest.raises(ValueError):
        estimate_footprint(1000, 4000, 2, workload="nope")


def test_will_fit_budgets_and_cpu():
    res = will_fit(16384, 200_000, 4, budget_bytes=1 << 40)
    assert res["fits"] is True
    res = will_fit(16384, 200_000, 4, budget_bytes=1 << 10)
    assert res["fits"] is False
    assert res["required_bytes"] > res["estimate"]["total"]
    res = will_fit(16384, 200_000, 4, device=CPU)
    assert res["fits"] is None and res["budget_bytes"] is None
    res = LPEngine.will_fit(16384, 200_000, 4, budget_bytes=1 << 40, device=CPU)
    assert res["fits"] is True
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            will_fit(16384, 200_000, 4)


def test_engine_members():
    g = _port(R.barabasi_albert(512, 4, seed=1))
    eng = LPEngine(g, device=CPU)
    assert eng.jit_cache_size() is None and LPEngine.jit_cache_size() is None
    eng.cluster(g, U=50.0, iters=2, seed=0)
    eng.cluster(g, U=50.0, iters=2, seed=1)
    assert eng.compile_count == 1
    assert eng.stats.evo_bucket_count == 0
    assert "evo_bucket_count" in eng.stats_dict()


# ------------------------------------------------------------- static check


def test_every_site_is_registered_and_no_entry_is_stale():
    assert check_registration(SRC) == []
    assert stale_jit_sites(SRC) == []
    assert check_alloc_registration(SRC) == []
    assert stale_alloc_sites(SRC) == []
    for site, fam in obs.KNOWN_ALLOC_SITES.items():
        assert fam in MEMORY_FAMILIES or fam.startswith("exempt:"), site
    for site, fam in obs.KNOWN_JIT_SITES.items():
        assert fam in obs.KERNEL_FAMILIES or fam.startswith("exempt:"), site


def test_static_check_catches_a_new_site(tmp_path):
    """An unregistered torch.compile and an unaccounted upload fail."""
    pkg = tmp_path / "repro_torch"
    (pkg / "core").mkdir(parents=True)
    (pkg / "core" / "engine.py").write_text(
        "import torch\n"
        "def hot(x, dev):\n"
        "    return torch.compile(x)\n"
        "class E:\n"
        "    def up(self, a):\n"
        "        return a.to(self.device)\n"
        "    def cast(self, a):\n"
        "        return a.to(torch.int64)\n"
    )
    assert check_registration(str(pkg)) == ["core/engine.py::hot"]
    assert "core/engine.py::up" in check_alloc_registration(str(pkg))
    assert "core/engine.py::cast" not in check_alloc_registration(str(pkg))


def test_all_covers_reference():
    assert set(ref_obs.__all__) <= set(obs.__all__)
    for name in ref_obs.__all__:
        assert hasattr(obs, name), name
