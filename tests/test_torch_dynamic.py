"""Port parity for the dynamic subsystem: repro_torch.dynamic (store, repair
rounds, LPEngine.repair, PartitionSession) on the CPU against
repro.dynamic on the same seeded inputs.  Labels are bit-identical; cuts,
block weights, region sizes and CSR arrays are equal exactly (every weight
is integral).  The parity twins of tests/test_dynamic.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.graph as R
from repro.core import LPEngine as RefEngine
from repro.core.metrics import lmax
from repro.dynamic import DynamicGraphStore as RefStore
from repro.dynamic import GraphUpdate as RefUpdate
from repro.dynamic import PartitionSession as RefSession
from repro.dynamic import SessionConfig as RefConfig
from repro.dynamic.repair import (
    balance_rounds_device as ref_balance,
    expand_region_device as ref_expand,
    gain_round_device as ref_gain,
)

from repro_torch.core import LPEngine
from repro_torch.core.fm import gain_round_np
from repro_torch.dynamic import (
    DynamicGraphStore,
    GraphUpdate,
    PartitionSession,
    SessionConfig,
    UpdateValidationError,
)
from repro_torch.dynamic.repair import (
    balance_rounds_device,
    expand_region_device,
    gain_round_device,
)
from repro_torch.graph import from_reference, validate

torch.set_num_threads(1)

CPU = "cpu"
_FIELDS = ("add_u", "add_v", "add_w", "rem_u", "rem_v", "rem_w", "add_node_w")


def _port(g):
    return from_reference(g.indptr, g.indices, g.ew, g.nw)


def _twin(upd):
    """The port's GraphUpdate with the reference update's arrays."""
    return GraphUpdate(**{f: getattr(upd, f) for f in _FIELDS})


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype=dtype)


def _assert_csr_equal(a, b):
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.ew, b.ew)
    np.testing.assert_array_equal(a.nw, np.asarray(b.nw, np.float32))


def _random_edges(rng, n, nb):
    u = rng.integers(0, n, nb)
    return u, (u + 1 + rng.integers(0, n - 1, nb)) % n


# --------------------------------------------------------------------- store


def test_store_inverse_batches_round_trip_to_original_csr():
    g = R.barabasi_albert(1024, 4, seed=2)
    st = DynamicGraphStore(_port(g), device=CPU)
    rng = np.random.default_rng(0)
    u, v = _random_edges(rng, g.n, 64)
    w = rng.integers(1, 5, 64)
    st.add_edges(u, v, w)
    assert st.dirty and st.overlay_len == 2 * 64
    st.remove_edges(u, v, w)
    assert st.overlay_len == 4 * 64
    g2 = st.csr_host()
    assert not st.dirty
    _assert_csr_equal(g2, g)
    validate(g2)


@pytest.mark.parametrize("case", ["mesh", "ring-lexsort"])
def test_store_adds_and_removals_give_reference_csr(case):
    """Adds of new edges, removals of existing ones and over-removals give
    the reference's merged CSR.  ``ring-lexsort``: 40,000 nodes, a node
    bucket where the reference's merge takes its two-pass lexsort; the
    port's one int64 key gives the same order."""
    if case == "mesh":
        g = R.mesh2d(16)
        d_u = np.arange(0, 64, dtype=np.int64)
        d_v = d_u + 2
        e_u = np.arange(100, 110, dtype=np.int64)
    else:
        g = R.ring(40000)
        rng = np.random.default_rng(3)
        d_u, d_v = _random_edges(rng, g.n, 300)
        e_u = rng.integers(0, g.n - 1, 50)
    e_v = e_u + 1
    ref, port = RefStore(g), DynamicGraphStore(_port(g), device=CPU)
    for st, U in ((ref, RefUpdate), (port, GraphUpdate)):
        st.apply(U.add_edges(d_u, d_v))
        st.apply(U.remove_edges(e_u, e_v, np.full(e_u.size, 2)))   # over-removal drops
    got, want = port.csr_host(), ref.csr_host()
    _assert_csr_equal(got, want)
    validate(got)
    assert port.stats.compact_buckets == ref.stats.compact_buckets


def test_store_add_nodes_then_wire_them_in_one_batch():
    g = R.barabasi_albert(500, 3, seed=1)
    upd = RefUpdate.add_nodes([2, 3]).merged(
        RefUpdate.add_edges([500, 501, 500], [0, 7, 501])
    )
    ref, port = RefStore(g), DynamicGraphStore(_port(g), device=CPU)
    ref.apply(upd)
    port.apply(_twin(upd))
    g2 = port.csr_host()
    validate(g2)
    assert port.n == 502 and g2.n == 502 and g2.m == g.m + 6
    _assert_csr_equal(g2, ref.csr_host())
    assert port.total_node_weight == ref.total_node_weight


def test_store_rejected_batch_leaves_store_untouched():
    g = R.mesh2d(8)
    st = DynamicGraphStore(_port(g), device=CPU)
    bad = GraphUpdate.add_nodes([1]).merged(GraphUpdate.add_edges([0], [10**6]))
    with pytest.raises(UpdateValidationError, match="endpoint_out_of_range"):
        st.apply(bad)
    assert st.n == g.n and st.overlay_len == 0
    assert st.total_node_weight == float(g.nw.sum())
    with pytest.raises(UpdateValidationError, match="self_loop"):
        st.apply(GraphUpdate.add_edges([3], [3]))
    with pytest.raises(ValueError, match="integral"):
        GraphUpdate.add_edges([0], [1], [0.5])


def test_store_overlay_cap_triggers_auto_compaction():
    g = R.mesh2d(8)
    st = DynamicGraphStore(_port(g), overlay_cap=16, device=CPU)
    u = np.arange(0, 10, dtype=np.int64)
    st.add_edges(u, u + 16)   # 20 overlay arcs > cap
    assert st.stats.compact_calls == 1 and not st.dirty
    ref = RefStore(g, overlay_cap=16)
    ref.add_edges(u, u + 16)
    _assert_csr_equal(st.csr_host(), ref.csr_host())


def test_graph_update_wire_format_and_net_arcs_match_reference():
    rng = np.random.default_rng(4)
    upd = RefUpdate.add_edges(*_random_edges(rng, 100, 12), rng.integers(1, 9, 12)).merged(
        RefUpdate.remove_edges([1, 2, 3], [4, 5, 6])).merged(RefUpdate.add_nodes([1, 2]))
    upd = upd.merged(RefUpdate.remove_edges(upd.add_u[:4], upd.add_v[:4], upd.add_w[:4]))
    mine = _twin(upd)
    data = upd.to_bytes()
    assert mine.to_bytes() == data
    back = GraphUpdate.from_bytes(data)
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(back, f), getattr(upd, f))
    for a, b in zip(mine.net_arcs(102), upd.net_arcs(102)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(UpdateValidationError, match="wal_corrupt"):
        GraphUpdate.from_bytes(data[:-1] + bytes([data[-1] ^ 1]))


# ------------------------------------------------------------- repair rounds


def test_expand_region_matches_reference_capped_and_uncapped():
    """The hub-bounded frontier: an ordinary node next to a hub, 3 hops —
    uncapped it engulfs most of the graph, capped it stays local; both
    masks equal the reference's."""
    g = R.rmat(12, 8, seed=5)
    deg = g.degrees()
    cap = max(64, int(8 * g.m / g.n))
    hub = int(np.argmax(deg))
    nb_hub = g.indices[g.indptr[hub]:g.indptr[hub + 1]]
    spoke = int(nb_hub[np.argmin(deg[nb_hub])])
    A = 1 << (g.n + 1).bit_length()
    src, dst = g.arc_sources(), g.indices
    tpad = np.full(8, g.n)
    tpad[0] = spoke
    sizes = []
    for c in (0x7FFFFFFF, cap):
        want = np.asarray(ref_expand(
            jnp.asarray(tpad, jnp.int32), jnp.asarray(src), jnp.asarray(dst),
            jnp.asarray(g.indptr, jnp.int32), jnp.int32(g.n), jnp.int32(3),
            jnp.int32(c), A=A))
        got = expand_region_device(
            _t(tpad, torch.int64), _t(src, torch.int64), _t(dst, torch.int64),
            _t(g.indptr, torch.int64), g.n, 3, c, A=A).numpy()
        np.testing.assert_array_equal(got, want)
        sizes.append(int(got.sum()))
    assert sizes[0] > 0.5 * g.n and sizes[1] < 0.1 * sizes[0]


def _round_inputs(seed=0):
    g = R.planted_partition(300, 4, p_in=0.06, p_out=0.01, seed=2)
    k, Ab = 3, 512
    rng = np.random.default_rng(seed)
    lab = np.full(Ab, k, np.int32)
    lab[: g.n] = rng.integers(0, k, g.n)
    nw = np.zeros(Ab, np.float32)
    nw[: g.n] = g.nw
    region = np.zeros(Ab, bool)
    region[rng.integers(0, g.n, 80)] = True
    return g, k, Ab, lab, nw, region


def test_gain_round_matches_reference_and_fm_spec():
    g, k, Ab, lab, nw, region = _round_inputs()
    src, dst = g.arc_sources(), g.indices
    L = lmax(g.n, k, 0.03)
    want = np.asarray(ref_gain(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(g.ew), jnp.asarray(nw),
        jnp.asarray(lab), jnp.asarray(region), jnp.int32(g.n), jnp.int32(k),
        jnp.float32(L), jnp.uint32(0x1234), jnp.uint32(0x5678), Kb=k + 1))
    spec = gain_round_np(src, dst, g.ew, nw, lab, g.n, k, k + 1, np.float32(L),
                         0x1234, 0x5678, region=region, influx_gate=True)
    lab_t = _t(lab)
    got = gain_round_device(
        _t(src, torch.int64), _t(dst, torch.int64), _t(g.ew), _t(nw), lab_t,
        _t(region), g.n, k, L, 0x1234, 0x5678, Kb=k + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), spec)
    assert np.any(want != lab)
    np.testing.assert_array_equal(lab_t.numpy(), lab)      # input not written


def test_balance_rounds_match_reference():
    """An overloaded labelling (most region nodes in block 0) sheds into the
    lightest block exactly as the reference's rounds do."""
    g, k, Ab, lab, nw, region = _round_inputs(seed=1)
    lab[: g.n // 2] = 0
    region[: g.n] |= np.arange(g.n) % 3 == 0
    L = lmax(g.n, k, 0.03)
    want = np.asarray(ref_balance(
        jnp.asarray(nw), jnp.asarray(lab), jnp.asarray(region), jnp.int32(g.n),
        jnp.int32(k), jnp.float32(L), jnp.int32(77), Kb=k + 1, rounds=3))
    got = balance_rounds_device(_t(nw), _t(lab), _t(region), g.n, k, L, 77,
                                Kb=k + 1, rounds=3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.any(want != lab)


# ------------------------------------------------------------ LPEngine.repair


def _check_repair(got, want, lab_in, n):
    out_g, rs_g, cut_g, bw_g = got
    out_w, rs_w, cut_w, bw_w = want
    np.testing.assert_array_equal(out_g.numpy(), np.asarray(out_w))
    assert rs_g == rs_w and cut_g == cut_w
    np.testing.assert_array_equal(bw_g, np.asarray(bw_w))
    return out_g.numpy()[:n]


def test_engine_repair_matches_reference_and_stays_in_region():
    g = R.mesh2d(32)
    k = 2
    L = lmax(g.n, k, 0.03)
    rng = np.random.default_rng(0)
    noisy = (np.arange(g.n) // (g.n // k)).clip(0, k - 1).astype(np.int32)
    noisy[rng.random(g.n) < 0.2] ^= 1
    touched = np.array([100, 505], dtype=np.int64)
    kw = dict(hops=2, iters=4, seed=3)
    ref, eng = RefEngine(g, seed=0), LPEngine(_port(g), seed=0, device=CPU)
    out = _check_repair(eng.repair(_port(g), noisy, touched, k, L, **kw),
                        ref.repair(g, noisy, touched, k, L, **kw), noisy, g.n)
    # region oracle: BFS of 2 hops around the touched nodes
    mask = np.zeros(g.n, bool)
    mask[touched] = True
    for _ in range(2):
        nxt = mask.copy()
        for v in np.flatnonzero(mask):
            nxt[g.indices[g.indptr[v]:g.indptr[v + 1]]] = True
        mask = nxt
    np.testing.assert_array_equal(out[~mask], noisy[~mask])
    assert eng.stats.repair_calls == 1
    assert eng.stats.repair_buckets == ref.stats.repair_buckets


def test_engine_repair_on_store_view_matches_reference():
    """``adjacency=`` repairs on the base + overlay view of a store: the
    same four results as the reference on its view, and as the port on the
    compacted graph."""
    g = R.barabasi_albert(512, 4, seed=9)
    k = 4
    L = lmax(g.n, k, 0.03)
    rng = np.random.default_rng(2)
    lab = rng.integers(0, k, g.n).astype(np.int32)
    u, v = _random_edges(rng, g.n, 20)
    src = g.arc_sources()
    pick = rng.integers(0, g.m, 10)
    upd = RefUpdate.add_edges(u, v).merged(
        RefUpdate.remove_edges(src[pick], g.indices[pick]))
    ref_st, st = RefStore(g), DynamicGraphStore(_port(g), device=CPU)
    ref_st.apply(upd)
    st.apply(_twin(upd))
    assert st.can_view() and ref_st.can_view()
    touched = np.concatenate([u, v, src[pick], g.indices[pick]])
    kw = dict(hops=2, iters=2, seed=5, hop_degree_cap=64)
    ref, eng = RefEngine(g, seed=0), LPEngine(_port(g), seed=0, device=CPU)
    got = eng.repair(st.base, lab, touched, k, L, adjacency=st.view()[:4], **kw)
    _check_repair(got, ref.repair(ref_st.base, lab, touched, k, L,
                                  adjacency=ref_st.view()[:4], **kw), lab, g.n)
    compacted = eng.repair(st.graph(), lab, touched, k, L, **kw)
    np.testing.assert_array_equal(compacted[0].numpy(), got[0].numpy())
    assert compacted[1:3] == got[1:3]


# ------------------------------------------------------------------- session


def _sessions(g, **kw):
    return (RefSession(g, RefConfig(seed=0, **kw)),
            PartitionSession(_port(g), SessionConfig(seed=0, **kw), device=CPU))


def _step(ref, port, upd):
    a = ref.update(upd)
    b = port.update(_twin(upd))
    _same(ref, port, a, b)
    return b


def _same(ref, port, a, b):
    np.testing.assert_array_equal(port.labels_np(), ref.labels_np())
    for f in ("step", "n", "m", "cut", "imbalance", "feasible", "region_size",
              "escalated", "noop", "used_view", "compact_deferred"):
        assert getattr(b, f) == getattr(a, f), f


def test_session_mixed_stream_matches_reference():
    """Adds, removals, a net no-op, node adds wired in later and over-
    removal: labels, cut, imbalance, region size and escalation equal the
    reference's at every step, and so do the bucket sets."""
    g = R.barabasi_albert(1024, 4, seed=1)
    ref, port = _sessions(g, k=4)
    _same(ref, port, ref.trajectory[0], port.trajectory[0])
    rng = np.random.default_rng(7)
    src = g.arc_sources()
    for step in range(5):
        u, v = _random_edges(rng, ref.n, 40)
        pick = rng.integers(0, g.m, 40)
        upd = RefUpdate.add_edges(u, v).merged(
            RefUpdate.remove_edges(src[pick], g.indices[pick]))
        if step == 1:
            upd = upd.merged(RefUpdate.remove_edges(u, v))      # cancels the adds
        if step == 2:
            upd = RefUpdate.add_nodes(np.ones(6, np.int64))
        if step == 3:
            upd = upd.merged(RefUpdate.add_edges(np.arange(1024, 1030), np.arange(6)))
        res = _step(ref, port, upd)
        assert res.feasible
    res = _step(ref, port, RefUpdate.add_edges([3], [600]).merged(
        RefUpdate.remove_edges([3], [600])))
    assert res.noop
    a, b = ref.stats(), port.stats()
    for key in ("repair_calls", "repair_bucket_count", "compact_calls",
                "compact_bucket_count", "escalations", "updates_applied"):
        assert b[key] == a[key], key
    assert port.engine.stats.repair_buckets == ref.engine.stats.repair_buckets


def test_session_noop_batch_keeps_labels_tensor():
    g = R.planted_partition(1500, 8, p_in=0.03, p_out=0.002, seed=1)
    sess = PartitionSession(_port(g), SessionConfig(k=2, seed=0), device=CPU)
    lab0 = sess.labels_np()
    dev0 = sess.labels
    assert sess.update(GraphUpdate()).noop
    u, v = np.array([3, 10, 77]), np.array([500, 900, 1200])
    res = sess.update(GraphUpdate.add_edges(u, v, [2, 1, 3]).merged(
        GraphUpdate.remove_edges(u, v, [2, 1, 3])))
    assert res.noop
    assert sess.labels is dev0
    np.testing.assert_array_equal(sess.labels_np(), lab0)
    assert sess.engine.stats.repair_calls == 0
    assert not sess.store.dirty and sess.store.stats.compact_calls == 0


# one community graph for the node-set and escalation cases, so the
# reference compiles its programs once for all of them
def _community():
    return R.planted_partition(1000, 8, p_in=0.05, p_out=0.001, seed=6)


def test_session_add_nodes_keeps_balance():
    g = _community()
    ref, port = _sessions(g, k=2)
    res = _step(ref, port, RefUpdate.add_nodes(np.ones(20, np.int64)))
    assert res.feasible and np.all(port.labels_np()[g.n:] < 2)
    assert port.engine_rebuilds == 0
    u = np.arange(g.n, g.n + 20, dtype=np.int64)
    res = _step(ref, port, RefUpdate.add_edges(u, np.arange(0, 20, dtype=np.int64)))
    assert res.feasible and port.n == g.n + 20


def test_session_node_growth_past_arena_rebuilds_engine():
    g = _community()
    ref, port = _sessions(g, k=2)
    assert port.engine.A == 1024
    lab_before = port.labels_np()
    _step(ref, port, RefUpdate.add_nodes(np.ones(40, np.int64)))
    assert port.engine_rebuilds == 1 and port.engine.A >= 2048
    np.testing.assert_array_equal(port.labels_np()[:1000], lab_before)
    res = _step(ref, port, RefUpdate.add_edges(np.arange(1000, 1040), np.arange(40)))
    assert res.feasible and res.region_size > 0
    assert port.stats()["repair_calls"] == 2


def test_session_escalates_exactly_when_reference_does():
    g = _community()
    ref, port = _sessions(g, k=2, escalate_cut_ratio=1.05, hops=1)
    rng = np.random.default_rng(5)
    small = RefUpdate.add_edges(*_random_edges(rng, g.n, 3))
    assert not _step(ref, port, small).escalated
    res = _step(ref, port, RefUpdate.add_edges(*_random_edges(rng, g.n, 600)))
    assert res.escalated and port.escalations == 1 and res.feasible


def test_session_remove_nodes_matches_reference():
    g = _community()
    ref, port = _sessions(g, k=2)
    gh = ref.store.csr_host()
    victim = 42
    nbrs = gh.indices[gh.indptr[victim]:gh.indptr[victim + 1]]
    w = gh.ew[gh.indptr[victim]:gh.indptr[victim + 1]]
    _step(ref, port, RefUpdate.remove_edges(np.minimum(victim, nbrs),
                                            np.maximum(victim, nbrs), w))
    a, b = ref.remove_nodes([victim]), port.remove_nodes([victim])
    _same(ref, port, a, b)
    assert port.n == g.n - 1 and port.store.stats.nodes_removed == 1
    np.testing.assert_array_equal(port.store.last_vacuum_map, ref.store.last_vacuum_map)
    _assert_csr_equal(port.store.csr_host(), ref.store.csr_host())
    _step(ref, port, RefUpdate.add_edges([1, 2, 3], [50, 60, 70]))


def test_dynamic_entry_points_need_cuda_unless_told_otherwise():
    """Store and session default to CUDA and raise without it; a group
    refuses sessions on different devices."""
    import copy

    from repro_torch.dynamic import SessionGroup

    g = _port(R.mesh2d(8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DynamicGraphStore(g)
        with pytest.raises(RuntimeError, match="CUDA"):
            PartitionSession(g, SessionConfig(k=2))
    sess = PartitionSession(g, SessionConfig(k=2), device=CPU)
    assert sess.device.type == "cpu" and sess.store.base.indptr.device.type == "cpu"
    other = copy.copy(sess)
    other.device = torch.device("meta")
    with pytest.raises(ValueError, match="devices"):
        SessionGroup({"a": sess, "b": other})
    assert SessionGroup({"a": sess}).device == sess.device
