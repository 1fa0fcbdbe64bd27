"""Port parity for the dynamic subsystem's throughput mode: overlay-view
repair, deferred compaction, node tombstones, SessionGroup lanes and
snapshot/restore — repro_torch.dynamic on the CPU against repro.dynamic
and against the port's own always-compact and solo paths.  The parity
twins of the non-WAL tests of tests/test_throughput.py, plus the aliasing
rule: no serving code writes into a tensor a snapshot holds."""

import functools

import numpy as np
import pytest
import torch

import repro.graph as R
from repro.core import PartitionerConfig as RefPartitionerConfig
from repro.dynamic import GraphUpdate as RefUpdate
from repro.dynamic import PartitionSession as RefSession
from repro.dynamic import SessionConfig as RefConfig
from repro.dynamic import SessionGroup as RefGroup

from repro_torch.core import PartitionerConfig
from repro_torch.dynamic import (
    DynamicGraphStore,
    GraphUpdate,
    PartitionSession,
    SessionConfig,
    SessionGroup,
    UpdateValidationError,
)
from repro_torch.dynamic.repair import (
    balance_rounds_device,
    expand_region_device,
    gain_round_device,
)
from repro_torch.graph import barabasi_albert, from_reference, gather_pack_device, validate

torch.set_num_threads(1)

CPU = "cpu"
_FIELDS = ("add_u", "add_v", "add_w", "rem_u", "rem_v", "rem_w", "add_node_w")
_RESULT = ("step", "n", "m", "cut", "imbalance", "feasible", "region_size",
           "escalated", "noop", "used_view", "compact_deferred")


def _port(g):
    return from_reference(g.indptr, g.indices, g.ew, g.nw)


# Sessions here start (and escalate) with the host GA in both packages: the
# reference's device GA would compile for every new coarsest shape, and the
# GA is not what this file tests (tests/test_torch_dynamic.py runs sessions
# with the default config).
def _ref_cfg(k=4, **kw):
    pcfg = RefPartitionerConfig(k=k, preset="fast", evo_engine="host")
    return RefConfig(k=k, partition_cfg=pcfg, **kw)


def _cfg(k=4, **kw):
    pcfg = PartitionerConfig(k=k, preset="fast", evo_engine="host")
    return SessionConfig(k=k, partition_cfg=pcfg, **kw)


def _twin(upd):
    return GraphUpdate(**{f: getattr(upd, f) for f in _FIELDS})


def _mixed_stream(n, steps, nb, seed):
    """Per-step reference updates: adds + removals of earlier adds."""
    rng = np.random.default_rng(seed)
    added, out = [], []
    for s in range(steps):
        au = rng.integers(0, n, nb)
        av = (au + 1 + rng.integers(0, n - 1, nb)) % n
        upd = RefUpdate.add_edges(au, av)
        if added and s % 2 == 1:
            pu, pv = added.pop(0)
            h = max(pu.size // 2, 1)
            upd = upd.merged(RefUpdate.remove_edges(pu[:h], pv[:h]))
        added.append((au, av))
        out.append(upd)
    return out


def _run_port(g, stream, **kw):
    sess = PartitionSession(_port(g), _cfg(seed=0, repair_iters=2, **kw), device=CPU)
    labs = []
    for upd in stream:
        sess.update(_twin(upd))
        labs.append(sess.labels_np())
    return sess, labs


@functools.lru_cache(maxsize=None)
def _ref_run(nb, fraction, defer):
    """The reference session on the view-parity stream: per-step labels and
    trajectory fields (cached: several cases share the always-compact run)."""
    g = R.barabasi_albert(256, 4, seed=1)
    sess = RefSession(g, _ref_cfg(seed=0, repair_iters=2, compact_fraction=fraction,
                                  defer_compaction=defer))
    out = []
    for upd in _mixed_stream(g.n, 8, nb, seed=5):
        r = sess.update(upd)
        out.append((sess.labels_np(), tuple(getattr(r, f) for f in _RESULT)))
    return out, sess.stats()["view_calls"]


# ------------------------------------------------------- overlay-view repair


@pytest.mark.parametrize(
    "nb,fraction,defer",
    [
        (8, 0.5, False),      # small batches, threshold never crossed
        (16, 0.04, False),    # boundary: some steps view, some compact
        (48, 0.02, False),    # threshold crossed every step (always compact)
        (48, 0.02, True),     # threshold crossed, compaction deferred
    ],
)
def test_view_repair_matches_always_compact_and_reference(nb, fraction, defer):
    """View-path labels == always-compact labels == the reference's at every
    step; the always-compact run matches the reference's trajectory, and in
    the boundary case (some steps view, some compact) so does the view run,
    flags included."""
    g = R.barabasi_albert(256, 4, seed=1)
    stream = _mixed_stream(g.n, 8, nb, seed=5)
    sess_c, labs_c = _run_port(g, stream, compact_fraction=0.0)
    sess_v, labs_v = _run_port(g, stream, compact_fraction=fraction,
                               defer_compaction=defer)
    ref_c, _ = _ref_run(nb, 0.0, False)
    for s, (a, b, (want, traj)) in enumerate(zip(labs_c, labs_v, ref_c)):
        np.testing.assert_array_equal(a, want, err_msg=f"step {s}")
        np.testing.assert_array_equal(b, want, err_msg=f"step {s}")
        got = tuple(getattr(sess_c.trajectory[s + 1], f) for f in _RESULT)
        assert got == traj, s
    st_v, st_c = sess_v.stats(), sess_c.stats()
    if st_v["view_calls"] == 0:
        assert not defer and not any(r.used_view for r in sess_v.trajectory)
    else:
        assert any(r.used_view for r in sess_v.trajectory)
        if defer:
            assert st_v["compact_deferred"] > 0
        else:
            assert st_v["compact_calls"] < st_c["compact_calls"]
    for rc, rv in zip(sess_c.trajectory, sess_v.trajectory):
        assert rc.cut == rv.cut and rc.m == rv.m
    if nb == 16:
        ref_v, ref_views = _ref_run(nb, fraction, defer)
        assert st_v["view_calls"] == ref_views
        for s, (want, traj) in enumerate(ref_v):
            assert tuple(getattr(sess_v.trajectory[s + 1], f) for f in _RESULT) == traj


def test_view_on_node_add_falls_back_to_compact():
    g = barabasi_albert(256, 4, seed=3)
    sess = PartitionSession(
        g, SessionConfig(k=4, seed=0, repair_iters=2, compact_fraction=0.5), device=CPU
    )
    res = sess.update(GraphUpdate.add_nodes(np.ones(3, np.float32)).merged(
        GraphUpdate.add_edges([0, 1], [256, 257])))
    assert not res.used_view and sess.store.n == 259
    res2 = sess.add_edges([5, 6], [7, 8])
    assert res2.used_view and sess.view_hits == 1
    assert sess.stats()["view_bucket_count"] == 1


# ------------------------------------------------------ deferred compaction


def test_deferred_compaction_counters_and_landing():
    g = barabasi_albert(256, 4, seed=4)
    st_sync = DynamicGraphStore(g, device=CPU)
    st_defer = DynamicGraphStore(g, device=CPU)
    rng = np.random.default_rng(2)
    u = rng.integers(0, g.n, 40)
    v = (u + 1 + rng.integers(0, g.n - 1, 40)) % g.n
    for s in (st_sync, st_defer):
        s.add_edges(u, v)
    g_sync = st_sync.compact()
    st_defer.compact(deferred=True)
    assert st_defer.compact_pending and st_defer.stats.compact_deferred == 1
    assert st_defer.overlay_len == 80          # consumed only at the swap
    g_defer = st_defer.graph()
    assert not st_defer.compact_pending and st_defer.overlay_len == 0
    for name in ("indptr", "indices", "ew", "src", "nw"):
        assert torch.equal(getattr(g_sync, name), getattr(g_defer, name)), name


def test_deferred_compaction_snapshot_restore_replay():
    """A snapshot taken while a deferred merge is pending restores to a
    state whose replay reproduces the same labels."""
    g = barabasi_albert(256, 4, seed=5)
    stream = _mixed_stream(g.n, 6, 48, seed=7)
    sess = PartitionSession(g, SessionConfig(
        k=4, seed=0, repair_iters=2, compact_fraction=0.02, defer_compaction=True,
    ), device=CPU)
    snap, labs_after = None, []
    for s, upd in enumerate(stream):
        sess.update(_twin(upd))
        if s == 2:
            assert sess.store.compact_pending
            snap = sess.snapshot_state()
        if s > 2:
            labs_after.append(sess.labels_np())
    sess.restore_state(snap)
    for s, upd in enumerate(stream[3:]):
        sess.update(_twin(upd))
        np.testing.assert_array_equal(sess.labels_np(), labs_after[s], err_msg=f"{s}")


def test_snapshot_restore_is_not_aliased_by_later_updates():
    """The aliasing rule: after ``snapshot_state()``, an update that adds
    nodes (labels rebuilt), wiring edges, and updates whose repair the guard
    rejects (labels handed back unchanged) must not alter anything the
    snapshot holds — a restore gives back exactly the captured labels and
    store tensors, and replaying the stream gives the same labels again."""
    g = barabasi_albert(256, 4, seed=11)
    sess = PartitionSession(g, SessionConfig(k=4, seed=0, repair_iters=2), device=CPU)
    rng = np.random.default_rng(3)
    u = rng.integers(0, 256, 12)
    sess.add_edges(u, (u + 1 + rng.integers(0, 255, 12)) % 256)
    snap = sess.snapshot_state()
    base = snap["store"]["base"]
    held = {name: getattr(base, name).clone()
            for name in ("indptr", "indices", "ew", "nw", "src")}
    lab0 = snap["labels"].clone()
    nw0 = snap["store"]["nw"].copy()
    stream = [GraphUpdate.add_nodes(np.full(5, 2, np.int64))]
    stream.append(GraphUpdate.add_edges(np.arange(256, 261), np.arange(5)))
    for _ in range(3):
        u = rng.integers(0, 261, 15)
        stream.append(GraphUpdate.add_edges(u, (u + 1 + rng.integers(0, 260, 15)) % 261))
    rejected = 0
    labs = []
    for upd in stream:
        before = sess.labels
        res = sess.update(upd)
        rejected += int(sess.labels is before and not res.noop)
        labs.append(sess.labels_np())
    assert rejected > 0 and sess.n == 261
    sess.restore_state(snap)
    assert torch.equal(sess.labels, lab0) and sess.labels is snap["labels"]
    for name, t in held.items():
        assert torch.equal(getattr(sess.store.base, name), t), name
    np.testing.assert_array_equal(sess.store.node_weights(), nw0)
    assert sess.n == 256
    for s, upd in enumerate(stream):
        sess.update(upd)
        np.testing.assert_array_equal(sess.labels_np(), labs[s], err_msg=f"{s}")


# ------------------------------------------------------------ node tombstones


def test_store_tombstone_vacuum_roundtrip_oracle():
    g = barabasi_albert(200, 3, seed=6)
    st = DynamicGraphStore(g, device=CPU)
    gh = st.csr_host()
    victims = [10, 77]
    uu, vv = [], []
    for x in victims:
        for y in gh.indices[gh.indptr[x]:gh.indptr[x + 1]]:
            uu.append(min(x, y))
            vv.append(max(x, y))
    uu, vv = np.asarray(uu), np.asarray(vv)
    src = gh.arc_sources()
    w = np.array([gh.ew[np.flatnonzero((src == a) & (gh.indices == b))[0]]
                  for a, b in zip(uu, vv)])
    st.remove_edges(uu, vv, w)
    st.remove_nodes(victims)
    assert st.pending_removals == 2
    mapping = st.vacuum()
    assert st.n == g.n - 2 and np.all(mapping[victims] == -1)
    keep = np.setdiff1d(np.arange(g.n), victims)
    np.testing.assert_array_equal(mapping[keep], np.arange(g.n - 2))
    g2 = st.csr_host()
    validate(g2)
    gi = DynamicGraphStore(g, device=CPU)
    gi.remove_edges(uu, vv, w)
    gm = gi.csr_host()
    old_src, old_dst = gm.arc_sources(), gm.indices
    alive = ~np.isin(old_src, victims) & ~np.isin(old_dst, victims)
    ns, nd = mapping[old_src[alive]], mapping[old_dst[alive]]
    order = np.lexsort((nd, ns))
    np.testing.assert_array_equal(g2.arc_sources(), ns[order])
    np.testing.assert_array_equal(g2.indices, nd[order])
    np.testing.assert_array_equal(g2.ew, gm.ew[alive][order])
    np.testing.assert_array_equal(g2.nw, gm.nw[keep])
    assert st.stats.vacuum_bucket_count == 1


def test_store_remove_nonisolated_node_rejected():
    g = barabasi_albert(128, 3, seed=7)
    st = DynamicGraphStore(g, device=CPU)
    with pytest.raises(UpdateValidationError, match="node_not_isolated"):
        st.remove_nodes([5])
    assert st.pending_removals == 0


def test_session_rejects_bad_batch_atomically():
    g = barabasi_albert(128, 3, seed=60)
    sess = PartitionSession(g, SessionConfig(k=4, seed=0, repair_iters=2), device=CPU)
    lab, step, base = sess.labels, sess._step, sess.store.base
    with pytest.raises(UpdateValidationError):
        sess.update(GraphUpdate.add_nodes([1]).merged(GraphUpdate.add_edges([5], [10_000])))
    assert sess.labels is lab and sess._step == step and sess.store.base is base
    assert sess.n == 128 and sess.store.overlay_len == 0 and len(sess.trajectory) == 1


# ---------------------------------------------------------------- lane axis


def test_repair_programs_with_a_lane_axis_equal_solo_calls():
    """expand / gather / gain / balance on (B, ...) lanes of different
    graphs (one shape bucket) equal their solo calls lane by lane."""
    gs = [barabasi_albert(n, 4, seed=s) for n, s in ((250, 1), (240, 2), (256, 3))]
    B, A, k, Kb = len(gs), 512, 3, 4
    M = max(g.m for g in gs)
    rng = np.random.default_rng(9)

    def pad(a, L, fill=0):
        return np.concatenate([a, np.full(L - a.size, fill, a.dtype)])

    src = torch.from_numpy(np.stack([pad(g.arc_sources().astype(np.int64), M) for g in gs]))
    dst = torch.from_numpy(np.stack([pad(g.indices.astype(np.int64), M) for g in gs]))
    ew = torch.from_numpy(np.stack([pad(g.ew, M) for g in gs]))
    ip = torch.from_numpy(np.stack([pad(g.indptr, A + 1, g.m) for g in gs]))
    nw = torch.from_numpy(np.stack([pad(g.nw, A) for g in gs]))
    lab = torch.from_numpy(np.stack([pad(rng.integers(0, k, g.n).astype(np.int32), A, k)
                                     for g in gs]))
    ns = [g.n for g in gs]
    touched = torch.from_numpy(np.stack([pad(rng.integers(0, n, 5), 8, n) for n in ns]))
    caps, Ls = [64, 0x7FFFFFFF, 12], [90.0, 85.5, 91.0]
    masks = expand_region_device(touched, src, dst, ip, ns, 2, caps, A=A)
    gain = gain_round_device(src, dst, ew, nw, lab, masks, ns, k, Ls, [1, 2, 3],
                             [4, 5, 6], Kb=Kb)
    bal = balance_rounds_device(nw, gain, masks, ns, k, Ls, [7, 8, 9], Kb=Kb, rounds=3)
    nodes = torch.from_numpy(np.stack([pad(rng.permutation(n)[:64], 72, n)
                                       for n in ns]).reshape(B, 3, 24))
    nv = nodes < torch.tensor(ns)[:, None, None]
    packs = gather_pack_device(nodes, nv, ip, dst, ew, torch.tensor(ns), E=1024)
    for b in range(B):
        m1 = expand_region_device(touched[b], src[b], dst[b], ip[b], ns[b], 2, caps[b], A=A)
        assert torch.equal(masks[b], m1)
        g1 = gain_round_device(src[b], dst[b], ew[b], nw[b], lab[b], m1, ns[b], k, Ls[b],
                               b + 1, b + 4, Kb=Kb)
        assert torch.equal(gain[b], g1)
        assert torch.equal(bal[b], balance_rounds_device(
            nw[b], g1, m1, ns[b], k, Ls[b], b + 7, Kb=Kb, rounds=3))
        for got, want in zip(packs, gather_pack_device(nodes[b], nv[b], ip[b], dst[b],
                                                       ew[b], ns[b], E=1024)):
            assert torch.equal(got[b], want)
    assert bool((gain != lab).any()) and bool((bal != gain).any())


# ------------------------------------------------------------- session group


def _group_pair(specs):
    """Reference and port tenants, built from the same seeded graphs."""
    ref, port = {}, {}
    for name, (n, k, gseed, extra) in specs.items():
        gi = R.barabasi_albert(n, 4, seed=gseed)
        ref[name] = RefSession(gi, _ref_cfg(k=k, repair_iters=2, **extra))
        port[name] = PartitionSession(_port(gi), _cfg(k=k, repair_iters=2, **extra),
                                      device=CPU)
    return ref, port


def _check_tenants(names, ref, port, solo, step):
    for name in names:
        want = ref[name].labels_np()
        np.testing.assert_array_equal(port[name].labels_np(), want,
                                      err_msg=f"step {step} tenant {name}")
        np.testing.assert_array_equal(solo[name].labels_np(), want)
        a, b = ref[name].trajectory[-1], port[name].trajectory[-1]
        for f in ("step", "n", "m", "cut", "imbalance", "feasible", "region_size",
                  "escalated", "noop"):
            assert getattr(b, f) == getattr(a, f), (step, name, f)


def test_session_group_matches_reference_group_and_solo():
    """Port group lanes == the reference's group lanes == the port's solo
    sessions, with a heterogeneous fleet (one tenant at k = 3), a no-op
    lane and a coalesced tenant; the group's bucket keys are the
    reference's."""
    specs = {f"t{i}": (n, k, 30 + i, dict(seed=i))
             for i, (n, k) in enumerate([(256, 4), (256, 4), (320, 3)])}
    ref, port = _group_pair(specs)
    solo = {n: PartitionSession(port[n].store.csr_host(),
                                _cfg(k=port[n].k, repair_iters=2, **specs[n][3]),
                                device=CPU)
            for n in port}
    rg, pg = RefGroup(ref), SessionGroup(port)
    rng = np.random.default_rng(44)
    for step in range(3):
        batch = []
        for name, sess in port.items():
            n = sess.store.n
            if step == 1 and name == "t1":
                batch.append((name, RefUpdate()))
                continue
            u = rng.integers(0, n, 7)
            v = (u + 1 + rng.integers(0, n - 1, 7)) % n
            if step == 2:
                batch.append((name, RefUpdate.add_edges(u[:3], v[:3])))
                batch.append((name, RefUpdate.add_edges(u[3:], v[3:])))
            else:
                batch.append((name, RefUpdate.add_edges(u, v)))
        rg.update_many(batch)
        pg.update_many([(n, _twin(u)) for n, u in batch])
        for name in port:
            merged = GraphUpdate()
            for n2, upd in batch:
                if n2 == name:
                    merged = merged.merged(_twin(upd))
            solo[name].update(merged)
        _check_tenants(port, ref, port, solo, step)
    sd, rd = pg.stats_dict(), rg.stats_dict()
    for key in ("lanes_repaired", "noops", "coalesced", "solo_fallbacks",
                "group_bucket_count"):
        assert sd[key] == rd[key], key
    assert pg.stats.group_buckets == rg.stats.group_buckets
    assert sd["noops"] == 1 and sd["coalesced"] == 3


def test_session_group_fallback_and_escalation_parity():
    """A node-adding lane falls back to the solo path; a tenant with a low
    cut ratio escalates inside the group exactly when the reference's
    does."""
    specs = {"a": (256, 4, 30, dict(seed=0, escalate_cut_ratio=0.5)),
             "b": (256, 4, 30, dict(seed=1))}
    ref, port = _group_pair(specs)
    solo = {n: PartitionSession(port[n].store.csr_host(),
                                _cfg(k=port[n].k, repair_iters=2, **specs[n][3]),
                                device=CPU)
            for n in port}
    rg, pg = RefGroup(ref), SessionGroup(port)
    rng = np.random.default_rng(55)
    for step in range(3):
        batch = []
        for name in ("a", "b"):
            n = port[name].store.n
            u = rng.integers(0, n, 6)
            upd = RefUpdate.add_edges(u, (u + 1 + rng.integers(0, n - 1, 6)) % n)
            if step == 1 and name == "b":
                upd = upd.merged(RefUpdate.add_nodes(np.ones(2, np.float32)))
            batch.append((name, upd))
        rg.update_many(batch)
        pg.update_many([(n, _twin(u)) for n, u in batch])
        for name, upd in batch:
            solo[name].update(_twin(upd))
        _check_tenants(("a", "b"), ref, port, solo, step)
    assert port["a"].escalations == ref["a"].escalations > 0
    assert pg.stats.solo_fallbacks == 1 == rg.stats.solo_fallbacks


def test_session_group_rejects_unknown_tenant_and_bad_batch_atomically():
    g = barabasi_albert(128, 3, seed=60)
    sess = PartitionSession(g, SessionConfig(k=4, seed=0, repair_iters=2), device=CPU)
    group = SessionGroup({"a": sess})
    with pytest.raises(KeyError):
        group.update_many([("ghost", GraphUpdate.add_edges([0], [1]))])
    lab0, step0 = sess.labels, sess._step
    with pytest.raises(UpdateValidationError):
        group.update_many([
            ("a", GraphUpdate.add_edges([0], [1])),
            ("a", GraphUpdate.add_edges([5], [10_000])),
        ])
    assert sess.labels is lab0 and sess._step == step0
    with pytest.raises(ValueError):
        SessionGroup({})
