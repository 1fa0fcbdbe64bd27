"""Port parity for the fault-tolerance subsystem: repro_torch.resilience
(snapshots, the invariant auditor, fault injection, transactional serving)
and repro_torch.deploy.replicate on the CPU against the reference on the
same seeded inputs and fault seeds.  Audit flags, the uint32 checksums (as
integers), TxResult sequences, failover decisions and host digests equal
the reference's exactly.  The parity twins of tests/test_resilience.py and
tests/test_replicate.py, plus the port's aliasing rule: snapshots and
standby replicas hold tensors that no fault or update writes into."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.deploy as RDe
import repro.resilience as RR
from repro.dynamic import GraphUpdate as RefUpdate
from repro.resilience.audit import _csr_audit as ref_csr_audit
from repro.resilience.audit import _shard_owned_chk as ref_shard_chk

import repro_torch.deploy as PDe
import repro_torch.resilience as PR
from repro_torch.dynamic import GraphUpdate, UpdateValidationError
from repro_torch.resilience.audit import _csr_audit, shard_checksum

from _torch_twins import (
    batch,
    digests_equal,
    session_pair,
    shards_equal,
    tx_view,
    twin,
)

torch.set_num_threads(1)


def _raw_checksums_equal(ref_sess, port_sess, ref_dep=None, port_dep=None):
    """The CSR flags, both arc checksums and every shard's owned-arc
    checksum equal the reference's as integers."""
    rg, pg = ref_sess.store.base, port_sess.store.base
    rf, rcf, rcr = ref_csr_audit(rg.indptr, rg.src, rg.indices, rg.ew, rg.nw,
                                 jnp.int32(rg.n), jnp.int32(rg.m))
    pf, pcf, pcr = _csr_audit(pg.indptr, pg.src, pg.indices, pg.ew, pg.nw,
                              pg.n, pg.m)
    assert np.asarray(rf).tolist() == pf.tolist()
    assert (int(np.uint32(rcf)), int(np.uint32(rcr))) == (int(pcf), int(pcr))
    if ref_dep is None:
        return
    for rs, ps in zip(ref_dep.shards, port_dep.shards):
        assert (rs is None) == (ps is None)
        if rs is not None:
            want = ref_shard_chk(rs.own_g, rs.ghost_g, rs.indptr, rs.indices,
                                 rs.ew, jnp.int32(rs.n_own), jnp.int32(rs.m_local))
            assert int(shard_checksum(ps)) == int(np.uint32(want))


def _report_view(rep):
    return (rep.step, rep.ok, rep.failures, rep.checked, rep.stored_cut,
            rep.recomputed_cut)


# ------------------------------------------------------------------- audit


@pytest.fixture(scope="module")
def deployed():
    """Reference and port sessions (pp-600, k=4) with a halo-1 deployment,
    one batch in."""
    ref_s, port_s = session_pair()
    ref_d, port_d = RDe.ShardDeployment(ref_s), PDe.ShardDeployment(port_s)
    upd = batch(ref_s.n, np.random.default_rng(4))
    ref_d.update(upd)
    port_d.update(twin(upd))
    return ref_s, port_s, ref_d, port_d


def _stage_overlay(store, ids, seed):
    u = np.random.default_rng(seed).integers(0, store.n, 16)
    store._ou.append(u.astype(ids))
    store._ov.append(((u + 1) % store.n).astype(ids))
    store._ow.append(np.ones(16, np.float32))
    store._olen += 16


_FAULTS = {
    "healthy": lambda inj, s, d, ids: None,
    "labels_in_range": lambda inj, s, d, ids: inj.corrupt_labels(s, count=3),
    "labels_out_of_range": lambda inj, s, d, ids: inj.corrupt_labels(
        s, count=2, out_of_range=True),
    "overlay_bitflip": lambda inj, s, d, ids: (
        _stage_overlay(s.store, ids, 9), inj.bitflip_overlay(s.store)),
    "base_weight": lambda inj, s, d, ids: inj.corrupt_base_csr(s.store, mode="weight"),
    "base_endpoint": lambda inj, s, d, ids: inj.corrupt_base_csr(
        s.store, mode="endpoint"),
    "corrupt_shard": lambda inj, s, d, ids: inj.corrupt_shard(d),
    "lose_shard": lambda inj, s, d, ids: inj.lose_shard(d),
}


@pytest.mark.parametrize("fault", list(_FAULTS))
def test_audit_and_checksums_match_reference(deployed, fault):
    """For healthy state and each injected corruption: the audit report
    (flags, failures, cuts) and every raw checksum equal the reference's;
    rollback (and shard recovery) restores the pre-fault digest."""
    ref_s, port_s, ref_d, port_d = deployed
    before = PR.host_digest(port_s)
    digests_equal(before, RR.host_digest(ref_s))
    mgr_r, mgr_p = RR.SnapshotManager(ref_s), PR.SnapshotManager(port_s)
    vr, vp = mgr_r.take(), mgr_p.take()
    rec = _FAULTS[fault](RR.FaultInjector(seed=5), ref_s, ref_d, np.int32)
    _FAULTS[fault](PR.FaultInjector(seed=5), port_s, port_d, np.int64)
    rep_r = RR.InvariantAuditor(ref_s, deployment=ref_d, cadence=1).audit()
    rep_p = PR.InvariantAuditor(port_s, deployment=port_d, cadence=1).audit()
    assert _report_view(rep_p) == _report_view(rep_r)
    assert rep_p.ok == (fault == "healthy")
    _raw_checksums_equal(ref_s, port_s, ref_d, port_d)
    mgr_r.rollback(vr)
    mgr_p.rollback(vp)
    if fault in ("corrupt_shard", "lose_shard"):
        b = int(rec.detail.split()[1])
        ref_d.recover_block(b)
        port_d.recover_block(b)
    digests_equal(PR.host_digest(port_s), before)
    st_r, st_p = ref_s.stats(), port_s.stats()
    assert st_p["audit_calls"] == st_r["audit_calls"]
    assert port_s.engine.stats.audit_buckets == ref_s.engine.stats.audit_buckets
    assert PR.InvariantAuditor(port_s, deployment=port_d, cadence=1).audit().ok
    RR.InvariantAuditor(ref_s, deployment=ref_d, cadence=1).audit()


@pytest.mark.parametrize("bad,reason", [
    (lambda: GraphUpdate(add_u=np.array([0]), add_v=np.array([10**9]),
                         add_w=np.array([1])), "endpoint_out_of_range"),
    (lambda: GraphUpdate(add_u=np.array([5]), add_v=np.array([5]),
                         add_w=np.array([1])), "self_loop"),
    (lambda: GraphUpdate(add_u=np.array([0]), add_v=np.array([1]),
                         add_w=np.array([0.5])), "non_integral_weight"),
])
def test_rejection_is_fully_atomic(deployed, bad, reason):
    _, port_s, _, _ = deployed
    before = PR.host_digest(port_s)
    traj = len(port_s.trajectory)
    with pytest.raises(UpdateValidationError) as ei:
        port_s.update(bad())
    assert ei.value.reason == reason
    digests_equal(PR.host_digest(port_s), before)
    assert len(port_s.trajectory) == traj


def test_audit_cadence_gating():
    _, port_s = session_pair(n=200, k=2)
    aud = PR.InvariantAuditor(port_s, cadence=3)
    ran = [aud.maybe_audit(step) for step in range(1, 10)]
    assert [r is not None for r in ran] == [s % 3 == 0 for s in range(1, 10)]
    with pytest.raises(ValueError):
        PR.InvariantAuditor(port_s, cadence=0)


# --------------------------------------------------------------- snapshots


def test_snapshot_rollback_and_replay_match_reference():
    """Rollback restores the host digest bit for bit; replaying the same
    stream from the restored version reproduces the labels and trajectory,
    equal to the reference's."""
    ref_s, port_s = session_pair()
    rng = np.random.default_rng(2)
    first = batch(port_s.n, rng)
    ref_s.update(first)
    port_s.update(twin(first))
    oracle = PR.host_digest(port_s)
    mgr = PR.SnapshotManager(port_s)
    v = mgr.take()
    stream = [batch(port_s.n, np.random.default_rng(100 + i)) for i in range(3)]
    for b in stream:
        port_s.update(twin(b))
        ref_s.update(b)
    digests_equal(PR.host_digest(port_s), RR.host_digest(ref_s))
    labels = port_s.labels_np()
    traj = [(r.step, r.cut, r.feasible) for r in port_s.trajectory]
    mgr.rollback(v)
    digests_equal(PR.host_digest(port_s), oracle)
    for b in stream:
        port_s.update(twin(b))
    np.testing.assert_array_equal(port_s.labels_np(), labels)
    assert [(r.step, r.cut, r.feasible) for r in port_s.trajectory] == traj


def test_snapshot_ring_retention_and_fork():
    _, port_s = session_pair(n=200, k=2)
    mgr = PR.SnapshotManager(port_s, keep=3)
    versions = [mgr.take() for _ in range(5)]
    assert mgr.versions == versions[-3:]
    with pytest.raises(KeyError):
        mgr.get(versions[0])
    mgr.rollback(versions[-2])
    assert mgr.versions == versions[-3:-1]


def test_snapshots_and_standbys_are_not_aliased_by_faults_or_updates():
    """The aliasing rule: a snapshot and the standby replicas hold tensors
    that corrupt_labels, corrupt_shard, corrupt_replica and later updates
    never write into — clones taken before the faults still equal them,
    and rollback restores the clean state."""
    _, port_s = session_pair()
    dep = PDe.ReplicatedDeployment(port_s, replicas=2)
    mgr = PR.SnapshotManager(port_s)
    v = mgr.take()
    snap = mgr.get(v).state
    base = snap["store"]["base"]
    held = {
        "labels": snap["labels"], "indices": base.indices, "ew": base.ew,
        "indptr": base.indptr, "nw": base.nw,
        "shard_ew": dep.shards[0].ew, "shard_indices": dep.shards[0].indices,
        "standby_ew": dep._standbys[1][0].ew,
    }
    clones = {k_: t.clone() for k_, t in held.items()}
    digest = PR.host_digest(port_s)
    inj = PR.FaultInjector(seed=3)
    inj.corrupt_labels(port_s, count=4)
    inj.corrupt_shard(dep, block=0)
    inj.corrupt_replica(dep, block=1)
    inj.corrupt_base_csr(port_s.store, mode="weight")
    assert not torch.equal(port_s.labels, clones["labels"])
    assert not torch.equal(dep.shards[0].ew, clones["shard_ew"])
    rng = np.random.default_rng(8)
    for _ in range(2):
        upd = twin(batch(port_s.n, rng))
        dep.migrate(upd, port_s.update(upd))
    for k_, t in held.items():
        assert torch.equal(t, clones[k_]), k_
    mgr.rollback(v)
    digests_equal(PR.host_digest(port_s), digest)
    assert torch.equal(port_s.labels, clones["labels"])


# --------------------------------------------------- transactional serving


def _run_stream(ref_rs, port_rs, stream, before=None):
    """Submit one stream to both wrappers; TxResults and digests equal
    after every submit."""
    for i, (seq, upd) in enumerate(stream):
        if before is not None:
            before(i)
        tr = ref_rs.submit(upd, seq=seq)
        tp = port_rs.submit(twin(upd), seq=seq)
        assert tx_view(tp) == tx_view(tr), i
        digests_equal(PR.host_digest(port_rs.session),
                      RR.host_digest(ref_rs.session))


def _stats_equal(ref_rs, port_rs):
    a, b = ref_rs.stats(), port_rs.stats()
    for key in ("tx_committed", "tx_rollbacks", "tx_retries", "tx_quarantined",
                "tx_duplicates_dropped", "tx_parked", "tx_lost", "degraded",
                "snapshots_taken", "snapshot_versions", "audits",
                "failed_audits", "escalations", "suppressed_escalations"):
        assert b[key] == a[key], key


def test_mangled_stream_tx_results_match_reference():
    """Duplicates dropped, swaps parked and drained, drops declared lost,
    garbage quarantined — the same TxResults as the reference."""
    ref_s, port_s = session_pair()
    cfg = dict(reorder_window=2)
    ref_rs = RR.ResilientSession(ref_s, cfg=RR.ResilientConfig(**cfg))
    port_rs = PR.ResilientSession(port_s, cfg=PR.ResilientConfig(**cfg))
    batches = [batch(port_s.n, np.random.default_rng(200 + i)) for i in range(8)]
    batches[4] = RefUpdate(add_u=np.array([1]), add_v=np.array([1]),
                           add_w=np.array([1]))
    inj_r, inj_p = RR.FaultInjector(seed=11), PR.FaultInjector(seed=11)
    stream = inj_r.mangle_stream(batches, drop=0.2, dup=0.2, swap=0.3)
    stream_p = inj_p.mangle_stream(batches, drop=0.2, dup=0.2, swap=0.3)
    assert [s for s, _ in stream] == [s for s, _ in stream_p]
    assert [(f.kind, f.detail) for f in inj_p.log] == [
        (f.kind, f.detail) for f in inj_r.log]
    assert {"drop_batch", "duplicate_batch", "reorder_batches"} <= {
        f.kind for f in inj_p.log}
    _run_stream(ref_rs, port_rs, stream)
    _stats_equal(ref_rs, port_rs)
    assert [(q.seq, q.reason) for q in port_rs.quarantine] == [
        (q.seq, q.reason) for q in ref_rs.quarantine] == [(4, "self_loop")]


def test_midflight_corruption_rollback_retry_matches_reference():
    ref_s, port_s = session_pair()
    ref_rs = RR.ResilientSession(ref_s, cfg=RR.ResilientConfig(audit_cadence=1))
    port_rs = PR.ResilientSession(port_s, cfg=PR.ResilientConfig(audit_cadence=1))
    rng = np.random.default_rng(9)
    stream = list(enumerate(batch(port_s.n, rng) for _ in range(3)))
    injs = [RR.FaultInjector(seed=7), PR.FaultInjector(seed=7)]
    for sess, inj in zip((ref_s, port_s), injs):
        real = sess.update
        calls = {"n": 0}

        def corrupting(upd, real=real, sess=sess, inj=inj, calls=calls):
            res = real(upd)
            if calls["n"] == 1:     # the second submit's first attempt
                inj.corrupt_labels(sess, count=2, out_of_range=True)
            calls["n"] += 1
            return res

        sess.update = corrupting
    _run_stream(ref_rs, port_rs, stream)
    assert port_rs.rollbacks == 1 and port_rs.results[1].retries == 1
    _stats_equal(ref_rs, port_rs)


def test_watchdog_degraded_mode_and_escalation_crash_match_reference():
    """Consecutive escalations past the bound enter degraded mode (stale
    steps), recover() exits it; an escalation crash rolls back and the
    degraded retry commits — TxResults equal the reference's."""
    ref_s, port_s = session_pair(escalate_cut_ratio=1.0001)
    cfg = dict(max_consecutive_escalations=2, max_retries=2)
    ref_rs = RR.ResilientSession(ref_s, cfg=RR.ResilientConfig(**cfg))
    port_rs = PR.ResilientSession(port_s, cfg=PR.ResilientConfig(**cfg))
    rng = np.random.default_rng(12)
    stream = [(i, batch(port_s.n, rng, size=120)) for i in range(4)]
    _run_stream(ref_rs, port_rs, stream)
    assert port_rs.degraded and port_s.suppress_escalation
    assert any(t.result.stale for t in port_rs.results if t.result)
    assert _report_view(port_rs.recover()) == _report_view(ref_rs.recover())
    assert not port_rs.degraded
    RR.FaultInjector(seed=12).fail_next_escalation(ref_s)
    PR.FaultInjector(seed=12).fail_next_escalation(port_s)
    _run_stream(ref_rs, port_rs, [(4, batch(port_s.n, rng, size=120))])
    tx = port_rs.results[-1]
    assert tx.committed and tx.rolled_back and tx.retries == 1
    assert tx.result.stale and not tx.result.escalated and port_rs.degraded
    _stats_equal(ref_rs, port_rs)


def test_fault_suite_with_deployment_and_heal_matches_reference():
    """A failed migration serves stale shards and catches up; then each
    state fault is detected, healed (rollback + shard resync or recovery)
    and the stack keeps committing — every step equal to the reference."""
    ref_s, port_s = session_pair()
    ref_d, port_d = RDe.ShardDeployment(ref_s), PDe.ShardDeployment(port_s)
    ref_rs = RR.ResilientSession(ref_s, deployment=ref_d,
                                 cfg=RR.ResilientConfig(audit_cadence=1))
    port_rs = PR.ResilientSession(port_s, deployment=port_d,
                                  cfg=PR.ResilientConfig(audit_cadence=1))
    inj_r, inj_p = RR.FaultInjector(seed=99), PR.FaultInjector(seed=99)
    rng = np.random.default_rng(15)
    seq = iter(range(100))

    def submit():
        _run_stream(ref_rs, port_rs, [(next(seq), batch(port_s.n, rng))])

    inj_r.fail_next_extract(ref_d)
    inj_p.fail_next_extract(port_d)
    submit()
    assert port_d.stale and port_rs.results[-1].migration_failed
    submit()
    assert not port_d.stale
    for name, kw in (("corrupt_labels", dict(count=2)),
                     ("corrupt_labels", dict(count=2, out_of_range=True)),
                     ("corrupt_base_csr", dict(mode="weight")),
                     ("corrupt_shard", {}), ("lose_shard", {})):
        outs = []
        for inj, s, d in ((inj_r, ref_s, ref_d), (inj_p, port_s, port_d)):
            target = d if name in ("corrupt_shard", "lose_shard") else (
                s.store if name == "corrupt_base_csr" else s)
            outs.append(getattr(inj, name)(target, **kw))
        assert outs[1].detail == outs[0].detail
        rep_r, rep_p = ref_rs.auditor.audit(), port_rs.auditor.audit()
        assert _report_view(rep_p) == _report_view(rep_r) and not rep_p.ok
        if name in ("corrupt_shard", "lose_shard"):
            b = int(outs[1].detail.split()[1])
            ref_d.recover_block(b)
            port_d.recover_block(b)
        else:
            assert _report_view(port_rs.heal()) == _report_view(ref_rs.heal())
        digests_equal(PR.host_digest(port_s), RR.host_digest(ref_s))
        assert port_rs.auditor.audit().ok and ref_rs.auditor.audit().ok
        submit()
    _stats_equal(ref_rs, port_rs)


# ------------------------------------------------------------------ replicas


def _replicated_pair(replicas):
    ref_s, port_s = session_pair(n=400, k=3)
    return (ref_s, port_s, RDe.ReplicatedDeployment(ref_s, replicas=replicas),
            PDe.ReplicatedDeployment(port_s, replicas=replicas))


def _replica_state(dep):
    return (dep.failovers, dep.failover_misses, sorted(dep.recovery_pending),
            [len(s) for s in dep._standbys], dep.replica_refreshes, dep.reads,
            list(dep._expected_chk))


def _serves_everywhere(port_s, dep):
    labels = port_s.labels_np()
    for b in range(dep.k):
        s = dep.read_block(b)
        assert s is not None and dep.verify_shard(b, s)
        own = s.host().own_global
        assert own.size and np.all(labels[own] == b)


@pytest.mark.parametrize("fault", ["corrupt", "lose", "rotten_standby", "miss"])
def test_replica_failover_matches_reference(fault):
    """A corrupt or lost primary fails over to an audited standby; a
    rotten standby is skipped; with every copy bad the read recovers
    synchronously (a miss) — decisions, counters, expected checksums and
    the served shards equal the reference's."""
    replicas = 2 if fault == "miss" else 3
    ref_s, port_s, ref_d, port_d = _replicated_pair(replicas)
    assert _replica_state(port_d) == _replica_state(ref_d)
    for inj, d in ((RR.FaultInjector(1), ref_d), (PR.FaultInjector(1), port_d)):
        if fault == "lose":
            inj.lose_shard(d, block=0)
        else:
            inj.corrupt_shard(d, block=0)
        if fault in ("rotten_standby", "miss"):
            assert inj.corrupt_replica(d, block=0) is not None
    s_r, s_p = ref_d.read_block(0), port_d.read_block(0)
    assert port_d.verify_shard(0, s_p)
    assert _replica_state(port_d) == _replica_state(ref_d)
    assert port_d.failover_misses == int(fault == "miss")
    shards_equal(port_d.shards, ref_d.shards)
    assert port_d.run_recovery() == ref_d.run_recovery()
    assert _replica_state(port_d) == _replica_state(ref_d)
    _serves_everywhere(port_s, port_d)
    assert PR.InvariantAuditor(port_s, deployment=port_d).audit().ok
    st = port_d.stats()
    assert st["replicas"] == replicas and st["failovers"] == ref_d.failovers


def test_replicated_deployment_rides_transactions_like_reference():
    ref_s, port_s, ref_d, port_d = _replicated_pair(2)
    ref_rs = RR.ResilientSession(ref_s, deployment=ref_d,
                                 cfg=RR.ResilientConfig(audit_cadence=2))
    port_rs = PR.ResilientSession(port_s, deployment=port_d,
                                  cfg=PR.ResilientConfig(audit_cadence=2))
    rng = np.random.default_rng(3)

    def corrupt_at(i):
        if i == 3:
            RR.FaultInjector(4).corrupt_shard(ref_d, block=0)
            PR.FaultInjector(4).corrupt_shard(port_d, block=0)
            ref_d.read_block(0)
            port_d.read_block(0)
            ref_d.run_recovery()
            port_d.run_recovery()

    _run_stream(ref_rs, port_rs,
                [(i, batch(port_s.n, rng, size=20)) for i in range(5)],
                before=corrupt_at)
    assert port_d.failovers == ref_d.failovers >= 1
    assert _replica_state(port_d) == _replica_state(ref_d)
    assert port_rs.auditor.audit().ok
    _serves_everywhere(port_s, port_d)
