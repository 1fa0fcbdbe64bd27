"""Port parity for checkpointing and disaster recovery: repro_torch.ckpt and
repro_torch.resilience.durable on the CPU against repro.ckpt and
repro.resilience.durable.  The WAL files are byte-identical to the
reference's for the same stream, checkpoint arrays and metadata equal, a
restore lands on the reference's host digest — also from a directory the
reference wrote.  The parity twins of tests/test_durable.py and of
tests/test_ckpt.py (without the elastic reshard, which is not ported)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro.ckpt as RC
import repro.deploy as RDe
import repro.resilience as RR
from repro.dynamic import GraphUpdate as RefUpdate

import repro_torch.ckpt as PC
import repro_torch.deploy as PDe
import repro_torch.resilience as PR
from repro_torch.dynamic import PartitionSession, SessionConfig
from repro_torch.resilience.durable import wal_path

from _torch_twins import (
    CPU,
    batch,
    digests_equal,
    port_graph,
    pp_graph,
    session_pair,
    shards_equal,
    tx_view,
    twin,
)

torch.set_num_threads(1)


# ------------------------------------------------------------------ ckpt


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((8, 16)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal(32) * scale).astype(np.float32),
                  "d": np.arange(5, dtype=np.int32)},
            "e": [np.int64(7), np.zeros((2, 3), np.float64)]}


def _leaves_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_ckpt_format_matches_reference(tmp_path):
    """The same tree saved by both packages gives the same arrays (in the
    reference's sorted-key flatten order) and the same manifest; each
    package loads the other's directory."""
    t = _tree(0)
    RC.save(str(tmp_path / "ref"), 7, t, {"step": 7})
    PC.save(str(tmp_path / "port"), 7, t, {"step": 7})
    ref_leaves, ref_m = RC.load(str(tmp_path / "ref"), 7)
    port_leaves, port_m = PC.load(str(tmp_path / "port"), 7)
    _leaves_equal(port_leaves, ref_leaves)
    assert port_m == ref_m
    _leaves_equal(PC.load(str(tmp_path / "ref"), 7)[0], ref_leaves)
    _leaves_equal(RC.load(str(tmp_path / "port"), 7)[0], ref_leaves)


def test_ckpt_restore_into_template(tmp_path):
    """restore() rebuilds the template's structure: tensor leaves as tensors
    of its dtype, numpy leaves as arrays; wrong leaf counts or shapes
    raise."""
    t = _tree(1)
    like = {"a": torch.zeros(8, 16), "b": {"c": torch.zeros(32),
                                          "d": np.zeros(5, np.int32)},
            "e": [np.int64(0), np.ones((2, 3))]}
    PC.save(str(tmp_path), 3, t, {"step": 3})
    out, extra = PC.restore(str(tmp_path), 3, like)
    assert extra == {"step": 3}
    assert list(out) == ["a", "b", "e"] and isinstance(out["a"], torch.Tensor)
    assert isinstance(out["b"]["d"], np.ndarray) and isinstance(out["e"], list)
    _leaves_equal([out["a"], out["b"]["c"], out["b"]["d"], *out["e"]],
                  [t["a"], t["b"]["c"], t["b"]["d"], *t["e"]])
    with pytest.raises(ValueError, match="leaves"):
        PC.restore(str(tmp_path), 3, {"a": like["a"]})
    bad = dict(like, a=torch.zeros(4, 4))
    with pytest.raises(ValueError, match="shape"):
        PC.restore(str(tmp_path), 3, bad)


def test_ckpt_latest_step_ignores_torn_writes(tmp_path):
    t = _tree(0)
    PC.save(str(tmp_path), 3, t)
    PC.save(str(tmp_path), 9, t)
    os.makedirs(tmp_path / "step_00000011.tmp")
    os.makedirs(tmp_path / "step_00000012")
    with open(tmp_path / "step_00000012" / "manifest.json", "w") as f:
        json.dump({"step": 12, "complete": False}, f)
    assert PC.latest_step(str(tmp_path)) == RC.latest_step(str(tmp_path)) == 9
    assert PC.latest_step(str(tmp_path / "missing")) is None


def test_ckpt_load_rejects_incomplete_and_mismatched(tmp_path):
    PC.save(str(tmp_path), 1, _tree(3))
    mf = tmp_path / "step_00000001" / "manifest.json"
    m = json.loads(mf.read_text())
    m["complete"] = False
    mf.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="incomplete"):
        PC.load(str(tmp_path), 1)
    m["complete"] = True
    m["shapes"][0] = [1, 1]
    mf.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="mismatch"):
        PC.load(str(tmp_path), 1)


def test_ckpt_async_checkpointer_keeps_the_newest(tmp_path):
    ck = PC.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = {"w": torch.arange(6, dtype=torch.float32), "s": np.arange(3)}
    for s in (1, 2, 3):
        ck.submit(s, tree, {"step": s})
    ck.wait()
    assert PC.latest_step(str(tmp_path)) == 3
    assert len([d for d in os.listdir(tmp_path) if d.startswith("step_")]) == 2
    _leaves_equal(PC.load(str(tmp_path), 3)[0], [np.arange(3), np.arange(6.0, dtype=np.float32)])


@pytest.mark.parametrize("surface", ["wait", "submit"])
def test_ckpt_async_failure_surfaces_once(tmp_path, monkeypatch, surface):
    """A failed background write is re-raised on the next wait() or
    submit(), counted once, and the checkpointer stays usable."""
    import repro_torch.ckpt.checkpoint as mod

    real, calls = mod.save, {"n": 0}

    def flaky(path, step, tree, extra=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("disk full (injected)")
        return real(path, step, tree, extra)

    monkeypatch.setattr(mod, "save", flaky)
    ck = PC.AsyncCheckpointer(str(tmp_path), keep=2)
    ck.submit(1, _tree(4))
    with pytest.raises(OSError, match="disk full"):
        ck.wait() if surface == "wait" else ck.submit(2, _tree(4))
    assert ck.failed_writes == 1
    ck.submit(3, _tree(4))
    ck.wait()
    assert ck.failed_writes == 1
    assert PC.latest_step(str(tmp_path)) == 3


# ------------------------------------------------------------------ DR stack


def _stacks(tmp_path, n=400, k=3, checkpoint_every=4, replicated=True,
            audit_cadence=4):
    """The same durable stack in both packages, directories ``ref`` and
    ``port`` under ``tmp_path``."""
    ref_s, port_s = session_pair(n=n, k=k)
    out = []
    for tag, s, De, R in (("ref", ref_s, RDe, RR), ("port", port_s, PDe, PR)):
        dep = De.ReplicatedDeployment(s, replicas=2) if replicated else None
        rs = R.ResilientSession(s, deployment=dep,
                                cfg=R.ResilientConfig(audit_cadence=audit_cadence))
        out.append(R.DurableSession(rs, R.DurableConfig(
            directory=str(tmp_path / tag), checkpoint_every=checkpoint_every)))
    return out


def _submit_both(ref, port, upd, seq=None):
    tr, tp = ref.submit(upd, seq=seq), port.submit(twin(upd), seq=seq)
    assert tx_view(tp) == tx_view(tr)
    return tp


_TIMING = ("seconds", "t_mono", "span_ms", "h2d_bytes", "d2h_bytes")


def _extra_view(extra):
    """Checkpoint metadata without the wall-clock and transfer-count fields
    of the trajectory (the port counts int64 index uploads)."""
    extra = dict(extra)
    extra["trajectory"] = [{k: v for k, v in r.items() if k not in _TIMING}
                           for r in extra["trajectory"]]
    return extra


def test_wal_bytes_and_checkpoints_match_reference(tmp_path):
    """For the same stream the WAL files are byte-identical and every
    checkpoint's arrays (values and dtypes) and metadata equal the
    reference's; rotation and pruning keep the same files."""
    ref, port = _stacks(tmp_path, checkpoint_every=3)
    rng = np.random.default_rng(0)
    for i in range(10):
        _submit_both(ref, port, batch(port.session.n, rng, size=20), seq=i)
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    assert sorted(os.listdir(d_port)) == sorted(os.listdir(d_ref))
    wals = [f for f in os.listdir(d_port) if f.startswith("wal_")]
    assert wals
    for f in wals:
        with open(os.path.join(d_port, f), "rb") as a, \
                open(os.path.join(d_ref, f), "rb") as b:
            assert a.read() == b.read(), f
    steps = sorted(int(f.split("_")[1]) for f in os.listdir(d_port)
                   if f.startswith("step_"))
    assert len(steps) == port.cfg.keep_checkpoints
    for s in steps:
        pl, pm = PC.load(d_port, s)
        rl, rm = RC.load(d_ref, s)
        _leaves_equal(pl, rl)
        assert _extra_view(pm["extra"]) == _extra_view(rm["extra"])
        assert (pm["shapes"], pm["dtypes"]) == (rm["shapes"], rm["dtypes"])


def test_restore_after_kill_matches_reference(tmp_path):
    """Fresh-process restore: newest checkpoint + WAL replay lands on the
    live digest, which equals the reference's restore; sequence state and
    the replicated deployment come back; the stream continues."""
    ref, port = _stacks(tmp_path, checkpoint_every=3)
    rng = np.random.default_rng(0)
    for i in range(8):
        assert _submit_both(ref, port, batch(port.session.n, rng, size=20), seq=i).committed
    pre = PR.host_digest(port.session)
    port2, rep = PR.DurableSession.restore(str(tmp_path / "port"), device=CPU)
    ref2, rep_r = RR.DurableSession.restore(str(tmp_path / "ref"))
    assert rep.records_replayed == rep_r.records_replayed >= 1
    assert rep.checkpoint_step == rep_r.checkpoint_step
    assert rep.wal_tail_error is None and rep.wal_bytes_dropped == 0
    digests_equal(PR.host_digest(port2.session), pre)
    digests_equal(PR.host_digest(port2.session), RR.host_digest(ref2.session))
    assert port2.rs._expected_seq == ref2.rs._expected_seq == 8
    assert isinstance(port2.rs.deployment, PDe.ReplicatedDeployment)
    shards_equal(port2.rs.deployment.shards, ref2.rs.deployment.shards)
    assert port2.rs.auditor.audit().ok
    _submit_both(ref2, port2, batch(port.session.n, rng, size=20), seq=8)
    digests_equal(PR.host_digest(port2.session), RR.host_digest(ref2.session))


def test_restore_of_a_directory_the_reference_wrote(tmp_path):
    """Cross-package disaster recovery: a directory written by the
    reference's DurableSession restores in the port (device="cpu") to the
    reference's live digest, and the port keeps extending its WAL with
    records the reference reads back."""
    ref, _ = _stacks(tmp_path, checkpoint_every=3)
    rng = np.random.default_rng(1)
    for i in range(5):
        assert ref.submit(batch(ref.session.n, rng, size=20), seq=i).committed
    live = RR.host_digest(ref.session)
    port2, rep = PR.DurableSession.restore(str(tmp_path / "ref"), device=CPU)
    assert rep.records_replayed == 2
    digests_equal(PR.host_digest(port2.session), live)
    upd = batch(ref.session.n, rng, size=20)
    assert port2.submit(twin(upd), seq=5).committed
    ref2, _ = RR.DurableSession.restore(str(tmp_path / "ref"))
    digests_equal(RR.host_digest(ref2.session), PR.host_digest(port2.session))


def test_restore_replays_degraded_flags_and_without_deployment(tmp_path):
    ref, port = _stacks(tmp_path, checkpoint_every=100, audit_cadence=100,
                        replicated=False)
    rng = np.random.default_rng(1)
    _submit_both(ref, port, batch(port.session.n, rng, size=20))
    for ds in (ref, port):
        ds.session.suppress_escalation = True
        ds.rs.degraded = True
    _submit_both(ref, port, batch(port.session.n, rng, size=60))
    recs, _, err = PR.read_wal(wal_path(str(tmp_path / "port"), port.anchor_step))
    assert err is None and [r.suppress for r in recs] == [False, True]
    port2, _ = PR.DurableSession.restore(str(tmp_path / "port"), device=CPU)
    digests_equal(PR.host_digest(port2.session), PR.host_digest(port.session))
    assert port2.session.suppress_escalation and port2.rs.degraded
    assert port2.rs.deployment is None


def test_mid_checkpoint_crash_and_hook_discipline(tmp_path):
    """A kill inside the checkpoint window leaves the previous checkpoint +
    the still-extending WAL restorable; the hook patches the port's
    ckpt.save once, never stacks, and disarm() removes an unfired one."""
    _, port = _stacks(tmp_path, checkpoint_every=100, replicated=False)
    rng = np.random.default_rng(3)
    for _ in range(3):
        port.submit(twin(batch(port.session.n, rng, size=20)))
    anchor = port.anchor_step
    inj = PR.FaultInjector(0)
    assert inj.fail_mid_checkpoint(port) is not None
    assert inj.fail_mid_checkpoint(port) is None        # no stacking
    assert port.checkpoint() is None and port.failed_checkpoints == 1
    d = str(tmp_path / "port")
    assert PC.latest_step(d) == anchor
    assert any(f.endswith(".tmp") for f in os.listdir(d))
    port2, rep = PR.DurableSession.restore(d, device=CPU)
    assert rep.checkpoint_step == anchor and rep.records_replayed == 3
    digests_equal(PR.host_digest(port2.session), PR.host_digest(port.session))
    assert port.checkpoint() is not None and port._commits_since_ckpt == 0
    inj2 = PR.FaultInjector(1)
    inj2.fail_mid_checkpoint(port)
    inj2.disarm()
    assert port.checkpoint() is not None and port.failed_checkpoints == 1


def test_wal_corruption_confined_to_tail(tmp_path):
    ref, port = _stacks(tmp_path, checkpoint_every=100, audit_cadence=100,
                        replicated=False)
    rng = np.random.default_rng(4)
    for _ in range(4):
        _submit_both(ref, port, batch(port.session.n, rng, size=20))
    out = []
    for tag, R in (("ref", RR), ("port", PR)):
        d = str(tmp_path / tag)
        path = wal_path(d, port.anchor_step)
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) - 8)
            b = f.read(1)
            f.seek(os.path.getsize(path) - 8)
            f.write(bytes([b[0] ^ 0x10]))
        kw = dict(device=CPU) if R is PR else {}
        out.append(R.DurableSession.restore(d, **kw))
    (ref2, rep_r), (port2, rep) = out
    assert (rep.wal_tail_error, rep.wal_bytes_dropped, rep.records_replayed) == (
        rep_r.wal_tail_error, rep_r.wal_bytes_dropped, rep_r.records_replayed)
    assert rep.records_replayed == 3 and rep.wal_bytes_dropped > 0
    assert port2.session._step == port.session._step - 1
    digests_equal(PR.host_digest(port2.session), RR.host_digest(ref2.session))
    port3, rep3 = PR.DurableSession.restore(str(tmp_path / "port"), device=CPU)
    assert rep3.wal_tail_error is None
    digests_equal(PR.host_digest(port3.session), PR.host_digest(port2.session))


def test_heal_truncates_forked_wal_like_reference(tmp_path):
    ref, port = _stacks(tmp_path, checkpoint_every=100, audit_cadence=100,
                        replicated=False)
    rng = np.random.default_rng(5)
    _submit_both(ref, port, batch(port.session.n, rng, size=20))
    RR.FaultInjector(1).corrupt_base_csr(ref.session.store)
    PR.FaultInjector(1).corrupt_base_csr(port.session.store)
    for _ in range(2):
        _submit_both(ref, port, batch(port.session.n, rng, size=20))
    assert port.heal().ok and ref.heal().ok
    assert port.session._step == ref.session._step < 3
    for f in os.listdir(tmp_path / "port"):
        if f.startswith("wal_"):
            assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes()
    port2, _ = PR.DurableSession.restore(str(tmp_path / "port"), device=CPU)
    digests_equal(PR.host_digest(port2.session), PR.host_digest(port.session))
    _submit_both(ref, port, batch(port.session.n, rng, size=20))
    port3, _ = PR.DurableSession.restore(str(tmp_path / "port"), device=CPU)
    digests_equal(PR.host_digest(port3.session), RR.host_digest(ref.session))


def test_heal_below_every_checkpoint_reanchors(tmp_path):
    _, sess = session_pair(n=300, k=3)
    rs = PR.ResilientSession(sess, cfg=PR.ResilientConfig(audit_cadence=100))
    rs.submit(twin(batch(sess.n, np.random.default_rng(6), size=20)))
    ds = PR.DurableSession(rs, PR.DurableConfig(
        directory=str(tmp_path / "dr"), checkpoint_every=100))
    PR.FaultInjector(2).corrupt_base_csr(sess.store)
    assert ds.heal().ok
    assert ds.anchor_step == sess._step
    ds2, rep = PR.DurableSession.restore(str(tmp_path / "dr"), device=CPU)
    assert rep.records_replayed == 0
    digests_equal(PR.host_digest(ds2.session), PR.host_digest(sess))


def test_quarantined_batches_never_enter_wal(tmp_path):
    _, port = _stacks(tmp_path, checkpoint_every=100, replicated=False)
    port.submit(twin(batch(port.session.n, np.random.default_rng(8), size=20)))
    tx = port.submit(twin(RefUpdate.add_edges([port.session.n + 5], [0])))
    assert tx.quarantined
    recs, _, _ = PR.read_wal(wal_path(str(tmp_path / "port"), port.anchor_step))
    assert len(recs) == 1


def test_from_restored_builds_the_session_init_builds():
    """The disaster-recovery constructor builds engine, store and labels as
    a session start does (arena, mirrors, dtypes), and both equal the
    reference's from_restored; no partition() runs."""
    g = pp_graph(400, 3)
    fresh = PartitionSession(port_graph(g), SessionConfig(k=3, seed=0), device=CPU)
    ref, rest = session_pair(n=400, k=3)
    assert rest.engine.A == fresh.engine.A and rest.device == fresh.device
    assert rest.labels.dtype == fresh.labels.dtype and rest.labels.shape == fresh.labels.shape
    assert torch.equal(rest.labels, fresh.labels)
    assert rest.store._nw.dtype == fresh.store._nw.dtype == np.float64
    assert (rest._cut_ref, rest._ew_ref) == (fresh._cut_ref, fresh._ew_ref)
    for name in ("indptr", "indices", "ew", "nw", "src"):
        a, b = getattr(rest.store.base, name), getattr(fresh.store.base, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert rest.engine.stats.sweep_calls == 0       # no V-cycle ran
    digests_equal(PR.host_digest(rest), RR.host_digest(ref))
    assert dataclasses.asdict(rest.trajectory[0]) .keys() == dataclasses.asdict(
        ref.trajectory[0]).keys()
