"""Shared helpers of the port's deployment and resilience parity tests:
the same seeded graph, starting partition and update stream handed to the
reference (``repro``) and to the port (``repro_torch``, on the CPU)."""

import dataclasses
import functools

import numpy as np

import repro.dynamic as RD
import repro.graph as RG
import repro_torch.dynamic as PD
from repro_torch.graph import from_reference

CPU = "cpu"
_UPD_FIELDS = ("add_u", "add_v", "add_w", "rem_u", "rem_v", "rem_w",
               "add_node_w")


def port_graph(g):
    return from_reference(g.indptr, g.indices, g.ew, g.nw)


def twin(upd):
    """The port's GraphUpdate with the reference update's arrays."""
    return PD.GraphUpdate(**{f: getattr(upd, f) for f in _UPD_FIELDS})


@functools.lru_cache(maxsize=None)
def pp_graph(n: int, k: int, seed: int = 0, p_in: float = 12, p_out: float = 2):
    """``planted_partition(n, k, p_in, p_out, seed)``; the defaults are the
    reference resilience tests' dense graph."""
    return RG.planted_partition(n, k, p_in, p_out, seed=seed)


@functools.lru_cache(maxsize=None)
def _golden(n: int, k: int, seed: int, p_in: float, p_out: float):
    """One ``partition()`` per graph and process: the labels and quality
    references a session started on it would hold (the port's partition,
    which equals the reference's)."""
    s = PD.PartitionSession(port_graph(pp_graph(n, k, seed, p_in, p_out)),
                            PD.SessionConfig(k=k, seed=seed), device=CPU)
    return s.labels_np(), s._cut_ref, s._ew_ref


def session_pair(n=600, k=4, seed=0, p_in=12, p_out=2, **cfg_kw):
    """A reference and a port session in the same state, restored from one
    golden partition of ``pp_graph(n, k, seed, p_in, p_out)`` (no V-cycle
    per test)."""
    g = pp_graph(n, k, seed, p_in, p_out)
    lab, cut_ref, ew_ref = _golden(n, k, seed, p_in, p_out)
    kw = dict(labels=lab.copy(), step=0, cut_ref=cut_ref, ew_ref=ew_ref)
    ref = RD.PartitionSession.from_restored(
        g, RD.SessionConfig(k=k, seed=seed, **cfg_kw), **kw)
    port = PD.PartitionSession.from_restored(
        port_graph(g), PD.SessionConfig(k=k, seed=seed, **cfg_kw), device=CPU,
        **kw)
    return ref, port


def batch(n, rng, size=24):
    """A reference GraphUpdate of ``size`` random edge additions."""
    u = rng.integers(0, n, size)
    v = (u + 1 + rng.integers(0, n - 1, size)) % n
    return RD.GraphUpdate.add_edges(u, v)


def digests_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def shards_equal(port_shards, ref_shards):
    """Every field of every shard's ``BlockShardNP`` equal, array dtypes
    included (``ref_shards`` may be device shards or host views)."""
    assert len(port_shards) == len(ref_shards)
    for s, o in zip(port_shards, ref_shards):
        h = s.host() if hasattr(s, "host") else s
        o = o.host() if hasattr(o, "host") else o
        for f in dataclasses.fields(h):
            a, b = getattr(h, f.name), getattr(o, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
                np.testing.assert_array_equal(a, b, err_msg=f"block {h.block}: {f.name}")
            else:
                assert a == b, (h.block, f.name, a, b)


def result_view(r):
    if r is None:
        return None
    return (r.step, r.n, r.m, r.cut, r.imbalance, r.feasible, r.region_size,
            r.escalated, r.noop, r.stale, r.used_view)


def tx_view(tx):
    """Everything a TxResult says except its wall-clock seconds."""
    audit = None if tx.audit is None else (
        tx.audit.step, tx.audit.ok, tuple(tx.audit.failures),
        tuple(tx.audit.checked), tx.audit.stored_cut, tx.audit.recomputed_cut)
    return (tx.seq, tx.committed, tx.retries, tx.rolled_back, tx.quarantined,
            tx.duplicate, tx.parked, tx.reason, tx.migration_failed, audit,
            result_view(tx.result), tuple(tx_view(f) for f in tx.followups))


def delta_view(d):
    """Everything a MigrationDelta says except its wall-clock seconds."""
    return dict(
        step=d.step, moved=d.moved.tolist(), moved_from=d.moved_from.tolist(),
        moved_to=d.moved_to.tolist(), dirty=d.dirty.tolist(),
        blocks_patched=d.blocks_patched.tolist(), full_rebuild=d.full_rebuild,
        failed=d.failed,
        halo_added={int(b): v.tolist() for b, v in d.halo_added.items()},
        halo_removed={int(b): v.tolist() for b, v in d.halo_removed.items()},
    )
