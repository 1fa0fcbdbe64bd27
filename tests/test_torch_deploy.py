"""Port parity for the deployment subsystem: repro_torch.deploy (block
shard extraction, ghost-exchange schedules, reassembly, comm metrics and
incremental migration) on the CPU against repro.deploy on the same seeded
inputs.  Every array of every shard, every migration delta and every shape
bucket equals the reference's exactly (weights are integral).  The parity
twins of tests/test_deploy.py."""

import numpy as np
import pytest
import torch

import repro.deploy as RDe
import repro.graph as RG
from repro.core.metrics import comm_volume_np, cut_np
from repro.dynamic import GraphUpdate as RefUpdate

from repro_torch.deploy import (
    BlockExtractor,
    ShardDeployment,
    block_comm_metrics_np,
    extract_blocks_numpy,
    ghost_exchange_numpy,
    reassemble,
    shard_comm_metrics,
)
from repro_torch.graph import to_device_csr, validate

from _torch_twins import (
    CPU,
    delta_view,
    port_graph,
    session_pair,
    shards_equal,
    twin,
)

torch.set_num_threads(1)


# ----------------------------------------------------------------- extraction


@pytest.mark.parametrize("k,halo,seed", [(2, 1, 0), (4, 1, 1), (4, 2, 2),
                                         (3, 3, 3), (8, 2, 4)])
def test_extraction_matches_reference(k, halo, seed):
    """Every array of every shard — CSR, halo, id maps, schedule — equals
    the reference's extractor and numpy oracle, from a GraphNP and from a
    resident GraphDev; padded shapes and shape buckets equal too."""
    g = RG.barabasi_albert(700, 4, seed=seed)
    lab = np.random.default_rng(seed).integers(0, k, g.n).astype(np.int32)
    oracle = RDe.extract_blocks_numpy(g, lab, k, halo=halo)
    ref_ex = RDe.BlockExtractor()
    ref = ref_ex.extract(g, lab, k, halo=halo)
    gp = port_graph(g)
    shards_equal(extract_blocks_numpy(gp, lab, k, halo=halo), oracle)
    ex = BlockExtractor(device=CPU)
    port = ex.extract(gp, lab, k, halo=halo)
    shards_equal(port, oracle)
    for a, b in zip(port, ref):
        for f in ("own_g", "ghost_g", "ghost_hop", "ghost_block_dev", "nw",
                  "ghost_nw", "indptr", "indices", "ew"):
            assert tuple(getattr(a, f).shape) == tuple(getattr(b, f).shape), f
    assert ex.stats.deploy_buckets == ref_ex.stats.deploy_buckets
    assert ex.stats.extract_calls == ref_ex.stats.extract_calls == k
    # the device-resident path: a GraphDev handle and a label tensor
    shards_equal(
        BlockExtractor(device=CPU).extract(
            to_device_csr(gp, CPU), torch.from_numpy(lab), k, halo=halo),
        oracle,
    )


@pytest.mark.parametrize("halo", [1, 2])
def test_extraction_on_mesh_partition_labels(halo):
    """Structured (low-boundary) labels: thin halo rings."""
    g = RG.mesh2d(24)
    k = 4
    lab = ((np.arange(g.n) // 24 // 12) * 2 + (np.arange(g.n) % 24) // 12)
    lab = lab.astype(np.int32)
    shards_equal(BlockExtractor(device=CPU).extract(port_graph(g), lab, k, halo=halo),
                 RDe.extract_blocks_numpy(g, lab, k, halo=halo))


def test_shard_structure_invariants():
    """Local id space and h-ring layout of the port's oracle: owned ids
    ascending, ghosts ordered by (ring, id), rows = owned + interior
    ghosts, every row's adjacency fully inside the shard."""
    g = port_graph(RG.planted_partition(900, 6, p_in=0.04, p_out=0.004, seed=5))
    k, halo = 3, 2
    lab = np.random.default_rng(1).integers(0, k, g.n).astype(np.int32)
    for h in extract_blocks_numpy(g, lab, k, halo=halo):
        assert np.all(np.diff(h.own_global) > 0)
        np.testing.assert_array_equal(lab[h.own_global], h.block)
        key = h.ghost_hop.astype(np.int64) * g.n + h.ghost_global
        assert np.all(np.diff(key) > 0)
        assert np.all((h.ghost_hop >= 1) & (h.ghost_hop <= halo))
        np.testing.assert_array_equal(lab[h.ghost_global], h.ghost_block)
        assert np.all(h.ghost_block != h.block)
        assert h.n_rows == h.n_own + int((h.ghost_hop < halo).sum())
        assert h.indices.max(initial=-1) < h.n_own + h.n_ghost
        np.testing.assert_array_equal(np.diff(h.indptr),
                                      g.degrees()[h.local_global[: h.n_rows]])


# ---------------------------------------------------------------- reassembly


@pytest.mark.parametrize("halo", [1, 2])
def test_reassembly_reproduces_global_graph_and_cut(halo):
    g = RG.rmat(10, 8, seed=3)
    k = 4
    lab = np.random.default_rng(2).integers(0, k, g.n).astype(np.int32)
    shards = BlockExtractor(device=CPU).extract(port_graph(g), lab, k, halo=halo)
    g2 = reassemble(shards, g.n)
    ref = RDe.reassemble(RDe.BlockExtractor().extract(g, lab, k, halo=halo), g.n)
    for f in ("indptr", "indices", "ew", "nw"):
        np.testing.assert_array_equal(getattr(g2, f), getattr(g, f))
        np.testing.assert_array_equal(getattr(g2, f), getattr(ref, f))
        assert getattr(g2, f).dtype == getattr(ref, f).dtype
    validate(g2)
    tot = 0.0
    for s in shards:
        h = s.host()
        m_own = int(h.indptr[h.n_own])
        tot += float(h.ew[:m_own][h.indices[:m_own] >= h.n_own].sum())
    assert tot / 2.0 == cut_np(g, lab)


# ------------------------------------------------------------ ghost exchange


def test_ghost_exchange_round_trip():
    g = RG.barabasi_albert(800, 5, seed=7)
    k = 5
    rng = np.random.default_rng(7)
    lab = rng.integers(0, k, g.n).astype(np.int32)
    for halo in (1, 2):
        shards = BlockExtractor(device=CPU).extract(port_graph(g), lab, k, halo=halo)
        ref = RDe.BlockExtractor().extract(g, lab, k, halo=halo)
        for vals in (lab, rng.integers(0, 10**6, g.n)):
            recvs = ghost_exchange_numpy(shards, vals)
            for s, r, rr in zip(shards, recvs, RDe.ghost_exchange_numpy(ref, vals)):
                np.testing.assert_array_equal(r, vals[s.ghost_global_np()])
                np.testing.assert_array_equal(r, rr)
        for s, r in zip(shards, ghost_exchange_numpy(shards, lab)):
            np.testing.assert_array_equal(r, s.ghost_block_np())


# -------------------------------------------------------------------- metrics


def test_comm_metrics_label_and_shard_views_agree_with_reference():
    g = RG.planted_partition(1200, 8, p_in=0.03, p_out=0.003, seed=9)
    k = 4
    lab = np.random.default_rng(4).integers(0, k, g.n).astype(np.int32)
    gp = port_graph(g)
    m_lab = block_comm_metrics_np(gp, lab, k)
    m_sh = shard_comm_metrics(BlockExtractor(device=CPU).extract(gp, lab, k, halo=1))
    m_ref = RDe.block_comm_metrics_np(g, lab, k)
    for f in ("boundary", "send", "recv"):
        np.testing.assert_array_equal(m_lab[f], m_sh[f])
        np.testing.assert_array_equal(m_lab[f], m_ref[f])
    for f in ("total_volume", "max_volume", "total_boundary", "max_boundary"):
        assert m_lab[f] == m_sh[f] == m_ref[f], f
    assert m_lab["total_volume"] == int(comm_volume_np(g, lab, k))


# ----------------------------------------------------------- shape buckets


def test_extractor_buckets_follow_reference_over_a_churn_stream():
    """Sticky buckets: over a label-churn stream the port's bucket set and
    call counts equal the reference's, step by step."""
    g = RG.barabasi_albert(2048, 4, seed=11)
    gp = port_graph(g)
    k = 4
    rng = np.random.default_rng(11)
    lab = rng.integers(0, k, g.n).astype(np.int32)
    ref_ex, ex = RDe.BlockExtractor(), BlockExtractor(device=CPU)
    for _ in range(4):
        shards_equal(ex.extract(gp, lab, k, halo=1), ref_ex.extract(g, lab, k, halo=1))
        assert ex.stats.deploy_buckets == ref_ex.stats.deploy_buckets
        lab = lab.copy()
        flip = rng.integers(0, g.n, 30)
        lab[flip] = (lab[flip] + 1) % k
    assert ex.stats.extract_calls == ref_ex.stats.extract_calls == 16
    assert ex.stats.deploy_bucket_count == ref_ex.stats.deploy_bucket_count


def test_extractor_reuse_across_graph_scales_and_partial_extraction():
    ex = BlockExtractor(device=CPU)
    big = port_graph(RG.barabasi_albert(2048, 4, seed=1))
    small = port_graph(RG.barabasi_albert(200, 3, seed=2))
    k = 2
    ex.extract(big, (np.arange(big.n) % k).astype(np.int32), k, halo=1)
    lab_small = (np.arange(small.n) % k).astype(np.int32)
    shards_equal(ex.extract(small, lab_small, k, halo=1),
                 extract_blocks_numpy(small, lab_small, k))
    with pytest.raises(ValueError, match="assemble"):
        ex.extract(small, lab_small, k, halo=1, blocks=[0])
    sub = ex.extract(small, lab_small, k, halo=1, blocks=[0], assemble=False)
    assert len(sub) == 1 and sub[0].ghost_slot is None
    with pytest.raises(ValueError, match="halo"):
        ex.extract(small, lab_small, k, halo=0)


# ------------------------------------------------------------------ migration


def _interior_batch(sess, rng, k, size=12):
    """Localized churn: random pairs among one block's interior nodes."""
    lab = sess.labels_np()
    gh = sess.store.csr_host()
    src = gh.arc_sources()
    bnd = np.zeros(gh.n, bool)
    bnd[src[lab[src] != lab[gh.indices]]] = True
    b = int(np.argmax(np.bincount(lab[~bnd], minlength=k)))
    ids = np.flatnonzero((lab == b) & ~bnd)
    u, v = rng.choice(ids, size), rng.choice(ids, size)
    keep = u != v
    return RefUpdate.add_edges(u[keep], v[keep])


def test_deployment_migration_deltas_match_reference():
    """ShardDeployment over a session: after every batch (localized churn,
    random churn, a no-op) the delta and the whole shard set equal the
    reference's, and the shards equal a fresh oracle extraction."""
    k = 8
    ref_s, port_s = session_pair(n=1200, k=k, seed=13, p_in=0.05, p_out=0.0003)
    ref, port = RDe.ShardDeployment(ref_s, halo=1), ShardDeployment(port_s, halo=1)
    shards_equal(port.shards, ref.shards)
    rng = np.random.default_rng(13)
    partial = 0
    for step in range(5):
        if step == 3:
            upd = RefUpdate()
        elif step % 2 == 0:
            upd = _interior_batch(ref_s, rng, k)
        else:
            u = rng.integers(0, ref_s.n, 20)
            upd = RefUpdate.add_edges(u, (u + 1 + rng.integers(0, ref_s.n - 1, 20)) % ref_s.n)
        r_res, r_delta = ref.update(upd)
        p_res, p_delta = port.update(twin(upd))
        assert delta_view(p_delta) == delta_view(r_delta)
        assert p_res.noop == r_res.noop == (step == 3)
        partial += int(not p_delta.full_rebuild and 0 < p_delta.blocks_patched.size < k)
        shards_equal(port.shards, ref.shards)
        shards_equal(port.shards, extract_blocks_numpy(
            port_s.store.csr_host(), port_s.labels_np(), k, halo=1))
    assert partial >= 1
    a, b = ref.stats(), port.stats()
    for key in ("migrate_calls", "full_rebuilds", "blocks_patched_total",
                "extract_calls", "deploy_bucket_count"):
        assert b[key] == a[key], key


def test_migration_node_growth_and_escalation_match_reference():
    """add_nodes (arena growth) and a forced escalation both end in the
    reference's (fully rebuilt) shard set."""
    k = 2
    ref_s, port_s = session_pair(n=1000, k=k, seed=23, p_in=0.05, p_out=0.001,
                                 escalate_cut_ratio=1.05, hops=1)
    ref, port = RDe.ShardDeployment(ref_s, halo=1), ShardDeployment(port_s, halo=1)
    upd = RefUpdate.add_nodes(np.ones(50, np.int64))
    _, r_delta = ref.update(upd)
    _, p_delta = port.update(twin(upd))
    assert port_s.n == 1050
    assert delta_view(p_delta) == delta_view(r_delta)
    shards_equal(port.shards, ref.shards)
    rng = np.random.default_rng(5)
    u = rng.integers(0, port_s.n, 600)
    upd = RefUpdate.add_edges(u, (u + 1 + rng.integers(0, port_s.n - 1, 600)) % port_s.n)
    r_res, r_delta = ref.update(upd)
    p_res, p_delta = port.update(twin(upd))
    assert p_res.escalated and r_res.escalated and p_delta.full_rebuild
    assert delta_view(p_delta) == delta_view(r_delta)
    shards_equal(port.shards, ref.shards)
    shards_equal(port.shards, extract_blocks_numpy(
        port_s.store.csr_host(), port_s.labels_np(), k, halo=1))


def test_recover_block_and_resync_match_reference():
    """recover_block re-extracts a lost shard; resync(full=True) re-extracts
    every block through migrate — both equal the reference's."""
    k = 3
    ref_s, port_s = session_pair(n=400, k=k)
    ref, port = RDe.ShardDeployment(ref_s, halo=2), ShardDeployment(port_s, halo=2)
    ref.shards[1] = port.shards[1] = None
    ref.recover_block(1)
    port.recover_block(1)
    shards_equal(port.shards, ref.shards)
    assert delta_view(port.resync(full=True)) == delta_view(ref.resync(full=True))
    shards_equal(port.shards, ref.shards)
    assert port.shard_recoveries == ref.shard_recoveries == 1
