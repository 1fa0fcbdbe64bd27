"""The engine's device pack gathers for a host-resident graph on the CPU.

``LPEngine`` plans every pack in O(n) on the host and gathers its O(m) edge
arrays on the device, the finest (host-resident ``GraphNP``) graph
included.  Its chunk packs and ELL packs must equal, array for array in
shape, dtype and values, what the host packers give:
``pad_pack(pack_chunks(...))`` under the engine's sticky buckets and the
padded ``ell_pack(...)``.  The gathers split a large input into groups
under ``GATHER_BUDGET_BYTES``; any grouping gives the arrays of one group.
This file imports neither jax nor the reference package."""

import numpy as np
import pytest
import torch

import repro_torch.graph.packing as TP
from repro_torch.core import PartitionerConfig, partition
from repro_torch.core.engine import LPEngine
from repro_torch.core.label_propagation import make_order
from repro_torch.graph import from_edges, pow2, rmat, star

torch.set_num_threads(1)

CPU = "cpu"
PACK_FIELDS = ("nodes", "node_valid", "edge_dst", "edge_w", "edge_src_slot",
               "edge_valid")
# the dtypes the engine has always handed the sweep
PACK_DTYPES = dict(nodes=torch.int64, node_valid=torch.bool, edge_dst=torch.int64,
                   edge_w=torch.float32, edge_src_slot=torch.int64,
                   edge_valid=torch.bool)

GRAPHS = {
    "rmat": lambda: rmat(12, 8, seed=3),
    # no arcs at all
    "no_arcs": lambda: from_edges(100, np.zeros(0, np.int64), np.zeros(0, np.int64)),
    # one live chunk, seven dead ones in the shared chunk bucket
    "one_chunk": lambda: rmat(8, 4, seed=1),
    # the hub's 4999 arcs exceed the 4096-arc chunk edge request
    "hub": lambda: star(5000),
}


def _host_pack(g, mode, eng, buckets):
    """The host packers under the engine's sticky (C, E) buckets."""
    order = make_order(g, mode, eng.seed)
    pack = TP.pack_chunks(g, order, max_nodes=eng.N,
                          max_edges=max(eng._e_request, buckets[1]),
                          block=eng.pack_block)
    C = pack.nodes.shape[0]
    buckets[0] = max(buckets[0], pow2(C))
    buckets[1] = max(buckets[1], -(-pack.edge_dst.shape[1] // 512) * 512)
    return TP.pad_pack(pack, buckets[0], eng.N, buckets[1]), C


def _same(got: torch.Tensor, want: np.ndarray, dtype: torch.dtype):
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("first", ["degree", "random"])
def test_finest_chunk_packs_equal_the_host_packers(name, first):
    """Both orders, each built first on a fresh engine and then second,
    under the buckets the first raised."""
    g = GRAPHS[name]()
    eng = LPEngine(g, device=CPU)
    buckets = [eng.C_bucket, eng.E_floor]
    for mode in (first, {"degree": "random", "random": "degree"}[first]):
        dp = eng._pack(g, mode)
        want, C = _host_pack(g, mode, eng, buckets)
        assert dp.num_chunks == C
        assert dp.shape == (buckets[0], eng.N, buckets[1])
        assert (eng.C_bucket, eng.E_floor) == tuple(buckets)
        for f in PACK_FIELDS:
            _same(getattr(dp, f), getattr(want, f), PACK_DTYPES[f])
    if name == "one_chunk":
        assert dp.num_chunks == 1 and dp.shape[0] == 8
    if name == "hub":
        assert dp.shape[2] > eng._e_request


@pytest.mark.parametrize("name", list(GRAPHS))
def test_finest_ell_equals_the_host_packer(name):
    g = GRAPHS[name]()
    eng = LPEngine(g, device=CPU)
    de = eng._ell(g)
    ell = TP.ell_pack(g)
    R = ell.rows
    Rb = pow2(R)
    _same(de.dst, np.pad(ell.dst, ((0, Rb - R), (0, 0)), constant_values=g.n),
          torch.int64)
    _same(de.w, np.pad(ell.w, ((0, Rb - R), (0, 0))), torch.float32)
    _same(de.row_node, np.pad(ell.row_node, (0, Rb - R), constant_values=g.n),
          torch.int64)
    assert de.nb == pow2(g.n + 1)
    assert eng.stats.gather_builds == eng.stats.pack_builds == 1


def _lanes():
    """Two lanes of one chunk plan shape over their own CSRs (``(B, ...)``),
    as the tenant batch gathers them."""
    gs = [rmat(10, 8, seed=5), star(600)]
    Mb = max(g.m for g in gs)
    Nb = max(g.n for g in gs)
    plans, C, E = [], 1, 0
    for g in gs:
        order = make_order(g, "random", 2)
        node_chunk, c, N, e = TP.plan_chunks(g.degrees().astype(np.int64)[order],
                                             g.n, max_nodes=128, max_edges=1024,
                                             block=8)
        plans.append(TP.layout_nodes(order, node_chunk, c, 128, g.n))
        C, E = max(C, c), max(E, e)
    nodes = np.stack([np.pad(p[0], ((0, C - p[0].shape[0]), (0, 0)),
                             constant_values=g.n) for p, g in zip(plans, gs)])
    nv = np.stack([np.pad(p[1], ((0, C - p[1].shape[0]), (0, 0))) for p in plans])
    ip = np.stack([np.concatenate([g.indptr, np.full(Nb - g.n, g.m)]) for g in gs])
    dst = np.stack([np.pad(g.indices, (0, Mb - g.m)) for g in gs])
    ew = np.stack([np.pad(g.ew, (0, Mb - g.m)) for g in gs])
    t = torch.from_numpy
    return (t(nodes).long(), t(nv), t(ip).long(), t(dst).long(), t(ew),
            torch.tensor([g.n for g in gs]), -(-E // 512) * 512)


def test_grouped_gathers_equal_one_group(monkeypatch):
    """A budget that forces one chunk or a few rows a group gives the
    arrays of one group: chunk packs with and without the lane axis, and
    the ELL."""
    nodes, nv, ip, dst, ew, ns, E = _lanes()
    g = rmat(11, 8, seed=4)
    row_node, row_first, row_end = TP.plan_ell_rows(g.indptr, g.n)
    ell_in = (torch.from_numpy(row_first).long(), torch.from_numpy(row_end).long(),
              torch.from_numpy(g.indices).long(), torch.from_numpy(g.ew), g.n)

    def run():
        lanes = TP.gather_pack_device(nodes, nv, ip, dst, ew, ns, E=E)
        one = TP.gather_pack_device(nodes[0], nv[0], ip[0], dst[0], ew[0],
                                    int(ns[0]), E=E)
        return lanes, one, TP.gather_ell_device(*ell_in)

    whole = run()
    groups = []
    real_group = TP._pack_group

    def counted(starts_g, *args):
        groups.append(starts_g.shape)
        return real_group(starts_g, *args)

    monkeypatch.setattr(TP, "_pack_group", counted)
    monkeypatch.setattr(TP, "GATHER_BUDGET_BYTES", 1)
    split = run()
    C = nodes.shape[1]
    assert groups == [(2, 1, nodes.shape[2])] * C + [(1, 1, nodes.shape[2])] * C
    monkeypatch.setattr(TP, "GATHER_BUDGET_BYTES", 5 * TP.ELL_WIDTH * TP._ELL_SLOT_BYTES)
    split_ell = TP.gather_ell_device(*ell_in)
    assert row_first.shape[0] > 5
    for got, want in zip(split[0] + split[1] + split[2] + split_ell,
                         whole[0] + whole[1] + whole[2] + whole[2]):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    # the lanes are each lane's own gather
    for got, want in zip(whole[0], whole[1]):
        assert torch.equal(got[0], want)
    assert bool(whole[0][3][1].any()) and int(whole[0][0][1].max()) == 600


@pytest.mark.parametrize("engine", ["dense", "chunked"])
def test_every_pack_build_is_a_device_gather(engine):
    """After a partition() every build, the finest graph's included, is a
    device gather."""
    g = rmat(11, 8, seed=3)
    cfg = PartitionerConfig(k=4, preset="fast", coarsest_factor=30, numpy_below=128,
                            dense_min_n=128, refine_engine=engine)
    st = partition(g, cfg, device=CPU).engine_stats
    assert st["pack_builds"] > 2
    assert st["gather_builds"] == st["pack_builds"]
