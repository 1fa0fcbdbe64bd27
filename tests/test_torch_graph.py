"""Port parity for the graph layer: generators, bucket policies, host
packing planners and the device pack gathers (repro_torch.graph against
repro.graph on the same inputs)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.graph as R
import repro.graph.packing as RP
from repro.core.label_propagation import make_order as ref_make_order

import repro_torch.graph as T
import repro_torch.graph.packing as TP
from repro_torch.core.label_propagation import make_order

torch.set_num_threads(1)


def _same(a, b):
    """Arrays equal element for element and in dtype."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


GENERATORS = [
    ("rmat", lambda m: m.rmat(10, 8, seed=3)),
    ("rmat_skewed", lambda m: m.rmat(9, 4, a=0.45, b=0.25, c=0.2, seed=1)),
    ("planted", lambda m: m.planted_partition(4096, 8, p_in=0.02, p_out=0.0005, seed=2)),
    ("mesh", lambda m: m.mesh2d(16)),
    ("ba", lambda m: m.barabasi_albert(500, 3, seed=4)),
    ("star", lambda m: m.star(50)),
    ("ring", lambda m: m.ring(33)),
]


@pytest.mark.parametrize("name,make", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_generators_byte_identical(name, make):
    gr, gt = make(R), make(T)
    for f in ("indptr", "indices", "ew", "nw"):
        _same(getattr(gr, f), getattr(gt, f))


def test_from_reference_and_from_edges_weights():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 100, 600)
    v = rng.integers(0, 100, 600)
    w = rng.random(600).astype(np.float32)
    gr = R.from_edges(100, u, v, w=w)
    gt = T.from_edges(100, u, v, w=w)
    for f in ("indptr", "indices", "ew", "nw"):
        _same(getattr(gr, f), getattr(gt, f))
    gf = T.from_reference(gr.indptr, gr.indices, gr.ew, gr.nw)
    assert (gf.n, gf.m) == (gr.n, gr.m)
    _same(gf.arc_sources(), gr.arc_sources())


def test_bucket_policies_match():
    for x in list(range(0, 70)) + [255, 256, 257, 16383, 16384, 16385, 50000, 10**6]:
        assert T.pow2(x) == R.pow2(x)
        assert T.arc_bucket(x) == R.arc_bucket(x)
    for n, m, tc in [(100, 900, 64), (10**6, 3 * 10**7, 64), (5000, 60000, 8)]:
        assert TP.chunk_geometry(n, m, tc) == RP.chunk_geometry(n, m, tc)


@pytest.mark.parametrize("case", ["rmat", "mesh", "star"])
def test_host_packing_matches(case):
    gr = {"rmat": lambda: R.rmat(10, 8, seed=5), "mesh": lambda: R.mesh2d(20),
          "star": lambda: R.star(700)}[case]()
    gt = T.from_reference(gr.indptr, gr.indices, gr.ew, gr.nw)
    for mode in ("degree", "random"):
        order = make_order(gt, mode, 11)
        _same(order, ref_make_order(gr, mode, 11))
        for max_nodes, max_edges, block in ((256, 4096, 8), (64, 512, 32)):
            pr = RP.pack_chunks(gr, order, max_nodes, max_edges, block)
            pt = TP.pack_chunks(gt, order, max_nodes, max_edges, block)
            for f in ("nodes", "node_valid", "edge_dst", "edge_w",
                      "edge_src_slot", "edge_valid"):
                _same(getattr(pr, f), getattr(pt, f))
            C, N = pt.nodes.shape
            E = pt.edge_dst.shape[1]
            qr = RP.pad_pack(pr, 2 * C, N + 8, E + 512)
            qt = TP.pad_pack(pt, 2 * C, N + 8, E + 512)
            for f in ("nodes", "node_valid", "edge_dst", "edge_w",
                      "edge_src_slot", "edge_valid"):
                _same(getattr(qr, f), getattr(qt, f))
    for width, tile in ((128, 256), (32, 64)):
        er, et = RP.ell_pack(gr, width, tile), TP.ell_pack(gt, width, tile)
        for f in ("dst", "w", "row_node"):
            _same(getattr(er, f), getattr(et, f))
        for a, b in zip(RP.plan_ell_rows(gr.indptr, gr.n, width, tile),
                        TP.plan_ell_rows(gt.indptr, gt.n, width, tile)):
            _same(a, b)


@pytest.mark.parametrize("case", ["rmat", "planted"])
def test_device_gathers_match_reference(case):
    """gather_pack_device / gather_ell_device in torch equal the JAX ones on
    the same bucket-padded CSR and host plans."""
    gr = {"rmat": lambda: R.rmat(10, 8, seed=7),
          "planted": lambda: R.planted_partition(1500, 8, p_in=0.03, p_out=0.002, seed=1)}[case]()
    gd = R.to_device_csr(gr)       # bucket-padded reference CSR
    indptr, indices, ew = (np.array(a) for a in (gd.indptr, gd.indices, gd.ew))
    order = ref_make_order(gr, "degree", 3)
    deg = gr.degrees()[order]
    node_chunk, C, N, E = RP.plan_chunks(deg, gr.n, max_nodes=256, max_edges=4096, block=8)
    nodes, node_valid = RP.layout_nodes(order, node_chunk, C, N, gr.n)
    nodes_t, nv_t = TP.layout_nodes(order, node_chunk, C, N, gr.n)
    _same(nodes, nodes_t)
    _same(node_valid, nv_t)
    Eb = -(-E // 512) * 512
    want = RP.gather_pack_device(
        jnp.asarray(nodes), jnp.asarray(node_valid), jnp.asarray(indptr),
        jnp.asarray(indices), jnp.asarray(ew), jnp.int32(gr.n), E=Eb,
    )
    got = TP.gather_pack_device(
        torch.from_numpy(nodes).long(), torch.from_numpy(node_valid),
        torch.from_numpy(indptr).long(), torch.from_numpy(indices).long(),
        torch.from_numpy(ew), gr.n, E=Eb,
    )
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # and both equal the host pack of the same plan
    host = TP.pack_chunks(T.from_reference(gr.indptr, gr.indices, gr.ew, gr.nw),
                          order, 256, 4096, 8)
    np.testing.assert_array_equal(got[0][:, :host.edge_dst.shape[1]].numpy(), host.edge_dst)

    row_node, row_first, row_end = RP.plan_ell_rows(gr.indptr, gr.n)
    want_d, want_w = RP.gather_ell_device(
        jnp.asarray(row_first), jnp.asarray(row_end), jnp.asarray(indices),
        jnp.asarray(ew), jnp.int32(gr.n),
    )
    got_d, got_w = TP.gather_ell_device(
        torch.from_numpy(row_first).long(), torch.from_numpy(row_end).long(),
        torch.from_numpy(indices).long(), torch.from_numpy(ew), gr.n,
    )
    np.testing.assert_array_equal(np.asarray(want_d), got_d.numpy())
    np.testing.assert_array_equal(np.asarray(want_w), got_w.numpy())


def test_to_device_csr_roundtrip():
    gr = R.rmat(9, 8, seed=2)
    gt = T.from_reference(gr.indptr, gr.indices, gr.ew, gr.nw)
    gd = T.to_device_csr(gt, device="cpu")
    ref = R.to_device_csr(gr)
    for f in ("indptr", "indices", "ew", "nw", "src"):
        np.testing.assert_array_equal(getattr(gd, f).numpy(), np.asarray(getattr(ref, f)))
    back = gd.to_host()
    for f in ("indptr", "indices", "ew", "nw"):
        _same(getattr(back, f), getattr(gt, f))
    _same(gd.degrees(), gt.degrees())
