"""Port parity for contraction: repro_torch contract_device against the JAX
contract_device on the same bucket-padded inputs (packed-key path, the
general float path and the lexsort-sized bucket), plus the engine's
contract/project against the host oracle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.contraction as RC
import repro.graph as R

import repro_torch.core.contraction as TC
from repro_torch.core import LPEngine, contract
from repro_torch.core.metrics import cut_np
from repro_torch.graph import GraphDev, arc_bucket, from_reference, pow2

torch.set_num_threads(1)


def _graph(case):
    return {
        "rmat": lambda: R.rmat(10, 8, seed=5),
        "mesh": lambda: R.mesh2d(20),
        "planted": lambda: R.planted_partition(1500, 8, p_in=0.03, p_out=0.002, seed=1),
        "ba257": lambda: R.barabasi_albert(257, 3, seed=2),
        "ba256": lambda: R.barabasi_albert(256, 3, seed=2),
        "mesh_big": lambda: R.mesh2d(190),     # Nb = 2^16: the lexsort bucket
    }[case]()


def _padded(gr, ew):
    n, m = gr.n, gr.m
    Nb, Mb = pow2(max(n, 8)), arc_bucket(m)
    src = np.zeros(Mb, np.int32)
    src[:m] = gr.arc_sources()
    dst = np.zeros(Mb, np.int32)
    dst[:m] = gr.indices
    w = np.zeros(Mb, np.float32)
    w[:m] = ew
    nw = np.zeros(Nb, np.float32)
    nw[:n] = gr.nw
    return src, dst, w, nw, Nb, Mb


CASES = [
    ("rmat", "unit"), ("mesh", "unit"), ("planted", "unit"), ("ba257", "unit"),
    ("ba256", "unit"), ("rmat", "float"), ("planted", "float"), ("rmat", "big"),
    ("mesh_big", "unit"), ("mesh_big", "float"),
]


@pytest.mark.parametrize("case,weights", CASES)
def test_contract_device_matches_reference(case, weights):
    gr = _graph(case)
    rng = np.random.default_rng(len(case))
    ew = {
        "unit": gr.ew,
        "float": rng.random(gr.m).astype(np.float32) + 0.25,
        "big": (rng.integers(1, 8, gr.m) * 2**18).astype(np.float32),
    }[weights]
    src, dst, w, nw, Nb, Mb = _padded(gr, ew)
    integral = bool(np.all(ew == np.round(ew)))
    wbits = TC.packed_key_wbits(Nb, Mb, float(ew.max()), integral)
    assert wbits == RC.packed_key_wbits(Nb, Mb, float(ew.max()), integral)
    assert (wbits > 0) == (weights == "unit" and case != "mesh_big")
    labels = np.zeros(Nb, np.int32)
    labels[: gr.n] = rng.integers(0, max(gr.n // 3, 2), gr.n)
    want = RC.contract_device(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), jnp.asarray(nw),
        jnp.asarray(labels), jnp.int32(gr.n), jnp.int32(gr.m), wbits=wbits,
    )
    got = TC.contract_device(
        torch.from_numpy(src).long(), torch.from_numpy(dst).long(), torch.from_numpy(w),
        torch.from_numpy(nw), torch.from_numpy(labels), gr.n, gr.m, wbits=wbits,
    )
    names = ("C", "n_c", "nw_c", "indptr_c", "src_c", "dst_c", "ew_c", "m_c",
             "nwmax_c", "ewmax_c")
    for name, a, b in zip(names, want, got):
        a, b = np.asarray(a), b.numpy()
        if weights == "float" and name in ("ew_c", "ewmax_c"):
            # float segment sums: stated tolerance (both add each run in
            # original arc order on the CPU, so they agree in practice)
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("case", ["rmat", "mesh", "ba257"])
def test_engine_contract_matches_host_oracle(case):
    gr = _graph(case)
    g = from_reference(gr.indptr, gr.indices, gr.ew, gr.nw)
    rng = np.random.default_rng(3)
    labels = rng.integers(0, max(g.n // 2, 2), g.n).astype(np.int32)
    eng = LPEngine(g, seed=0, device="cpu")
    cdev, cmap = eng.contract(g, labels)
    chost, C_host = contract(g, labels)
    rhost, C_ref = RC.contract(gr, labels)
    assert isinstance(cdev, GraphDev)
    assert (cdev.n, cdev.m) == (chost.n, chost.m) == (rhost.n, rhost.m)
    np.testing.assert_array_equal(cmap.host(), C_host)
    np.testing.assert_array_equal(C_host, C_ref)
    gh = cdev.to_host()
    for f in ("indptr", "indices", "ew", "nw"):
        np.testing.assert_array_equal(getattr(gh, f), getattr(chost, f))
        np.testing.assert_array_equal(getattr(chost, f), getattr(rhost, f))
    # projection keeps the cut
    k = 3
    lab_c = rng.integers(0, k, cdev.n).astype(np.int32)
    lab_f = eng.project(torch.from_numpy(lab_c), cmap, fill=k)[: g.n].numpy()
    np.testing.assert_array_equal(lab_f, lab_c[cmap.host()])
    assert abs(cut_np(gh, lab_c) - cut_np(g, lab_f)) < 1e-3


def test_engine_holds_a_host_graphs_arcs_once(monkeypatch):
    """A GraphNP's arcs live on the device once: its chunk-pack and ELL
    gathers and its contraction all read the one to_device_csr upload, and
    base_csr accounts that upload, the coarse level and the contraction
    map, nothing more."""
    import repro_torch.core.engine as TE
    from repro_torch.graph import to_device_csr
    from repro_torch.obs import accountant, set_accounting

    seen = []

    def spy(fn, pos):
        def wrapped(*args, **kw):
            seen.append((fn.__name__, args[pos].data_ptr()))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(TE, "gather_pack_device", spy(TE.gather_pack_device, 3))
    monkeypatch.setattr(TE, "gather_ell_device", spy(TE.gather_ell_device, 2))
    monkeypatch.setattr(TE, "contract_device", spy(TE.contract_device, 1))
    gr = R.rmat(10, 8, seed=5)
    g = from_reference(gr.indptr, gr.indices, gr.ew, gr.nw)
    k = 2
    prev = set_accounting(True)
    try:
        accountant().reset()
        eng = LPEngine(g, device="cpu")
        clus = eng.cluster(g, U=float(g.nw.sum()) / 8, iters=2, seed=0)
        coarse, cmap = eng.contract(g, clus)
        eng.refine_dense(g, np.arange(g.n, dtype=np.int32) % k, k,
                         U=float(g.nw.sum()), iters=1, seed=0)
        base = accountant().snapshot()["by_family"]["base_csr"]
    finally:
        set_accounting(prev)
        accountant().reset()
    assert sorted(name for name, _ in seen) == [
        "contract_device", "gather_ell_device", "gather_pack_device"]
    dst = eng._dev(g).indices.data_ptr()
    assert all(ptr == dst for _, ptr in seen), seen

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    up = to_device_csr(g, "cpu")
    assert base == (nbytes(up.indptr, up.indices, up.ew, up.nw, up.src)
                    + nbytes(coarse.indptr, coarse.indices, coarse.ew, coarse.nw,
                             coarse.src, cmap.dev))


def test_weights_exact_matches_reference():
    from repro.core.engine import LPEngine as RefEngine

    gr = R.rmat(9, 8, seed=1)
    heavy = R.from_edges(gr.n, gr.arc_sources(), gr.indices,
                         w=np.full(gr.m, 2.0**15, np.float32))
    halves = R.from_edges(gr.n, gr.arc_sources(), gr.indices,
                          w=np.full(gr.m, 0.25, np.float32))  # arcs sum to 0.5
    for g, want in ((gr, True), (heavy, False), (halves, False)):
        gt = from_reference(g.indptr, g.indices, g.ew, g.nw)
        assert LPEngine(gt, device="cpu")._weights_exact() is want
        assert RefEngine(g)._weights_exact() is want
        gd = LPEngine(gt, device="cpu").contract(gt, np.arange(gt.n))[0]
        assert LPEngine(gd, device="cpu")._weights_exact() is want


def test_chained_device_levels_match_host_chain():
    """cluster -> contract -> cluster -> contract stays on the device and
    reproduces the host chain."""
    gr = R.barabasi_albert(4096, 5, seed=1)
    g = from_reference(gr.indptr, gr.indices, gr.ew, gr.nw)
    U = max(1.0, float(np.ceil(g.n / 2) * 1.03) / 14)
    eng = LPEngine(g, seed=0, device="cpu")
    lab1 = eng.cluster(g, U=U, iters=3, seed=7)
    cdev, _ = eng.contract(g, lab1)
    lab2 = eng.cluster(cdev, U=U, iters=3, seed=8)
    cdev2, _ = eng.contract(cdev, lab2)
    chost2, _ = contract(cdev.to_host(), lab2.numpy())
    gh2 = cdev2.to_host()
    for f in ("indptr", "indices", "ew", "nw"):
        np.testing.assert_array_equal(getattr(gh2, f), getattr(chost2, f))
    assert eng.stats.gather_builds >= 1
