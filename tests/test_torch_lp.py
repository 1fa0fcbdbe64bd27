"""Port parity for SCLaP: the uint32 hash family, the chunked sweep
(repro_torch.core.label_propagation.lp_sweep against the JAX _lp_sweep) and
the numpy host code, on integral-weight graphs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.label_propagation as RL
import repro.graph as R
from repro.core.engine import LPEngine as RefEngine

import repro_torch.core.label_propagation as TL
from repro_torch.core import LPEngine
from repro_torch.graph import from_reference, pack_chunks, pad_pack

torch.set_num_threads(1)


def test_hash_family_bit_identical():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    y = rng.integers(-(2**31), 2**31, 4096).astype(np.int32)   # wraps like a uint32 cast
    for base in (0, 1, 0x9E3779B1, 2**32 - 1, RL.hash_base_u32(12345, 3, 0x51ED2701)):
        want = np.asarray(RL._hash_mix(jnp.uint32(base), jnp.asarray(x)))
        got = TL.hash_mix(base, torch.from_numpy(x.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        want_j = np.asarray(RL._hash_jitter(jnp.uint32(base), jnp.asarray(y), jnp.asarray(x)))
        got_j = TL.hash_jitter(base, torch.from_numpy(y), torch.from_numpy(x.astype(np.int64)))
        assert got_j.dtype == torch.float32
        np.testing.assert_array_equal(got_j.numpy().view(np.int32), want_j.view(np.int32))
        np.testing.assert_array_equal(
            TL.hash_jitter_np(base, y, x).view(np.int32), want_j.view(np.int32)
        )
    for seed, it, extra in [(0, 0, 0), (7, 5, 0x7F4A7C15), (2**31 - 1, 123, 0x2545F491)]:
        want = int(RL._hash_base(jnp.int32(seed), jnp.int32(it), extra))
        assert TL.hash_base_u32(seed, it, extra) == want == RL.hash_base_u32(seed, it, extra)
    np.testing.assert_array_equal(TL.hash_unit_np(99, y, x), RL.hash_unit_np(99, y, x))
    np.testing.assert_array_equal(TL.hash_u32_np(99, y, x), RL.hash_u32_np(99, y, x))


def _graph(case):
    gr = {
        "planted": lambda: R.planted_partition(2048, 8, p_in=0.04, p_out=0.001, seed=0),
        "rmat": lambda: R.rmat(10, 8, seed=2),
        "mesh": lambda: R.mesh2d(24),
    }[case]()
    return gr, from_reference(gr.indptr, gr.indices, gr.ew, gr.nw)


def _sweep_inputs(gr, mode, refine, restrict, k, seed, pad):
    """Host inputs of one sweep: a (optionally bucket-padded) pack and the
    arena arrays, as the engine builds them."""
    order = RL.make_order(gr, "random" if refine else "degree", seed)
    pack = pack_chunks(from_reference(gr.indptr, gr.indices, gr.ew, gr.nw), order,
                       max_nodes=256, max_edges=4096, block=8)
    C, N = pack.nodes.shape
    E = pack.edge_dst.shape[1]
    if pad:
        pack = pad_pack(pack, 2 * C, N + 8, E + 512)
    n = gr.n
    A = 1 << (n + 1 - 1).bit_length() if pad else n + 1
    rng = np.random.default_rng(seed)
    if refine:
        lab = np.full(A, k, np.int32)
        lab[:n] = rng.integers(0, k, n)
        bw = np.bincount(lab[:n], weights=gr.nw, minlength=k).astype(np.float32)
        weights = np.concatenate([bw, [np.inf]]).astype(np.float32)
        T = k
    else:
        lab = np.arange(A, dtype=np.int32)
        weights = np.full(A, np.inf, np.float32)
        weights[:n] = gr.nw
        T = n
    nw = np.zeros(A, np.float32)
    nw[:n] = gr.nw
    if restrict:
        r = np.full(A, -1, np.int32)
        r[:n] = rng.integers(0, 4, n)
    else:
        r = np.zeros(1, np.int32)
    return pack, lab, weights, nw, r, T


GRID = [
    # (graph, refine_mode, use_restrict, permute_chunks)
    ("planted", False, False, False),
    ("planted", False, True, False),
    ("rmat", False, True, False),
    ("rmat", True, False, True),
    ("mesh", True, False, False),
    ("mesh", True, False, True),
    ("planted", True, False, True),
]


@pytest.mark.parametrize("case,refine,restrict,permute", GRID)
def test_lp_sweep_matches_reference(case, refine, restrict, permute):
    gr, _ = _graph(case)
    k, seed = 4, 13
    pack, lab, weights, nw, r, T = _sweep_inputs(gr, None, refine, restrict, k, seed, pad=True)
    L = float(np.ceil(gr.nw.sum() / k) * 1.03)
    U = L if refine else max(float(gr.nw.max()), L / 14)
    args_np = (pack.nodes, pack.node_valid, pack.edge_dst, pack.edge_w,
               pack.edge_src_slot, pack.edge_valid)
    want = RL._lp_sweep(
        *(jnp.asarray(a) for a in args_np),
        jnp.asarray(lab), jnp.asarray(weights), jnp.asarray(nw), jnp.asarray(r),
        jnp.float32(U), jnp.int32(seed), jnp.int32(T), jnp.int32(pack.nodes.shape[0] // 2),
        iters=3, refine_mode=refine, use_restrict=restrict, permute_chunks=permute,
    )
    got = TL.lp_sweep(
        torch.from_numpy(pack.nodes).long(), torch.from_numpy(pack.node_valid),
        torch.from_numpy(pack.edge_dst).long(), torch.from_numpy(pack.edge_w),
        torch.from_numpy(pack.edge_src_slot).long(), torch.from_numpy(pack.edge_valid),
        torch.from_numpy(lab), torch.from_numpy(weights), torch.from_numpy(nw),
        torch.from_numpy(r), U, seed, T, pack.nodes.shape[0] // 2,
        iters=3, refine_mode=refine, use_restrict=restrict, permute_chunks=permute,
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2]) > 0


def test_bucketed_pack_parity_with_exact_shapes():
    """The engine's bucket-padded cluster sweep equals the exact-shape
    lp_cluster wrapper, and both equal the reference engine's labels."""
    gr, gt = _graph("planted")
    U, iters, seed = 60.0, 3, 7
    eng = LPEngine(gt, seed=0, device="cpu")
    n_cap, e_cap, blk = eng.N, eng._e_request, eng.pack_block
    lab_bucketed = eng.cluster(gt, U=U, iters=iters, seed=seed).numpy()
    pack = pack_chunks(gt, TL.make_order(gt, "degree", 0), max_nodes=n_cap,
                       max_edges=e_cap, block=blk)
    assert eng.A > gt.n + 1 or eng.C_bucket > pack.nodes.shape[0]
    lab_exact = TL.lp_cluster(gt, U=U, iters=iters, seed=seed, pack=pack,
                              device="cpu").labels
    np.testing.assert_array_equal(lab_bucketed, lab_exact)
    ref = np.asarray(RefEngine(gr, seed=0).cluster(gr, U=U, iters=iters, seed=seed))
    np.testing.assert_array_equal(lab_bucketed, ref)


def test_lp_refine_wrapper_matches_reference():
    gr, gt = _graph("mesh")
    k = 2
    lab = (np.arange(gr.n) // 24 >= 12).astype(np.int32)
    lab[np.random.default_rng(1).random(gr.n) < 0.15] ^= 1
    L = float(np.ceil(gr.n / k) * 1.03)
    want = RL.lp_refine(gr, lab, k=k, U=L, iters=4, seed=3, max_nodes=256, max_edges=4096)
    got = TL.lp_refine(gt, lab, k=k, U=L, iters=4, seed=3, max_nodes=256,
                       max_edges=4096, device="cpu")
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.moves == want.moves


def test_sweep_refine_numpy_matches_torch_sweep():
    """The numpy refine-sweep mirror is bit-identical to the torch sweep
    (refine mode, permuted chunks) — both sides of the port agree."""
    gr, _ = _graph("rmat")
    k, seed = 4, 21
    pack, lab, weights, nw, r, T = _sweep_inputs(gr, None, True, False, k, seed, pad=True)
    L = float(np.ceil(gr.nw.sum() / k) * 1.03)
    nchunks = pack.nodes.shape[0] // 2
    want_l, want_w = TL.sweep_refine_numpy(
        pack.nodes, pack.node_valid, pack.edge_dst, pack.edge_w, pack.edge_src_slot,
        pack.edge_valid, lab, weights, nw, L, seed, k, nchunks, 3,
    )
    ref_l, _ = RL.sweep_refine_numpy(
        pack.nodes, pack.node_valid, pack.edge_dst, pack.edge_w, pack.edge_src_slot,
        pack.edge_valid, lab, weights, nw, L, seed, k, nchunks, 3,
    )
    got = TL.lp_sweep(
        torch.from_numpy(pack.nodes).long(), torch.from_numpy(pack.node_valid),
        torch.from_numpy(pack.edge_dst).long(), torch.from_numpy(pack.edge_w),
        torch.from_numpy(pack.edge_src_slot).long(), torch.from_numpy(pack.edge_valid),
        torch.from_numpy(lab), torch.from_numpy(weights), torch.from_numpy(nw),
        torch.from_numpy(r), L, seed, k, nchunks,
        iters=3, refine_mode=True, use_restrict=False, permute_chunks=True,
    )
    np.testing.assert_array_equal(got[0].numpy(), want_l)
    np.testing.assert_array_equal(got[1].numpy(), want_w)
    np.testing.assert_array_equal(want_l, ref_l)


@pytest.mark.parametrize("refine", [False, True])
def test_sclap_numpy_matches_reference(refine):
    gr, gt = _graph("rmat")
    k = 4
    if refine:
        lab = np.random.default_rng(0).integers(0, k, gr.n)
        kw = dict(U=float(np.ceil(gr.n / k) * 1.03), refine_mode=True, num_labels=k)
    else:
        lab = np.arange(gr.n)
        kw = dict(U=40.0, restrict=np.arange(gr.n) % 3)
    want = RL.sclap_numpy(gr, lab, iters=2, seed=5, **kw)
    got = TL.sclap_numpy(gt, lab, iters=2, seed=5, **kw)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.moves == want.moves
