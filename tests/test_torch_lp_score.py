"""Port parity for the dense refinement: the plain lp_score_rows against the
Pallas kernel (interpret mode), node scores, eligibility, the threefry
draws against jax.random, and whole dense rounds against the JAX round.
The kernel itself is tested on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.graph as R
from repro.kernels.lp_score import dense_eligibility as ref_eligibility
from repro.kernels.lp_score import dense_round_device as ref_round
from repro.kernels.lp_score import lp_score_rows as ref_kernel
from repro.kernels.lp_score import node_scores as ref_node_scores

from repro_torch.graph import ell_pack, from_reference
from repro_torch.kernels.lp_score import (
    dense_eligibility,
    dense_round_device,
    lp_refine_dense_round,
    lp_score_rows,
    lp_score_rows_ref,
    node_scores,
    node_scores_ref,
)
from repro_torch.kernels.lp_score import threefry

torch.set_num_threads(1)


@pytest.mark.parametrize("weights", ["integral", "float"])
@pytest.mark.parametrize("k", [2, 5, 17])
def test_plain_rows_match_pallas_kernel(weights, k):
    rng = np.random.default_rng(k)
    R_, W = 512, 128
    lbl = rng.integers(-1, k + 3, (R_, W)).astype(np.int32)
    w = (rng.integers(0, 5, (R_, W)) if weights == "integral"
         else rng.random((R_, W))).astype(np.float32)
    want = np.asarray(ref_kernel(jnp.asarray(lbl), jnp.asarray(w), k_pad=128,
                                 interpret=True))[:, :k]
    got = lp_score_rows_ref(torch.from_numpy(lbl), torch.from_numpy(w), k).numpy()
    # the CPU wrapper is the plain version
    np.testing.assert_array_equal(lp_score_rows(torch.from_numpy(lbl),
                                                torch.from_numpy(w), k).numpy(), got)
    if weights == "integral":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("case,k", [("rmat", 4), ("star", 3), ("mesh", 8)])
def test_node_scores_match(case, k):
    gr = {"rmat": lambda: R.rmat(9, 8, seed=1), "star": lambda: R.star(700),
          "mesh": lambda: R.mesh2d(24)}[case]()
    g = from_reference(gr.indptr, gr.indices, gr.ew, gr.nw)
    labels = np.random.default_rng(0).integers(0, k, g.n).astype(np.int32)
    S = node_scores(g, labels, k, device="cpu").numpy()
    S_ref = node_scores_ref(
        torch.from_numpy(g.indptr), torch.from_numpy(g.indices).long(),
        torch.from_numpy(g.ew), torch.from_numpy(labels), k,
    ).numpy()
    np.testing.assert_array_equal(S, S_ref)
    np.testing.assert_array_equal(
        S, np.asarray(ref_node_scores(gr, labels, k, use_pallas=False))
    )


def test_dense_eligibility_matches():
    gr = R.rmat(9, 8, seed=5)
    k = 4
    rng = np.random.default_rng(3)
    lab = np.where(rng.random(gr.n) < 0.55, 0, rng.integers(0, k, gr.n)).astype(np.int32)
    bw = np.bincount(lab, weights=gr.nw, minlength=k)[:k].astype(np.float32)
    U = float(np.sort(bw)[-2] + 1.0)   # biggest block overloaded
    S = np.asarray(ref_node_scores(gr, lab, k, use_pallas=False))
    want = np.asarray(ref_eligibility(jnp.asarray(S), jnp.asarray(lab), jnp.asarray(bw),
                                      jnp.asarray(gr.nw), jnp.float32(U), k))
    got = dense_eligibility(torch.tensor(S), torch.from_numpy(lab).long(),
                            torch.from_numpy(bw), torch.from_numpy(gr.nw),
                            torch.tensor(U, dtype=torch.float32), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("seed", [0, 1, 0x9E37, 123456789, 2**31 - 1])
def test_threefry_matches_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    tk = threefry.prng_key(seed)
    assert tuple(int(x) for x in jax.random.key_data(key)) == tk
    for d in (1, 2, 77):
        want = tuple(int(x) for x in jax.random.key_data(jax.random.fold_in(key, d)))
        assert threefry.fold_in(tk, d) == want
    for kk, shape in ((key, (7,)), (key, (33, 5)), (jax.random.fold_in(key, 2), (1000,))):
        k_t = tuple(int(x) for x in jax.random.key_data(kk))
        want = np.asarray(jax.random.uniform(kk, shape))
        got = threefry.uniform(k_t, shape, "cpu").numpy()
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_dense_round_matches_jax_round():
    """Whole dense rounds (kernel scores, eligibility, jittered argmax and the
    three threefry gates) give the JAX round's labels on integral weights."""
    gr = R.rmat(9, 8, seed=7)
    g = from_reference(gr.indptr, gr.indices, gr.ew, gr.nw)
    k = 4
    ell = ell_pack(g)
    rng = np.random.default_rng(1)
    nb = 1 << g.n.bit_length()          # pow2(n + 1) node bucket
    lab = np.full(nb, k, np.int32)
    lab[: g.n] = np.where(rng.random(g.n) < 0.4, 0, rng.integers(0, k, g.n))
    nw = np.zeros(nb, np.float32)
    nw[: g.n] = g.nw
    U = float(np.ceil(g.n / k) * 1.05)
    moved = 0
    for seed in (3, 17, 40000):
        want = np.asarray(ref_round(
            jnp.asarray(ell.dst), jnp.asarray(ell.w), jnp.asarray(ell.row_node),
            jnp.asarray(lab), jnp.asarray(nw), jnp.float32(U), jnp.int32(seed),
            jnp.float32(0.5), jnp.int32(g.n), k=k, use_pallas=True, interpret=True,
        ))
        got = dense_round_device(
            torch.from_numpy(ell.dst).long(), torch.from_numpy(ell.w),
            torch.from_numpy(ell.row_node).long(), torch.from_numpy(lab),
            torch.from_numpy(nw), U, seed, 0.5, g.n, k=k,
        ).numpy()
        np.testing.assert_array_equal(got, want)
        moved += int((got != lab).sum())
        lab = got
    assert moved > 0


def test_dense_rounds_converge():
    side = 32
    gr = R.mesh2d(side)
    g = from_reference(gr.indptr, gr.indices, gr.ew, gr.nw)
    truth = (np.arange(g.n) // side >= side // 2).astype(np.int32)
    lab = truth.copy()
    lab[np.random.default_rng(2).random(g.n) < 0.15] ^= 1
    L = float(np.ceil(g.n / 2) * 1.03)
    before = int((lab != truth).sum())
    for r in range(8):
        lab = lp_refine_dense_round(g, lab, 2, L, seed=r, device="cpu")
    assert int((lab != truth).sum()) < before / 3
