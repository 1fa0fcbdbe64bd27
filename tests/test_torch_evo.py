"""Port parity for the batched island GA: repro_torch's numpy oracle
(evolve_batched_numpy) and its batched torch GA (LPEngine.evolve_device on
the CPU) return the reference's evolve_oracle labels bit for bit, on the
cases of the reference's own GA tests; the batched chunk sweep and the
batched dense round match their one-row versions and the reference."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.label_propagation as RL
import repro.graph as R
from repro.core import LPEngine as RefEngine
from repro.core import initial_partition
from repro.core.evolutionary import EvoConfig as RefEvoConfig
from repro.core.metrics import cut_np, lmax
from repro.kernels.lp_score import dense_round_device_batched as ref_batched_round

import repro_torch.core.label_propagation as TL
from repro_torch.core import LPEngine
from repro_torch.core.evolutionary import EvoConfig
from repro_torch.graph import GraphDev, ell_pack, from_reference, pack_chunks, pad_pack
from repro_torch.kernels.lp_score import dense_round_device, dense_round_device_batched

torch.set_num_threads(1)


def _cfgs(k, L, I, P, G, seed, seeds=()):
    kw = dict(k=k, Lmax=L, islands=I, pop_per_island=P, generations=G,
              refine_iters=3, seed=seed, seed_individuals=list(seeds))
    return RefEvoConfig(**kw), EvoConfig(**kw)


def _port(gr):
    return from_reference(gr.indptr, gr.indices, gr.ew, gr.nw)


def _check_ga(gr, k, ref_cfg, cfg):
    """Reference oracle == port oracle == port batched GA on the CPU."""
    want = RefEngine(gr, seed=0).evolve_oracle(gr, ref_cfg)
    g = _port(gr)
    eng = LPEngine(g, seed=0, device="cpu")
    assert eng.can_evolve_device(g, k, cfg.islands, cfg.pop_per_island)
    np.testing.assert_array_equal(eng.evolve_oracle(g, cfg), want)
    got = eng.evolve_device(g, cfg)
    assert got.dtype == torch.int32 and got.shape == (g.n,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert eng.stats.evo_calls == 1 + cfg.generations
    return want


GA_CASES = [
    # (graph builder, k, islands, pop, generations)
    (lambda: R.planted_partition(700, 6, p_in=0.05, p_out=0.004, seed=1), 2, 2, 2, 3),
    (lambda: R.barabasi_albert(500, 4, seed=2), 4, 4, 3, 2),
    (lambda: R.planted_partition(300, 4, p_in=0.06, p_out=0.01, seed=3), 3, 1, 2, 2),
    (lambda: R.barabasi_albert(64, 3, seed=4), 2, 2, 1, 3),       # mutate-only
    (lambda: R.ring(300), 2, 1, 1, 0),     # deep graph: many growing rounds
]


@pytest.mark.parametrize("case", GA_CASES, ids=["planted700", "ba500", "planted300",
                                                "ba64-mutate", "ring300"])
def test_batched_ga_matches_reference_oracle(case):
    gbuild, k, I, P, G = case
    gr = gbuild()
    L = lmax(gr.n, k, 0.03)
    _check_ga(gr, k, *_cfgs(k, L, I, P, G, seed=11 + k))


def test_seeded_ga_matches_reference_and_never_worse_than_seed():
    """The projected V-cycle solution joins every island verbatim; the run
    still matches the reference, and the best is never worse than it."""
    gr = R.planted_partition(800, 6, p_in=0.05, p_out=0.003, seed=5)
    L = lmax(gr.n, 2, 0.03)
    seed_lab = initial_partition(gr, 2, L, seed=3).astype(np.int64)
    lab = _check_ga(gr, 2, *_cfgs(2, L, 2, 2, 3, seed=9, seeds=[seed_lab]))
    assert cut_np(gr, lab) <= cut_np(gr, seed_lab)


def test_resident_coarsest_graph_is_not_materialized():
    """A coarse GraphDev feeds the batched GA without ``to_host()``, and its
    result matches the reference's oracle on the reference's coarse graph."""
    gr = R.barabasi_albert(4096, 5, seed=1)
    L = lmax(gr.n, 2, 0.03)
    ref_cfg, cfg = _cfgs(2, L, 2, 2, 1, seed=3)
    reng = RefEngine(gr, seed=0)
    rdev, _ = reng.contract(gr, reng.cluster(gr, U=max(1.0, L / 14), iters=3, seed=7))
    want = reng.evolve_oracle(rdev, ref_cfg)

    g = _port(gr)
    eng = LPEngine(g, seed=0, device="cpu")
    cdev, _ = eng.contract(g, eng.cluster(g, U=max(1.0, L / 14), iters=3, seed=7))
    assert isinstance(cdev, GraphDev) and cdev.n == rdev.n
    got = eng.evolve_device(cdev, cfg)
    assert cdev._host is None
    np.testing.assert_array_equal(got.numpy(), want)


def test_non_integral_weights_fail_the_gate():
    gr = R.planted_partition(512, 4, p_in=0.05, p_out=0.01, seed=0)
    g = _port(gr)
    half = type(g)(indptr=g.indptr, indices=g.indices, ew=g.ew + np.float32(0.5), nw=g.nw)
    assert LPEngine(g, seed=0, device="cpu").can_evolve_device(g, 2, 2, 2)
    assert not LPEngine(half, seed=0, device="cpu").can_evolve_device(half, 2, 2, 2)
    gr2 = type(gr)(indptr=gr.indptr, indices=gr.indices, ew=gr.ew + np.float32(0.5), nw=gr.nw)
    assert not RefEngine(gr2, seed=0).can_evolve_device(gr2, 2, 2, 2)


@pytest.mark.parametrize("B", [1, 3])
def test_batched_sweep_rows_match_one_row_sweeps(B):
    """Row b of the batched sweep, with its own labels and seed, is the
    one-row sweep of that row and the reference's numpy refine sweep."""
    gr = R.planted_partition(600, 6, p_in=0.05, p_out=0.004, seed=1)
    g = _port(gr)
    n, k, Kb = g.n, 3, 4
    Ab = 1 << n.bit_length()
    L = float(np.float32(lmax(n, k, 0.03)))
    pack = pack_chunks(g, TL.make_order(g, "random", 0), max_nodes=128,
                       max_edges=2048, block=8)
    C0 = pack.nodes.shape[0]
    pack = pad_pack(pack, 1 << (C0 - 1).bit_length(), 128, pack.edge_dst.shape[1])
    rng = np.random.default_rng(0)
    labs = np.full((B, Ab), k, np.int32)
    labs[:, :n] = rng.integers(0, k, (B, n))
    nw = np.zeros(Ab, np.float32)
    nw[:n] = g.nw
    ws = np.full((B, Kb), np.inf, np.float32)
    for b in range(B):
        ws[b, :k] = np.bincount(labs[b, :n], weights=g.nw, minlength=k)
    seeds = [7, 12345, 2**31 - 1][:B]
    pt = [torch.from_numpy(a) for a in (pack.nodes, pack.node_valid, pack.edge_dst,
                                        pack.edge_w, pack.edge_src_slot, pack.edge_valid)]
    pt = [t.long() if t.dtype == torch.int32 else t for t in pt]
    dummy = torch.zeros(1, dtype=torch.int32)
    kw = dict(iters=3, refine_mode=True, use_restrict=False, permute_chunks=True)
    got_l, got_w, got_m = TL.lp_sweep_batched(
        *pt, torch.from_numpy(labs), torch.from_numpy(ws), torch.from_numpy(nw),
        dummy, L, seeds, k, pack.num_chunks, **kw,
    )
    assert got_l.shape == (B, Ab) and got_m.shape == (B,)
    for b in range(B):
        one = TL.lp_sweep(*pt, torch.from_numpy(labs[b]), torch.from_numpy(ws[b]),
                          torch.from_numpy(nw), dummy, L, seeds[b], k,
                          pack.num_chunks, **kw)
        assert torch.equal(got_l[b], one[0]) and torch.equal(got_w[b], one[1])
        assert int(got_m[b]) == int(one[2]) > 0
        want_l, want_w = RL.sweep_refine_numpy(
            pack.nodes, pack.node_valid, pack.edge_dst, pack.edge_w,
            pack.edge_src_slot, pack.edge_valid, labs[b], ws[b], nw, L, seeds[b],
            k, pack.num_chunks, 3,
        )
        np.testing.assert_array_equal(got_l[b].numpy(), want_l)
        np.testing.assert_array_equal(got_w[b].numpy(), want_w)


def test_batched_dense_round_matches_reference_and_rows():
    """One kernel launch scores every row; row b equals the one-row round
    with seed b and the reference's vmapped round (Pallas in interpret
    mode) on integral weights."""
    gr = R.rmat(9, 8, seed=7)
    g = _port(gr)
    k, B = 4, 3
    ell = ell_pack(g)
    nb = 1 << g.n.bit_length()
    rng = np.random.default_rng(2)
    labs = np.full((B, nb), k, np.int32)
    labs[:, : g.n] = rng.integers(0, k, (B, g.n))
    nw = np.zeros(nb, np.float32)
    nw[: g.n] = g.nw
    U = float(np.ceil(g.n / k) * 1.05)
    seeds = np.array([3, 17, 40000], np.int32)
    want = np.asarray(ref_batched_round(
        jnp.asarray(ell.dst), jnp.asarray(ell.w), jnp.asarray(ell.row_node),
        jnp.asarray(labs), jnp.asarray(nw), jnp.float32(U), jnp.asarray(seeds),
        jnp.float32(0.5), jnp.int32(g.n), k=k, use_pallas=True, interpret=True,
    ))
    ell_t = (torch.from_numpy(ell.dst).long(), torch.from_numpy(ell.w),
             torch.from_numpy(ell.row_node).long())
    got = dense_round_device_batched(
        *ell_t, torch.from_numpy(labs), torch.from_numpy(nw), U, seeds.tolist(),
        0.5, g.n, k=k,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(B):
        one = dense_round_device(*ell_t, torch.from_numpy(labs[b]), torch.from_numpy(nw),
                                 U, int(seeds[b]), 0.5, g.n, k=k)
        assert torch.equal(got[b], one)
    assert int((got.numpy() != labs).sum()) > 0
