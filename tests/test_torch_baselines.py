"""Port parity of the paper's baselines and quality tools: rgg, the hash and
random baselines, the heavy-edge-matching multilevel (the ParMetis
stand-in), modularity clustering, the initial-partition helpers, the
quotient-graph metrics, pad_k and the partitioner-guided autoshard.  The
same seeded inputs go to the reference (``repro``) and to the port
(``repro_torch``, on the CPU); every result is equal bit for bit
(``seconds`` aside)."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import repro.core as RC
import repro.core.autoshard as RA
import repro.graph as RG
import repro_torch.core as PC
import repro_torch.core.autoshard as PA
import repro_torch.graph as PG
from repro.kernels.lp_score import pad_k as ref_pad_k
from repro_torch.graph import from_reference
from repro_torch.kernels.lp_score import pad_k

torch.set_num_threads(1)

# the packages export functions named like these modules
RI = importlib.import_module("repro.core.initial_partition")
RM = importlib.import_module("repro.core.modularity")
PI = importlib.import_module("repro_torch.core.initial_partition")
PM = importlib.import_module("repro_torch.core.modularity")

_CSR = ("indptr", "indices", "ew", "nw")


def _port(g):
    return from_reference(g.indptr, g.indices, g.ew, g.nw)


def _same_arrays(a, b):
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype


@pytest.mark.parametrize("scale", [10, 11, 12])
def test_rgg_matches_reference(scale):
    want, got = RG.rgg(scale, seed=scale), PG.rgg(scale, seed=scale)
    for f in _CSR:
        _same_arrays(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("n,k", [(1, 1), (1000, 2), (4097, 7), (65536, 16), (3, 64)])
def test_hash_and_random_balanced_match_reference(n, k):
    _same_arrays(PC.hash_partition(n, k), RC.hash_partition(n, k))
    for seed in (0, 3):
        _same_arrays(PC.random_balanced(n, k, seed=seed),
                     RC.random_balanced(n, k, seed=seed))


_MATCHING_GRAPHS = {
    "rgg11": lambda: RG.rgg(11, seed=1),
    "ba2048": lambda: RG.barabasi_albert(2048, 6),
    "rmat10": lambda: RG.rmat(10, 8),
}


@pytest.mark.parametrize("case", list(_MATCHING_GRAPHS))
@pytest.mark.parametrize("k", [2, 4])
def test_matching_multilevel_matches_reference(case, k):
    g = _MATCHING_GRAPHS[case]()
    want = RC.matching_multilevel(g, k, seed=0)
    got = PC.matching_multilevel(_port(g), k, seed=0, device="cpu")
    assert isinstance(got, PC.BaselineReport)
    _same_arrays(got.labels, want.labels)
    for f in dataclasses.fields(want):
        if f.name not in ("labels", "seconds"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name


_MOD_GRAPHS = {
    "pp2048": lambda: RG.planted_partition(2048, 8, p_in=0.03, p_out=0.0005, seed=0),
    "ba1024": lambda: RG.barabasi_albert(1024, 6, seed=0),
}


@pytest.mark.parametrize("case", list(_MOD_GRAPHS))
def test_modularity_matches_reference(case):
    g = _MOD_GRAPHS[case]()
    rng = np.random.default_rng(1)
    for lab in (rng.integers(0, 16, g.n), np.arange(g.n), np.zeros(g.n, np.int64)):
        assert PM.modularity(_port(g), lab) == RM.modularity(g, lab)
    lab0 = rng.integers(0, 32, g.n)
    _same_arrays(PM.modularity_lp(_port(g), lab0, iters=3, seed=5),
                 RM.modularity_lp(g, lab0, iters=3, seed=5))
    want_lab, want_q = RC.louvain(g, seed=0)
    got_lab, got_q = PC.louvain(_port(g), seed=0)
    _same_arrays(got_lab, want_lab)
    assert got_q == want_q


def test_initial_partition_and_best_of_match_reference():
    from repro.core.metrics import lmax

    g = RG.barabasi_albert(600, 4, seed=2)
    k = 4
    L = lmax(g.total_node_weight, k, 0.03)
    cands = []
    for seed in range(2):
        want = RI.initial_partition(g, k, L, seed=seed)
        got = PI.initial_partition(_port(g), k, L, seed=seed)
        _same_arrays(got, want)
        cands.append(want)
    # an infeasible candidate with a smaller cut is passed over
    cands.append(np.zeros(g.n, np.int32))
    _same_arrays(PI.best_of(_port(g), cands, k, L), RI.best_of(g, cands, k, L))
    assert PI.best_of(_port(g), cands[-1:], k, L) is cands[-1]


def test_metrics_match_reference():
    import repro.core.metrics as RMe
    import repro_torch.core.metrics as PMe

    g = RG.rmat(9, 8, seed=3)
    rng = np.random.default_rng(0)
    for k in (2, 5):
        for lab in (rng.integers(0, k, g.n).astype(np.int32),
                    RC.hash_partition(g.n, k)):
            for eps in (0.0, 0.03, 1.0):
                assert (PMe.is_feasible(_port(g), lab, k, eps)
                        == RMe.is_feasible(g, lab, k, eps))
            (q_w, bw_w), (q_g, bw_g) = (RMe.quotient_graph_np(g, lab, k),
                                        PMe.quotient_graph_np(_port(g), lab, k))
            _same_arrays(q_g, q_w)
            _same_arrays(bw_g, bw_w)
            assert (PMe.comm_volume_np(_port(g), lab, k)
                    == RMe.comm_volume_np(g, lab, k))


def test_pad_k_matches_reference():
    assert pad_k(2) == 128 and pad_k(128) == 128 and pad_k(129) == 256
    for k in (1, 2, 127, 128, 129, 255, 256, 1000):
        assert pad_k(k) == ref_pad_k(k)


def _team_router(E=16, k=4, T=4000, teams=4, seed=0):
    """The reference autoshard tests' correlated router."""
    rng = np.random.default_rng(seed)
    team_of = rng.permutation(E).reshape(teams, E // teams)
    topi = np.zeros((T, k), dtype=np.int64)
    for t in range(T):
        team = team_of[rng.integers(teams)]
        picks = rng.choice(team, size=min(k, 3), replace=False)
        rest = rng.integers(0, E, k - picks.size)
        topi[t] = np.concatenate([picks, rest])
    return topi


def test_coactivation_graph_and_traffic_match_reference():
    topi = _team_router()
    want, got = RA.coactivation_graph(topi, 16), PA.coactivation_graph(topi, 16)
    for f in _CSR:
        _same_arrays(getattr(got, f), getattr(want, f))
    place = np.arange(16) // 4
    assert PA.crossgroup_traffic(topi, place) == RA.crossgroup_traffic(topi, place)


def test_expert_placement_matches_reference():
    """partition(engine="numpy", preset="strong"): FM and the host GA, on
    the 16-expert graph (no coarsening: it is its own coarsest level)."""
    topi = _team_router()
    want = RA.expert_placement(topi, 16, 4, seed=0)
    got = PA.expert_placement(topi, 16, 4, seed=0, device="cpu")
    _same_arrays(got, want)
    assert PA.crossgroup_traffic(topi, got) == RA.crossgroup_traffic(topi, want)


def test_pipeline_stages_matches_reference():
    """The same configuration on the 48-layer chain, which coarsens."""
    pb, ab = np.ones(48) * 100.0, np.ones(47) * 10.0
    _same_arrays(PA.pipeline_stages(pb, ab, 4, seed=0, device="cpu"),
                 RA.pipeline_stages(pb, ab, 4, seed=0))


def test_device_entry_points_need_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    g = PG.mesh2d(8)
    topi = _team_router(T=200)
    with pytest.raises(RuntimeError, match="CUDA"):
        PC.matching_multilevel(g, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        PA.expert_placement(topi, 16, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        PA.pipeline_stages(np.ones(8), np.ones(7), 2)
    assert PC.matching_multilevel(g, 2, device="cpu").labels.shape == (g.n,)
