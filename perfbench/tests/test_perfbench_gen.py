"""The generators against brute force at small scale."""

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _perfbench_tiny import SEED  # noqa: E402,F401  (puts the repo on sys.path)

import torch  # noqa: E402

from perfbench.gen import graphs, kron, rgg  # noqa: E402
from perfbench.gen.csr import csr_arrays  # noqa: E402
from perfbench.gen.seeds import GRAPH, derive, torch_generator  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def test_rgg_pairs_are_all_pairs_within_r():
    pts = rgg.points(600, torch_generator(7, GRAPH, 0, "cpu"), "cpu")
    r = rgg.radius(600, 0.55)
    lo, hi = rgg.pairs(pts, r)
    p = pts.numpy()
    want = {(i, j) for i, j in itertools.combinations(range(600), 2)
            if ((p[i] - p[j]) ** 2).sum() <= r * r}
    got = set(zip(lo.tolist(), hi.tolist()))
    assert got == want and len(lo) == len(want)
    assert (lo < hi).all()


def test_rgg_mean_degree_is_n_pi_r2():
    n = 1 << 14
    g = graphs.build(dict(family="rgg", scale=14, radius_coeff=0.55, graph_seed=SEED), "cpu")
    deg = 2 * g.edges / n
    r = rgg.radius(n, 0.55)
    assert abs(deg - n * np.pi * r * r) < 0.6      # the border loses a little


def test_kron_simple_matches_a_set_of_its_raw_edges():
    gen = torch_generator(11, GRAPH, 0, "cpu")
    u, v = kron.kron_edges(8, 8, 0.57, 0.19, 0.19, gen, "cpu")
    assert len(u) == 8 << 8 and int(u.max()) < 256 and int(v.max()) < 256
    lo, hi = kron.simple_edges(256, u, v)
    want = {(min(a, b), max(a, b)) for a, b in zip(u.tolist(), v.tolist()) if a != b}
    assert sorted(want) == list(zip(lo.tolist(), hi.tolist()))


def test_kron_quadrant_shares():
    gen = torch_generator(3, GRAPH, 0, "cpu")
    u, v = kron.kron_edges(1, 50000, 0.57, 0.19, 0.19, gen, "cpu")
    share = [float(((u == a) & (v == b)).float().mean()) for a, b in
             ((0, 0), (0, 1), (1, 0), (1, 1))]
    assert np.allclose(share, [0.57, 0.19, 0.19, 0.05], atol=0.01)


def test_drop_isolated_renumbers_in_order():
    lo, hi = torch.tensor([1, 1, 5]), torch.tensor([3, 5, 7])
    n, lo2, hi2 = kron.drop_isolated(9, lo, hi)
    assert n == 4
    assert lo2.tolist() == [0, 0, 2] and hi2.tolist() == [1, 2, 3]


def test_csr_is_the_symmetric_edge_set_under_the_renaming():
    lo, hi = torch.tensor([0, 0, 2, 1]), torch.tensor([1, 3, 3, 2])
    perm = torch.tensor([2, 0, 3, 1])
    a = csr_arrays(4, lo, hi, perm)
    src = np.repeat(np.arange(4), np.diff(a["indptr"]))
    got = sorted(zip(src.tolist(), a["indices"].tolist()))
    want = sorted({(int(perm[x]), int(perm[y])) for x, y in zip(lo, hi)}
                  | {(int(perm[y]), int(perm[x])) for x, y in zip(lo, hi)})
    assert got == want
    assert a["indices"].dtype == np.int32 and a["indptr"].dtype == np.int64
    assert (a["ew"] == 1).all() and a["nw"].shape == (4,)


@pytest.mark.parametrize("family", [dict(family="rgg", scale=10, radius_coeff=0.55),
                                    dict(family="kron", scale=9, edge_factor=16, a=0.57,
                                         b=0.19, c=0.19)])
def test_seeded_determinism_and_renaming(family):
    a = graphs.build(dict(family, graph_seed=SEED), "cpu")
    b = graphs.build(dict(family, graph_seed=SEED), "cpu")
    c = graphs.build(dict(family, graph_seed=SEED + 1), "cpu")
    assert a.n == b.n and np.array_equal(a.lo_np, b.lo_np) and np.array_equal(a.hi_np, b.hi_np)
    assert not (a.edges == c.edges and np.array_equal(a.lo_np, c.lo_np))
    perm = torch.randperm(a.n, generator=torch_generator(SEED, GRAPH, 1, "cpu"))
    r = graphs.renamed(a, perm)
    p = perm.numpy()
    want = sorted((min(p[x], p[y]), max(p[x], p[y])) for x, y in zip(a.lo_np, a.hi_np))
    assert list(zip(r.lo_np.tolist(), r.hi_np.tolist())) == want


def test_seeds_take_large_values_and_differ_by_purpose():
    s = [derive(2**40 + 5, p, i) for p in range(3) for i in range(3)]
    assert len(set(s)) == 9 and all(0 <= x < 2**63 for x in s)
    with pytest.raises(ValueError):
        derive(-1, 0)
