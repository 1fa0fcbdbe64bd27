"""Inputs of the final balance repair's tests (the CPU twin in
``test_torch_finish.py``, the kernel in ``test_torch_cuda.py``): a graph,
labels with overloaded blocks, k and L.  Imports neither jax nor the
reference package."""

import numpy as np

from repro_torch.core.metrics import lmax
from repro_torch.graph import mesh2d, rmat
from repro_torch.graph.csr import GraphNP


def _overload(g, k, shares, seed=0):
    """Uniform labels, then each (block, share) pair pulls that share of
    the nodes into the block."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, k, g.n).astype(np.int32)
    u = rng.random(g.n)
    lo = 0.0
    for b, share in shares:
        lab[(u >= lo) & (u < lo + share)] = b
        lo += share
    return lab


def _heavy(g, seed=0):
    """``g`` with 5 % of its nodes at integral weights in [2, 200], the rest
    at 1: late in the walk the lightest block no longer fits a heavy node,
    which is skipped."""
    rng = np.random.default_rng(seed)
    nw = np.ones(g.n, np.float32)
    heavy = rng.random(g.n) < 0.05
    nw[heavy] = rng.integers(2, 201, int(heavy.sum()))
    return GraphNP(indptr=g.indptr, indices=g.indices, ew=g.ew, nw=nw)


def _giant(g):
    """``g`` with node 0 at weight 5000, above L: its block stays above L,
    so the walk runs through every candidate without stopping early."""
    nw = np.ones(g.n, np.float32)
    nw[0] = 5000
    return GraphNP(indptr=g.indptr, indices=g.indices, ew=g.ew, nw=nw)


# name -> (graph, k, [(block, share)]): one block at ~10x L, two blocks,
# k = 2 and 64, heavy nodes, a block that cannot get below L, many ties,
# an already feasible input; k = 8192 and 40,000 (L = 1.03: one node a
# block), whose block weights need the H100's opt-in shared memory and
# outgrow it
CASES = {
    "rmat-k16-one-10x": (lambda: rmat(12, 8, seed=1), 16, [(3, 0.64)]),
    "mesh-k16-one-10x": (lambda: mesh2d(64), 16, [(0, 0.64)]),
    "rmat-k16-two": (lambda: rmat(12, 8, seed=2), 16, [(0, 0.3), (5, 0.2)]),
    "rmat-k2": (lambda: rmat(12, 8, seed=3), 2, [(1, 0.8)]),
    "rmat-k64-10x": (lambda: rmat(12, 8, seed=4), 64, [(7, 0.16)]),
    "rmat-k16-heavy": (lambda: _heavy(rmat(12, 8, seed=5)), 16, [(2, 0.5)]),
    "rmat-k16-giant": (lambda: _giant(rmat(12, 8, seed=7)), 16, [(4, 0.3)]),
    "mesh-k64-ties": (lambda: mesh2d(64), 64, [(0, 0.3)]),
    "rmat-k16-feasible": (lambda: rmat(12, 8, seed=6), 16, None),
    "rmat-k8192": (lambda: rmat(12, 8, seed=8), 8192, [(0, 0.5)]),
    "rmat-k40000": (lambda: rmat(12, 8, seed=9), 40000, [(3, 0.5)]),
}


def make_case(name):
    """(graph, int32 labels, k, L) of a case; a feasible case's labels are
    ``arange(n) % k``."""
    build, k, shares = CASES[name]
    g = build()
    lab = (np.arange(g.n) % k).astype(np.int32) if shares is None else _overload(g, k, shares)
    return g, lab, k, lmax(g.total_node_weight, k, 0.03)


def kron19_case():
    """A kron19-sized input (rmat(19, 16), k = 16) whose repair moves ~70 %
    of the nodes, as the first V-cycle's finish does on the benchmark's
    Kronecker graph."""
    g = rmat(19, 16, seed=1)
    k = 16
    return g, _overload(g, k, [(0, 0.74)]), k, lmax(g.total_node_weight, k, 0.03)
