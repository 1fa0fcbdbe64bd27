"""Synthetic graph families (numpy copy of ``repro.graph.generators``).

Each generator draws from ``np.random.default_rng(seed)`` in the same order
as the reference, so it returns byte-identical arrays for the same seed:

* :func:`mesh2d` — triangulated regular grid (Delaunay-family stand-in);
* :func:`rmat` — Kronecker/R-MAT graph (web-graph stand-in);
* :func:`barabasi_albert` — preferential attachment (social networks);
* :func:`planted_partition` — stochastic block model with known communities;
* :func:`ring`, :func:`star` — degenerate shapes for tests.
"""

from __future__ import annotations

import numpy as np

from .csr import GraphNP, from_edges

__all__ = [
    "mesh2d",
    "rmat",
    "barabasi_albert",
    "planted_partition",
    "ring",
    "star",
]


def mesh2d(side: int) -> GraphNP:
    """Triangulated ``side x side`` grid: E and S neighbours plus the SE
    diagonal of every node."""
    idx = np.arange(side * side, dtype=np.int64).reshape(side, side)
    e = [
        (idx[:, :-1].ravel(), idx[:, 1:].ravel()),  # east
        (idx[:-1, :].ravel(), idx[1:, :].ravel()),  # south
        (idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()),  # south-east diagonal
    ]
    u = np.concatenate([a for a, _ in e])
    v = np.concatenate([b for _, b in e])
    return from_edges(side * side, u, v)


def rmat(
    scale: int,
    edge_factor: int = 8,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> GraphNP:
    """R-MAT graph with ``2**scale`` nodes (Graph500 parameters)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    u = np.zeros(m, dtype=np.int64)
    v = np.zeros(m, dtype=np.int64)
    ab = a + b
    a_norm = a / ab if ab > 0 else 0.5
    c_norm = c / (1.0 - ab) if ab < 1 else 0.5
    for _ in range(scale):
        u <<= 1
        v <<= 1
        go_down = rng.random(m) >= ab  # 1 => lower half for u-bit
        r2 = rng.random(m)
        u |= go_down.astype(np.int64)
        v |= np.where(go_down, r2 >= c_norm, r2 >= a_norm).astype(np.int64)
    # permute IDs so degree is not correlated with node id
    perm = rng.permutation(n)
    return from_edges(n, perm[u], perm[v])


def barabasi_albert(n: int, m_attach: int = 4, seed: int = 0) -> GraphNP:
    """Preferential-attachment graph: nodes arrive in geometric batches and
    attach to endpoints sampled from the edge list before the batch."""
    rng = np.random.default_rng(seed)
    n0 = max(m_attach + 1, 8)
    core_u, core_v = np.triu_indices(n0, k=1)
    targets = np.concatenate([core_u, core_v]).astype(np.int64)
    us = [core_u.astype(np.int64)]
    vs = [core_v.astype(np.int64)]
    cur = n0
    while cur < n:
        batch = min(max(64, cur // 4), n - cur)
        new_nodes = np.repeat(np.arange(cur, cur + batch, dtype=np.int64), m_attach)
        picked = targets[rng.integers(0, targets.shape[0], new_nodes.shape[0])]
        us.append(new_nodes)
        vs.append(picked)
        targets = np.concatenate([targets, new_nodes, picked])
        cur += batch
    u = np.concatenate(us)
    v = np.concatenate(vs)
    perm = rng.permutation(n).astype(np.int64)
    return from_edges(n, perm[u], perm[v])


def planted_partition(
    n: int,
    k: int,
    p_in: float = 0.02,
    p_out: float = 0.0005,
    seed: int = 0,
) -> GraphNP:
    """Stochastic block model with k equal communities (known ground truth)."""
    rng = np.random.default_rng(seed)
    comm = np.arange(n, dtype=np.int64) % k
    m_in = int(p_in * n * (n / k) / 2)
    m_out = int(p_out * n * n * (k - 1) / k / 2)
    ui = rng.integers(0, n, m_in * 2)
    vi_off = rng.integers(1, max(2, n // k), m_in * 2)
    vi = (ui + vi_off * k) % n  # same community (ids are mod-k striped)
    uo = rng.integers(0, n, m_out * 2)
    vo = rng.integers(0, n, m_out * 2)
    diff = comm[uo] != comm[vo]
    u = np.concatenate([ui, uo[diff]])
    v = np.concatenate([vi, vo[diff]])
    perm = rng.permutation(n).astype(np.int64)
    return from_edges(n, perm[u], perm[v])


def ring(n: int) -> GraphNP:
    u = np.arange(n, dtype=np.int64)
    return from_edges(n, u, (u + 1) % n)


def star(n: int) -> GraphNP:
    u = np.zeros(n - 1, dtype=np.int64)
    return from_edges(n, u, np.arange(1, n, dtype=np.int64))
