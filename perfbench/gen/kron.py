"""Graph500's Kronecker generator, vectorised in torch, and the clean-up of
LDBC Graphalytics' ``graph500-*`` graphs: self-loops dropped, parallel
edges merged into one edge of weight 1, ids without an edge removed."""

from __future__ import annotations

import torch


def kron_edges(scale: int, edge_factor: int, a: float, b: float, c: float,
               gen: torch.Generator, device) -> tuple:
    """``edge_factor * 2**scale`` directed edges ``(u, v)`` as Graph500 draws
    them: at every bit an independent quadrant pick with probabilities
    ``a, b, c, 1 - a - b - c`` (the specification's two draws per bit)."""
    E = int(edge_factor) << int(scale)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    u = torch.zeros(E, dtype=torch.int64, device=device)
    v = torch.zeros(E, dtype=torch.int64, device=device)
    for bit in range(scale):
        r1 = torch.rand(E, generator=gen, device=device, dtype=torch.float64)
        r2 = torch.rand(E, generator=gen, device=device, dtype=torch.float64)
        ii = r1 > ab
        jj = r2 > torch.where(ii, c_norm, a_norm)
        u |= ii.to(torch.int64) << bit
        v |= jj.to(torch.int64) << bit
    return u, v


def simple_edges(n: int, u: torch.Tensor, v: torch.Tensor) -> tuple:
    """Undirected simple edges ``lo < hi``, sorted, each once."""
    keep = u != v
    lo = torch.minimum(u[keep], v[keep])
    hi = torch.maximum(u[keep], v[keep])
    keys = torch.unique(lo * n + hi)
    return keys // n, keys % n


def drop_isolated(n: int, lo: torch.Tensor, hi: torch.Tensor) -> tuple:
    """Renumber the ids that have an edge as ``0 .. n' - 1`` in order;
    returns ``(n', lo', hi')``."""
    present = torch.zeros(n, dtype=torch.bool, device=lo.device)
    present[lo] = True
    present[hi] = True
    new_id = torch.cumsum(present.to(torch.int64), 0) - 1
    return int(present.sum()), new_id[lo], new_id[hi]
