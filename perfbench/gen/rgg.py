"""Random geometric graphs in the unit square, vectorised in torch: every
pair of points within ``radius`` is an edge (DIMACS rgg_n_2_X)."""

from __future__ import annotations

import math

import torch

OFFSETS = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]


def radius(n: int, coeff: float) -> float:
    return coeff * math.sqrt(math.log(n) / n)


def points(n: int, gen: torch.Generator, device) -> torch.Tensor:
    return torch.rand((n, 2), generator=gen, device=device, dtype=torch.float64)


def pairs(pts: torch.Tensor, r: float) -> tuple:
    """Every pair ``p < q`` with ``|pts[p] - pts[q]| <= r``, sorted: a grid
    of cells of side at least ``r``, each point against the nine cells
    around its own."""
    n = pts.shape[0]
    dev = pts.device
    G = max(1, int(1.0 / r))
    cx = torch.clamp((pts[:, 0] * G).to(torch.int64), max=G - 1)
    cy = torch.clamp((pts[:, 1] * G).to(torch.int64), max=G - 1)
    order = torch.argsort(cx * G + cy, stable=True)
    counts = torch.bincount(cx * G + cy, minlength=G * G)
    start = torch.cumsum(counts, 0) - counts
    ids = torch.arange(n, device=dev)
    keys = []
    for dx, dy in OFFSETS:
        nx, ny = cx + dx, cy + dy
        ok = (nx >= 0) & (nx < G) & (ny >= 0) & (ny < G)
        cell = torch.where(ok, nx * G + ny, 0)
        cnt = torch.where(ok, counts[cell], 0)
        total = int(cnt.sum())
        if total == 0:
            continue
        p = torch.repeat_interleave(ids, cnt)
        first = torch.cumsum(cnt, 0) - cnt
        slot = torch.arange(total, device=dev) - torch.repeat_interleave(first, cnt)
        q = order[start[cell][p] + slot]
        d2 = ((pts[p] - pts[q]) ** 2).sum(1)
        keep = (q > p) & (d2 <= r * r)
        keys.append(p[keep] * n + q[keep])
        del p, q, d2, keep, slot, first
    keys = torch.sort(torch.cat(keys)).values if keys else torch.zeros(0, dtype=torch.int64,
                                                                       device=dev)
    return keys // n, keys % n
