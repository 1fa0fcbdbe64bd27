"""A configuration's graph: the family named in its file (``kron`` or
``rgg``), drawn from the file's ``graph_seed`` (one instance, as a published
graph is one file), made on the device in a few large calls.  ``kron`` is
Graph500's graph in the form LDBC Graphalytics publishes it: simple, and
without the ids that no edge touches.  :func:`renamed` gives the same graph
under another numbering of its nodes."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import kron, rgg
from .seeds import GRAPH, torch_generator


@dataclass
class BaseGraph:
    """The undirected simple edges ``lo < hi`` of a generated graph, on the
    device where they were made and on the host."""

    n: int
    lo: torch.Tensor
    hi: torch.Tensor
    lo_np: np.ndarray
    hi_np: np.ndarray

    @property
    def edges(self) -> int:
        return int(self.lo_np.shape[0])


def build(graph: dict, device) -> BaseGraph:
    gen = torch_generator(int(graph["graph_seed"]), GRAPH, 0, device)
    family = graph["family"]
    if family == "kron":
        n = 1 << int(graph["scale"])
        u, v = kron.kron_edges(int(graph["scale"]), int(graph["edge_factor"]),
                               float(graph["a"]), float(graph["b"]), float(graph["c"]),
                               gen, device)
        lo, hi = kron.simple_edges(n, u, v)
        del u, v
        n, lo, hi = kron.drop_isolated(n, lo, hi)
    elif family == "rgg":
        n = 1 << int(graph["scale"])
        pts = rgg.points(n, gen, device)
        lo, hi = rgg.pairs(pts, rgg.radius(n, float(graph["radius_coeff"])))
        del pts
    else:
        raise ValueError(f"unknown graph family {family!r}")
    return BaseGraph(n=n, lo=lo, hi=hi, lo_np=lo.cpu().numpy(), hi_np=hi.cpu().numpy())


def renamed(base: BaseGraph, perm: torch.Tensor) -> BaseGraph:
    """``base`` with node ``x`` called ``perm[x]``, edges again ``lo < hi``
    and sorted."""
    n = base.n
    a, b = perm[base.lo], perm[base.hi]
    keys = torch.sort(torch.minimum(a, b) * n + torch.maximum(a, b)).values
    lo, hi = keys // n, keys % n
    return BaseGraph(n=n, lo=lo, hi=hi, lo_np=lo.cpu().numpy(), hi_np=hi.cpu().numpy())
