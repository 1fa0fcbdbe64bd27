"""Partition quality metrics: edge cut and balance (host numpy and torch)."""

from __future__ import annotations

import numpy as np
import torch

from ..graph.csr import GraphNP

__all__ = [
    "cut_np",
    "cut_from_arcs",
    "block_weights_np",
    "imbalance_np",
    "lmax",
]


def cut_from_arcs(labels: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  ew: torch.Tensor) -> torch.Tensor:
    """Edge cut from flat arc tensors (a 0-dim float32 tensor).  Trailing
    zero-weight arc padding is inert; for integral weights below 2^24 the
    float32 sum is exact in any order."""
    diff = labels[src] != labels[dst]
    return torch.sum(torch.where(diff, ew, 0.0)) / 2.0


def cut_np(g: GraphNP, labels: np.ndarray) -> float:
    """Total weight of edges between blocks (each undirected edge once)."""
    src = g.arc_sources()
    diff = labels[src] != labels[g.indices]
    return float(g.ew[diff].sum() / 2.0)


def block_weights_np(g: GraphNP, labels: np.ndarray, k: int) -> np.ndarray:
    return np.bincount(labels, weights=g.nw, minlength=k)[:k]


def lmax(total_weight: float, k: int, eps: float) -> float:
    """The balance bound L_max = (1 + eps) * ceil(c(V) / k)."""
    return (1.0 + eps) * np.ceil(total_weight / k)


def imbalance_np(g: GraphNP, labels: np.ndarray, k: int) -> float:
    """max_i c(V_i) * k / c(V) - 1  (0.0 == perfectly balanced)."""
    bw = block_weights_np(g, labels, k)
    return float(bw.max() * k / max(g.total_node_weight, 1e-12) - 1.0)

