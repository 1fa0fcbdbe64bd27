"""Partition quality metrics: edge cut, balance, quotient graph and
communication volume (host numpy and torch)."""

from __future__ import annotations

import numpy as np
import torch

from ..graph.csr import GraphNP

__all__ = [
    "cut_np",
    "cut_from_arcs",
    "block_weights_dense",
    "block_weights_np",
    "imbalance_np",
    "is_feasible",
    "lmax",
    "quotient_graph_np",
    "comm_volume_np",
]


def cut_from_arcs(labels: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  ew: torch.Tensor) -> torch.Tensor:
    """Edge cut from flat arc tensors: float32, one per label row (``labels``
    is ``(A,)`` or ``(B, A)``; the arc tensors are ``(M,)``, shared by every
    row, or ``(B, M)``, one arc set per row).  Trailing zero-weight arc
    padding is inert; for integral weights below 2^24 the float32 sum is
    exact in any order."""
    shape = labels.shape[:-1] + src.shape[-1:]
    diff = labels.gather(-1, src.expand(shape)) != labels.gather(-1, dst.expand(shape))
    return torch.sum(torch.where(diff, ew, 0.0), dim=-1) / 2.0


def block_weights_dense(labels: torch.Tensor, nw: torch.Tensor, Kb: int) -> torch.Tensor:
    """``(..., Kb)`` block weights of arena labels (``(A,)`` or ``(B, A)``,
    values in ``[0, Kb)``): slots at and beyond ``k`` collect the arena's
    sentinel label with weight 0.  Returns the raw sums; callers mask or
    +inf-pad the dead slots."""
    out = torch.zeros(labels.shape[:-1] + (Kb,), dtype=torch.float32,
                      device=labels.device)
    return out.scatter_add_(-1, labels.to(torch.int64), nw.expand(labels.shape))


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


def is_feasible(g: GraphNP, labels: np.ndarray, k: int, eps: float) -> bool:
    bw = block_weights_np(g, labels, k)
    return bool(bw.max() <= lmax(g.total_node_weight, k, eps) + 1e-6)


def quotient_graph_np(g: GraphNP, labels: np.ndarray, k: int):
    """Weighted quotient graph: (k,k) dense inter-block weight matrix + block weights."""
    src = g.arc_sources()
    dst = g.indices
    q = np.zeros((k, k), dtype=np.float64)
    np.add.at(q, (labels[src], labels[dst]), g.ew)
    np.fill_diagonal(q, 0.0)
    return q / 2.0, block_weights_np(g, labels, k)


def comm_volume_np(g: GraphNP, labels: np.ndarray, k: int) -> float:
    """Total communication volume: sum over v of #distinct foreign blocks adjacent."""
    src = g.arc_sources().astype(np.int64)
    dst_lbl = labels[g.indices].astype(np.int64)
    key = src * np.int64(k + 1) + dst_lbl
    uniq = np.unique(key)
    usrc = uniq // (k + 1)
    ulbl = uniq % (k + 1)
    return float((ulbl != labels[usrc]).sum())
