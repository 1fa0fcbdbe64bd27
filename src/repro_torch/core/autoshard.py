"""Partitioner-guided sharding for an LM runtime (numpy copy of
``repro.core.autoshard``; a bridge beyond the paper): the graph being
partitioned is the model itself.

* :func:`expert_placement` — partition the expert co-activation graph
  (nodes = experts, edge weight = how often two experts are routed for the
  same token) into EP groups, so co-activated experts share a shard and the
  MoE all_to_all payload shrinks.
* :func:`pipeline_stages` — partition the layer chain (node weight =
  parameter bytes, edge weight = activation bytes) into balanced pipeline
  stages with little inter-stage traffic.

Both run ``partition(..., engine="numpy", preset="strong")`` (FM and the
host GA) and take the ``device`` that ``partition()`` resolves: CUDA unless
told otherwise.  ``examples/torch/autoshard_moe.py`` measures the
co-routing traffic reduction.
"""

from __future__ import annotations

import numpy as np

from ..graph.csr import from_edges
from .multilevel import PartitionerConfig, partition

__all__ = ["coactivation_graph", "expert_placement", "pipeline_stages",
           "crossgroup_traffic"]


def coactivation_graph(topi: np.ndarray, n_experts: int):
    """topi (T, k) expert indices per token -> weighted co-activation graph."""
    T, k = topi.shape
    u, v = [], []
    for i in range(k):
        for j in range(i + 1, k):
            u.append(topi[:, i])
            v.append(topi[:, j])
    u = np.concatenate(u)
    v = np.concatenate(v)
    return from_edges(n_experts, u.astype(np.int64), v.astype(np.int64))


def expert_placement(topi: np.ndarray, n_experts: int, n_groups: int,
                     eps: float = 0.0, seed: int = 0, *, device=None) -> np.ndarray:
    """Assign experts to EP groups minimizing cross-group co-activation
    (``partition()`` on ``device``: CUDA unless told otherwise)."""
    g = coactivation_graph(topi, n_experts)
    rep = partition(g, PartitionerConfig(
        k=n_groups, eps=max(eps, 1e-6), preset="strong", coarsest_factor=4,
        seed=seed, engine="numpy",
    ), device=device)
    return rep.labels


def crossgroup_traffic(topi: np.ndarray, placement: np.ndarray) -> float:
    """Fraction of token->expert assignments whose top-k set spans >1 group
    (each extra group = one extra all_to_all hop for that token)."""
    groups = placement[topi]  # (T, k)
    spans = np.array([np.unique(row).size for row in groups])
    return float((spans - 1).sum() / topi.shape[0])


def pipeline_stages(param_bytes: np.ndarray, act_bytes: np.ndarray,
                    n_stages: int, seed: int = 0, *, device=None) -> np.ndarray:
    """Partition the layer chain into contiguous-ish balanced stages
    (``partition()`` on ``device``: CUDA unless told otherwise).

    param_bytes: (L,) per-layer parameter bytes (node weights = memory).
    act_bytes:   (L-1,) activation bytes between consecutive layers.
    """
    L = param_bytes.shape[0]
    u = np.arange(L - 1, dtype=np.int64)
    g = from_edges(L, u, u + 1, w=act_bytes.astype(np.float32),
                   nw=param_bytes.astype(np.float32))
    rep = partition(g, PartitionerConfig(
        k=n_stages, eps=0.05, preset="strong", coarsest_factor=4, seed=seed,
        engine="numpy",
    ), device=device)
    return rep.labels
