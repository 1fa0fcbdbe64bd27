"""The final balance repair on a device arena: the prelude in torch ops
(:func:`walk_inputs`), then the walk
(:func:`~repro_torch.kernels.balance.walk.repair_balance_walk`: the kernel
on the card, its plain version on the CPU)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .walk import repair_balance_walk

__all__ = ["repair_balance_device", "walk_inputs"]


def walk_inputs(labels: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                ew: torch.Tensor, nw: torch.Tensor, n: int, k: int,
                L: float) -> Optional[Tuple[torch.Tensor, ...]]:
    """The prelude of :func:`repair_balance_device` on the same arguments:
    ``None`` when no block is above ``L`` (the host returns the labels
    unchanged), else the walk's inputs ``(cand, cand_lab, cand_nw, bw)``:
    the nodes of the blocks above ``L`` in the host's order (a stable sort
    by internal connection), their blocks and weights, and the (k,) float64
    block weights."""
    idx = torch.clamp(labels, max=k).to(torch.int64)
    bw = torch.zeros(k + 1, dtype=torch.float64, device=labels.device).index_add_(
        0, idx, nw.to(torch.float64))
    over = bw > L
    over[k] = False
    if not bool(over.any()):
        return None
    # each node's weight of arcs inside its block; cheapest to move first
    same = labels[src] == labels[dst]
    internal = torch.zeros(labels.shape[0], dtype=torch.float32,
                           device=labels.device).index_add_(
        0, src, torch.where(same, ew, 0.0))
    order = torch.sort(internal[:n], stable=True).indices
    # a block at or below L at the start only takes moves that keep it there,
    # so its nodes are never moved: the walk skips them up front
    cand = order[over[idx[order]]]
    return cand, labels[cand], nw[cand], bw[:k].contiguous()


def repair_balance_device(labels: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                          ew: torch.Tensor, nw: torch.Tensor, n: int, k: int,
                          L: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`repro_torch.core.initial_partition.repair_balance` on arena
    tensors: ``labels`` (A,) int32 (labels in [0, k) below ``n``, k beyond),
    the arcs ``src``/``dst``/``ew`` (zero-weight padding is inert) and ``nw``
    (A,) float32, 0 beyond ``n``.

    Returns new arena labels and the number of nodes moved (an int64 scalar
    tensor); feasible input returns ``labels`` itself.  The labels equal the
    host's whenever every per-node internal connection is exact in float32
    (integral edge weights summing below 2^24): the block weights are
    float64, and the order is a stable sort of the same values.
    """
    inputs = walk_inputs(labels, src, dst, ew, nw, n, k, L)
    if inputs is None:
        return labels, torch.zeros((), dtype=torch.int64, device=labels.device)
    cand, cand_lab, cand_nw, bw = inputs
    return repair_balance_walk(cand, cand_lab, cand_nw, labels, bw, float(L))
