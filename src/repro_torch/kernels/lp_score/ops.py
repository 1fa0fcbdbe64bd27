"""Dense refinement around the lp_score kernel: node-level block scores and
one synchronous dense LP round (torch twin of ``repro.kernels.lp_score.ops``).

The label gather ``lab_pad[ell_dst]`` and the row -> node segment sum stay
torch ops around the kernel, as the reference keeps them XLA ops around
its Pallas call.  The round's three random gates come from
:mod:`.threefry`, bit-identical to the reference's ``jax.random`` draws.
All shapes are *bucket* shapes (pow2 rows, pow2 node count); ``n`` is the
live node count.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...device import resolve_device
from ...graph.csr import GraphNP
from ...graph.packing import EllPack, ell_pack
from . import threefry
from .lp_score import lp_score_rows

__all__ = [
    "node_scores",
    "lp_refine_dense_round",
    "dense_round_device",
    "dense_eligibility",
]


def _row_scores(ell_dst, ell_w, row_node, lab_pad, n: int, *, k: int):
    """ELL row scores segment-summed into (nb, k) node scores.

    ``lab_pad`` has ``nb >= n + 1`` entries with label ``k`` beyond ``n``,
    so sentinel destinations contribute nothing; rows owned by sentinel
    nodes go to a dropped slot."""
    nb = lab_pad.shape[0]
    row_scores = lp_score_rows(lab_pad[ell_dst], ell_w, k)
    seg = torch.where(row_node >= n, nb, row_node)
    out = torch.zeros((nb + 1, k), dtype=torch.float32, device=lab_pad.device)
    return out.index_add_(0, seg, row_scores)[:nb]


def _ell_tensors(ell: EllPack, dev: torch.device):
    return (
        torch.from_numpy(ell.dst).to(device=dev, dtype=torch.int64),
        torch.from_numpy(ell.w).to(dev),
        torch.from_numpy(ell.row_node).to(device=dev, dtype=torch.int64),
    )


def node_scores(
    g: GraphNP,
    labels: np.ndarray,
    k: int,
    ell: Optional[EllPack] = None,
    device=None,
) -> torch.Tensor:
    """S[v, b] for all nodes of ``g`` (kernel on the ELL rows, torch for the
    gather and segment sum)."""
    dev = resolve_device(device)
    if ell is None:
        ell = ell_pack(g, width=128)
    dst, w, row_node = _ell_tensors(ell, dev)
    lab_pad = torch.from_numpy(
        np.concatenate([np.asarray(labels, np.int32), np.array([k], np.int32)])
    ).to(dev)
    return _row_scores(dst, w, row_node, lab_pad, g.n, k=k)[: g.n]


def dense_eligibility(S, lab, bw, nw, U, k: int):
    """Vectorized SCLaP refine-mode eligibility, mirroring the sequential
    rule of ``sclap_numpy``: a node of an overloaded block may move to any
    *connected* block that fits, its own excluded ("must leave"); any other
    node to any connected block that fits, or its own block."""
    own = torch.arange(k, dtype=lab.dtype, device=lab.device)[None, :] == lab[:, None]
    fits = bw[None, :] + nw[:, None] <= U
    overloaded = (bw[lab.to(torch.int64)] > U)[:, None]
    return (S > 0) & torch.where(overloaded, fits & ~own, fits | own)


def dense_round_device(
    ell_dst: torch.Tensor,    # (Rb, W) int64 — cached ELL pack (row bucket)
    ell_w: torch.Tensor,      # (Rb, W) float32
    row_node: torch.Tensor,   # (Rb,) int64, sentinel n
    lab: torch.Tensor,        # (nb,) int32 — labels, k beyond n
    nw: torch.Tensor,         # (nb,) float32 — node weights, 0 beyond n
    U: float,
    seed: int,
    move_fraction: float,
    n: int,
    *,
    k: int,
) -> torch.Tensor:
    """One fully synchronous dense LP round; returns the new (nb,) labels.

    Every node sees the same block weights; a strictly improving move is
    applied with probability ``move_fraction``, and nodes of overloaded
    blocks leave with probability proportional to their block's excess.
    """
    dev = lab.device
    nb = lab.shape[0]
    U = torch.tensor(float(np.float32(U)), dtype=torch.float32, device=dev)
    valid = torch.arange(nb, device=dev) < n
    # padded slots keep label k: the sentinel-destination label of the ELL
    # gather, and outside every block weight
    lab = torch.where(valid, lab, k).to(torch.int32)
    nw = torch.where(valid, nw, 0.0)
    S = _row_scores(ell_dst, ell_w, row_node, lab, n, k=k)
    lab_c = torch.clamp(lab, max=k - 1).to(torch.int64)
    bw = torch.zeros(k + 1, dtype=torch.float32, device=dev).index_add_(
        0, torch.clamp(lab, max=k).to(torch.int64), nw
    )[:k]
    key = threefry.prng_key(seed)
    own_score = S.gather(1, lab_c[:, None])[:, 0]
    overloaded = bw[lab_c] > U
    eligible = dense_eligibility(S, lab_c, bw, nw, U, k)
    masked = torch.where(
        eligible, S + threefry.uniform(key, (nb, k), dev) * 0.49, -float("inf")
    )
    best = torch.argmax(masked, dim=1)
    has = torch.isfinite(masked.max(dim=1).values)
    gate = threefry.uniform(threefry.fold_in(key, 1), (nb,), dev) < float(
        np.float32(move_fraction)
    )
    # strict improvement only: cut-neutral moves oscillate under
    # synchronous updates (stale block weights)
    improve = S.gather(1, best[:, None])[:, 0] > own_score
    # overloaded blocks shed only their EXCESS in expectation
    bw_own = bw[lab_c]
    excess = torch.clamp((bw_own - U) / torch.clamp(bw_own, min=1.0), 0.0, 1.0)
    ov_gate = threefry.uniform(threefry.fold_in(key, 2), (nb,), dev) < 1.5 * excess
    move = valid & has & ((gate & improve) | (overloaded & ov_gate))
    return torch.where(move, best.to(torch.int32), lab)


def lp_refine_dense_round(
    g: GraphNP,
    labels: np.ndarray,
    k: int,
    U: float,
    seed: int = 0,
    move_fraction: float = 0.5,
    ell: Optional[EllPack] = None,
    device=None,
) -> np.ndarray:
    """One synchronous dense refinement round on a host graph (convenience
    wrapper around :func:`dense_round_device`)."""
    dev = resolve_device(device)
    if ell is None:
        ell = ell_pack(g, width=128)
    lab_pad = np.concatenate([np.asarray(labels, np.int32), np.array([k], np.int32)])
    nw_pad = np.concatenate([g.nw.astype(np.float32), np.zeros(1, np.float32)])
    new = dense_round_device(
        *_ell_tensors(ell, dev),
        torch.from_numpy(lab_pad).to(dev),
        torch.from_numpy(nw_pad).to(dev),
        U, seed & 0x7FFFFFFF, move_fraction, g.n, k=k,
    )
    return new[: g.n].cpu().numpy()
