"""Dense refinement around the lp_score kernel: node-level block scores and
one synchronous dense LP round (torch twin of ``repro.kernels.lp_score.ops``).

The label gather ``lab_pad[ell_dst]`` and the row -> node segment sum stay
torch ops around the kernel, as the reference keeps them XLA ops around
its Pallas call.  The round's three random gates come from
:mod:`.threefry`, bit-identical to the reference's ``jax.random`` draws.
All shapes are *bucket* shapes (pow2 rows, pow2 node count); ``n`` is the
live node count.  The round takes a leading batch of label rows that share
one ELL pack: :func:`dense_round_device_batched` scores all of them with one
kernel launch on the flattened ``(B * Rb, W)`` rows, and
:func:`dense_round_device` is its one-row case.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ...device import resolve_device
from ...graph.csr import GraphNP
from ...graph.packing import ELL_WIDTH, EllPack, ell_pack
from . import threefry
from .lp_score import lp_score_rows

__all__ = [
    "node_scores",
    "lp_refine_dense_round",
    "dense_round_device",
    "dense_round_device_batched",
    "dense_eligibility",
    "pad_k",
]


def pad_k(k: int) -> int:
    """``k`` rounded up to a multiple of the lane width (at least one lane)."""
    return max(ELL_WIDTH, ((k + ELL_WIDTH - 1) // ELL_WIDTH) * ELL_WIDTH)


def _row_scores(ell_dst, ell_w, row_node, lab_pad, n: int, *, k: int):
    """ELL row scores segment-summed into (B, nb, k) node scores, one kernel
    launch for all ``B`` label rows.

    ``lab_pad`` is ``(B, nb)`` with ``nb >= n + 1`` and label ``k`` beyond
    ``n``, so sentinel destinations contribute nothing; rows owned by
    sentinel nodes go to a dropped slot."""
    B, nb = lab_pad.shape
    Rb, W = ell_dst.shape
    lbl = lab_pad[:, ell_dst].reshape(B * Rb, W)
    row_scores = lp_score_rows(lbl, ell_w.expand(B, Rb, W).reshape(B * Rb, W), k)
    seg = torch.where(row_node >= n, nb, row_node)
    seg = (seg + (nb + 1) * torch.arange(B, device=seg.device)[:, None]).reshape(-1)
    out = torch.zeros((B * (nb + 1), k), dtype=torch.float32, device=lab_pad.device)
    return out.index_add_(0, seg, row_scores).view(B, nb + 1, k)[:, :nb]


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
        ell = ell_pack(g, width=ELL_WIDTH)
    dst, w, row_node = _ell_tensors(ell, dev)
    lab_pad = torch.from_numpy(
        np.concatenate([np.asarray(labels, np.int32), np.array([k], np.int32)])
    ).to(dev)
    return _row_scores(dst, w, row_node, lab_pad[None], g.n, k=k)[0, : g.n]


def dense_eligibility(S, lab, bw, nw, U, k: int):
    """Vectorized SCLaP refine-mode eligibility, mirroring the sequential
    rule of ``sclap_numpy``: a node of an overloaded block may move to any
    *connected* block that fits, its own excluded ("must leave"); any other
    node to any connected block that fits, or its own block.  ``S`` is
    ``(..., nb, k)``, ``lab`` ``(..., nb)``, ``bw`` ``(..., k)``."""
    own = torch.arange(k, dtype=lab.dtype, device=lab.device) == lab[..., None]
    fits = bw[..., None, :] + nw[..., :, None] <= U
    overloaded = (bw.gather(-1, lab.to(torch.int64)) > U)[..., None]
    return (S > 0) & torch.where(overloaded, fits & ~own, fits | own)


def _uniform_rows(keys, shape, dev) -> torch.Tensor:
    """``(len(keys), *shape)`` threefry draws, row ``b`` from ``keys[b]``."""
    return torch.stack([threefry.uniform(key, shape, dev) for key in keys])


def dense_round_device_batched(
    ell_dst: torch.Tensor,    # (Rb, W) int64 — shared cached ELL pack
    ell_w: torch.Tensor,      # (Rb, W) float32
    row_node: torch.Tensor,   # (Rb,) int64, sentinel n
    labs: torch.Tensor,       # (B, nb) int32 — label rows, k beyond n
    nw: torch.Tensor,         # (nb,) float32 — node weights, 0 beyond n
    U: float,
    seeds: Sequence[int],     # one round seed per row
    move_fraction: float,
    n: int,
    *,
    k: int,
) -> torch.Tensor:
    """One fully synchronous dense LP round for each of ``B`` label rows;
    returns the new (B, nb) labels.  Row ``b`` is what
    :func:`dense_round_device` returns for ``labs[b]`` and ``seeds[b]``.

    Every node sees the same block weights; a strictly improving move is
    applied with probability ``move_fraction``, and nodes of overloaded
    blocks leave with probability proportional to their block's excess.
    """
    dev = labs.device
    B, nb = labs.shape
    U = torch.tensor(float(np.float32(U)), dtype=torch.float32, device=dev)
    valid = torch.arange(nb, device=dev) < n
    # padded slots keep label k: the sentinel-destination label of the ELL
    # gather, and outside every block weight
    labs = torch.where(valid, labs, k).to(torch.int32)
    nw = torch.where(valid, nw, 0.0)
    S = _row_scores(ell_dst, ell_w, row_node, labs, n, k=k)
    lab_c = torch.clamp(labs, max=k - 1).to(torch.int64)
    bw = torch.zeros((B, k + 1), dtype=torch.float32, device=dev).scatter_add_(
        1, torch.clamp(labs, max=k).to(torch.int64), nw.expand(B, nb)
    )[:, :k]
    keys = [threefry.prng_key(int(s)) for s in seeds]
    own_score = S.gather(2, lab_c[..., None])[..., 0]
    bw_own = bw.gather(1, lab_c)
    overloaded = bw_own > U
    eligible = dense_eligibility(S, lab_c, bw, nw, U, k)
    masked = torch.where(
        eligible, S + _uniform_rows(keys, (nb, k), dev) * 0.49, -float("inf")
    )
    best = torch.argmax(masked, dim=2)
    has = torch.isfinite(masked.max(dim=2).values)
    gate = _uniform_rows(
        [threefry.fold_in(key, 1) for key in keys], (nb,), dev
    ) < float(np.float32(move_fraction))
    # strict improvement only: cut-neutral moves oscillate under
    # synchronous updates (stale block weights)
    improve = S.gather(2, best[..., None])[..., 0] > own_score
    # overloaded blocks shed only their EXCESS in expectation
    excess = torch.clamp((bw_own - U) / torch.clamp(bw_own, min=1.0), 0.0, 1.0)
    ov_gate = _uniform_rows(
        [threefry.fold_in(key, 2) for key in keys], (nb,), dev
    ) < 1.5 * excess
    move = valid & has & ((gate & improve) | (overloaded & ov_gate))
    return torch.where(move, best.to(torch.int32), labs)


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
    """One fully synchronous dense LP round; returns the new (nb,) labels
    (the one-row case of :func:`dense_round_device_batched`)."""
    return dense_round_device_batched(
        ell_dst, ell_w, row_node, lab[None], nw, U, [seed], move_fraction, n, k=k
    )[0]


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
        ell = ell_pack(g, width=ELL_WIDTH)
    lab_pad = np.concatenate([np.asarray(labels, np.int32), np.array([k], np.int32)])
    nw_pad = np.concatenate([g.nw.astype(np.float32), np.zeros(1, np.float32)])
    new = dense_round_device(
        *_ell_tensors(ell, dev),
        torch.from_numpy(lab_pad).to(dev),
        torch.from_numpy(nw_pad).to(dev),
        U, seed & 0x7FFFFFFF, move_fraction, g.n, k=k,
    )
    return new[: g.n].cpu().numpy()
