"""Cluster contraction (paper §III/IV-C).

Each cluster becomes one coarse node; coarse node weight = sum of member
weights; coarse edge (A, B) weight = total weight of the edges between
clusters A and B.  A partition of the coarse graph projects to the fine
graph with identical cut and balance.

* :func:`contract_device` — the engine path in torch: relabel (sort +
  prefix-rank), coarse node-weight segment sum, quotient-arc dedup and CSR
  rebuild over bucket-padded device tensors.  Coarse ids follow increasing
  original-label order and arcs come out sorted by ``(cu, cv)``, so the
  result is structure-identical to the host :func:`contract`.
* :func:`contract` — the host numpy path (numpy engine, small levels, and
  the test oracle).
* :func:`contract_arcs` — one PE's quotient-arc dedup of the distributed
  contraction (``distributed_lp.contract_distributed``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..graph.csr import GraphNP

__all__ = [
    "CoarseMap",
    "PACKED_KEY_SPACE",
    "contract",
    "contract_arcs",
    "contract_device",
    "packed_key_wbits",
    "relabel",
    "project_labels",
]

# The reference packs (cu, cv, weight) into ONE uint32 sort key, so the pair
# space times the weight space must fit in 2^32.  Torch sorts int64 keys, so
# the port has no such limit, but it keeps the reference's boundary: the
# fast-path/general-path decision (and with it the float sum order on
# non-integral weights) then matches the reference level for level.
PACKED_KEY_SPACE = 2**32


def packed_key_wbits(Nb: int, Mb: int, ew_max: float, ew_integral: bool) -> int:
    """Weight-bit count for :func:`contract_device`'s packed-key path.

    Returns ``b > 0`` when every live arc weight is an integer in
    ``[1, 2^b - 1]``, ``Nb^2 * 2^b <= PACKED_KEY_SPACE`` and
    ``Mb * (2^b - 1) < 2^31``; 0 selects the general scatter-add path."""
    if not ew_integral or ew_max < 1.0:
        return 0
    b = int(ew_max).bit_length()
    if Nb * Nb * (1 << b) <= PACKED_KEY_SPACE and Mb * ((1 << b) - 1) < 2**31:
        return b
    return 0


def relabel(labels: np.ndarray) -> Tuple[np.ndarray, int]:
    """Map arbitrary cluster ids to the contiguous range [0, n')."""
    uniq, C = np.unique(labels, return_inverse=True)
    return C.astype(np.int32), int(uniq.shape[0])


def contract(g: GraphNP, labels: np.ndarray) -> Tuple[GraphNP, np.ndarray]:
    """Host contraction; returns (coarse graph, fine->coarse map C)."""
    C, n_c = relabel(labels)
    nw_c = np.zeros(n_c, dtype=np.float64)
    np.add.at(nw_c, C, g.nw)

    src = g.arc_sources()
    cu = C[src].astype(np.int64)
    cv = C[g.indices].astype(np.int64)
    keep = cu != cv
    cu, cv = cu[keep], cv[keep]
    w = g.ew[keep].astype(np.float64)

    if cu.size == 0:
        coarse = GraphNP(
            indptr=np.zeros(n_c + 1, dtype=np.int64),
            indices=np.zeros(0, dtype=np.int32),
            ew=np.zeros(0, dtype=np.float32),
            nw=nw_c.astype(np.float32),
        )
        return coarse, C

    key = cu * np.int64(n_c) + cv
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    w_s = w[order]
    boundary = np.empty(key_s.shape[0], dtype=bool)
    boundary[0] = True
    boundary[1:] = key_s[1:] != key_s[:-1]
    run = np.cumsum(boundary) - 1
    m_c = int(run[-1]) + 1
    w_c = np.zeros(m_c, dtype=np.float64)
    np.add.at(w_c, run, w_s)
    first = np.flatnonzero(boundary)
    cu_c = (key_s[first] // n_c).astype(np.int32)
    cv_c = (key_s[first] % n_c).astype(np.int32)

    counts = np.bincount(cu_c, minlength=n_c)
    indptr = np.zeros(n_c + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    coarse = GraphNP(
        indptr=indptr,
        indices=cv_c,
        ew=w_c.astype(np.float32),
        nw=nw_c.astype(np.float32),
    )
    return coarse, C


def project_labels(coarse_labels: np.ndarray, C: np.ndarray) -> np.ndarray:
    """Uncoarsening: a fine node inherits the block of its coarse node."""
    return coarse_labels[C]


@dataclass
class CoarseMap:
    """Fine->coarse map of one device contraction (hierarchy handle).

    ``dev`` is padded to the fine level's node bucket; entries ``>=
    n_fine`` are meaningless.  ``host()`` downloads the exact-length map
    lazily and caches it.
    """

    dev: torch.Tensor       # (Nb,) int64, valid through n_fine
    n_fine: int
    n_coarse: int
    on_materialize: Optional[object] = None
    _host: Optional[np.ndarray] = field(default=None, repr=False)

    def host(self) -> np.ndarray:
        if self._host is None:
            self._host = self.dev[: self.n_fine].cpu().numpy().astype(np.int32)
            if self.on_materialize is not None:
                self.on_materialize(self._host.nbytes)
        return self._host


def _runs(ks: torch.Tensor, oks: torch.Tensor, iota_m: torch.Tensor, Mb: int):
    """Run starts of a sorted key array: (first mask, compacted first
    positions, clamped positions, run count)."""
    first = oks.clone()
    first[1:] &= ks[1:] != ks[:-1]
    # run-first positions are increasing, so a value-only sort of the
    # masked iota IS the compaction
    firstpos = torch.sort(torch.where(first, iota_m, Mb)).values
    fp = torch.clamp(firstpos, max=Mb - 1)
    return first, firstpos, fp, first.sum()


def contract_device(src, dst, ew, nw, labels, n: int, m: int, *, wbits: int = 0):
    """Whole-graph device contraction over bucket-padded tensors.

    Args:
      src, dst: (Mb,) int64 arc endpoints; entries >= ``m`` are masked.
      ew:       (Mb,) float32 arc weights, 0 beyond ``m``.
      nw:       (Nb,) float32 node weights, 0 beyond ``n``.
      labels:   (Nb,) int cluster ids in [0, n) for valid nodes.
      n, m:     live node/arc counts.
      wbits:    when > 0 (see :func:`packed_key_wbits`), every live arc
        weight is an integer in ``[1, 2^wbits - 1]``: the weight rides in
        the low bits of the sort key and the per-run sums are exact
        integer cumsum differences.  0 selects the general path, whose
        float segment sums add each run in original arc order.

    Returns ``(C, n_c, nw_c, indptr_c, src_c, dst_c, ew_c, m_c, nwmax_c,
    ewmax_c)``, all on the device and padded to the input buckets; the four
    counts/maxima are 0-dim tensors (the caller syncs them in one transfer).
    """
    dev = nw.device
    Nb = nw.shape[0]
    Mb = src.shape[0]
    iota_n = torch.arange(Nb, dtype=torch.int64, device=dev)
    iota_m = torch.arange(Mb, dtype=torch.int64, device=dev)
    node_valid = iota_n < n
    sent = Nb

    # ---- relabel: value-only sort, dense ranks via cumsum, C[v] by binary
    # search for the first occurrence
    lab = torch.where(node_valid, labels.to(torch.int64), sent)
    sl = torch.sort(lab).values
    newrun_n = sl < sent
    newrun_n[1:] &= sl[1:] != sl[:-1]
    rank_n = torch.cumsum(newrun_n, 0) - 1
    n_c = newrun_n.sum()
    posn = torch.clamp(torch.searchsorted(sl, lab), max=Nb - 1)
    C = torch.where(node_valid, rank_n[posn], 0)

    # ---- coarse node weights (invalid nodes add 0 at slot 0: inert)
    nw_c = torch.zeros(Nb, dtype=torch.float32, device=dev).index_add_(
        0, C, torch.where(node_valid, nw, 0.0)
    )
    nwmax_c = nw_c.max()

    # ---- quotient arcs: map, drop self-arcs, sort (cu, cv) keys
    arc_valid = iota_m < m
    cu = C[torch.where(arc_valid, src, 0)]
    cv = C[torch.where(arc_valid, dst, 0)]
    ok = arc_valid & (cu != cv)
    if wbits:
        big = Nb * Nb * (1 << wbits) - 1   # a max-weight self-arc: never valid
        pair = cu * Nb + cv
        key = torch.where(ok, (pair << wbits) | ew.to(torch.int64), big)
        ks = torch.sort(key).values
        oks = ks < big
        khi = ks >> wbits
        first, firstpos, fp, m_c = _runs(khi, oks, iota_m, Mb)
        arc_ok = iota_m < m_c
        uk = khi[fp]
        src_c = torch.where(arc_ok, uk // Nb, 0)
        dst_c = torch.where(arc_ok, uk % Nb, 0)
        cumw = torch.cumsum(torch.where(oks, ks & ((1 << wbits) - 1), 0), 0)
        n_ok = oks.sum()
        fpe = torch.cat([firstpos[1:], firstpos.new_full((1,), Mb)])
        ends = torch.minimum(fpe, n_ok)
        hi = cumw[torch.clamp(ends - 1, 0, Mb - 1)]
        lo = torch.where(fp > 0, cumw[torch.clamp(fp - 1, min=0)], 0)
        ew_c = torch.where(arc_ok, (hi - lo).to(torch.float32), 0.0)
    else:
        # one int64 key stands for both of the reference's general paths
        # (int32 fused key, lexsort): they order the arcs the same way
        big = Nb * Nb
        key = torch.where(ok, cu * Nb + cv, big)
        ks, order = torch.sort(key, stable=True)
        oks = ks < big
        first, firstpos, fp, m_c = _runs(ks, oks, iota_m, Mb)
        arc_ok = iota_m < m_c
        uk = ks[fp]
        src_c = torch.where(arc_ok, uk // Nb, 0)
        dst_c = torch.where(arc_ok, uk % Nb, 0)
        run = torch.cumsum(first, 0) - 1
        run_of = torch.empty_like(run).scatter_(0, order, torch.where(oks, run, Mb))
        run_of = torch.where(ok, run_of, Mb)          # slot Mb is dropped
        ew_c = torch.zeros(Mb + 1, dtype=torch.float32, device=dev).index_add_(
            0, run_of, torch.where(ok, ew, 0.0)
        )[:Mb]
    ewmax_c = ew_c.max()

    # ---- CSR rebuild: src_c is non-decreasing over the live prefix, so the
    # row pointers are binary searches
    cu_sorted = torch.where(arc_ok, src_c, sent)
    indptr_c = torch.searchsorted(
        cu_sorted, torch.arange(Nb + 1, dtype=torch.int64, device=dev)
    )
    return C, n_c, nw_c, indptr_c, src_c, dst_c, ew_c, m_c, nwmax_c, ewmax_c


def contract_arcs(cu: torch.Tensor, cv: torch.Tensor, w: torch.Tensor,
                  valid: torch.Tensor, n_c: int):
    """Quotient-arc dedup of one shard, at static shape (the reference's
    ``contract_arcs_jnp``).

    ``cu``/``cv`` are the (E,) int64 coarse endpoints of the local arcs,
    ``w`` their float32 weights; arcs with ``valid`` False and self arcs
    are dropped.  Returns ``(cu', cv', w', valid')``: the distinct
    ``(cu, cv)`` pairs in increasing order with their summed weights,
    padded to E.  The key is one int64 ``cu * n_c + cv`` under a stable
    sort (the reference's is int32 without x64, and wraps once
    ``n_c > 46340``; this one does not).
    """
    E = cu.shape[0]
    big = int(n_c)
    ok = valid & (cu != cv)
    key = torch.where(ok, cu * big + cv, big * big)
    key_s, order = torch.sort(key, stable=True)
    w_s = torch.where(ok, w, 0.0)[order]
    live = key_s < big * big
    newrun = torch.cat([live.new_ones(1), key_s[1:] != key_s[:-1]]) & live
    run = torch.where(live, torch.cumsum(newrun, 0) - 1, E - 1)
    # every write to one index carries the same value: the order is moot
    w_out = torch.zeros(E, dtype=torch.float32, device=cu.device).index_add_(0, run, w_s)
    cu_out = torch.zeros(E, dtype=torch.int64, device=cu.device).index_put_(
        (run,), key_s // big)
    cv_out = torch.zeros(E, dtype=torch.int64, device=cu.device).index_put_(
        (run,), key_s % big)
    valid_out = torch.arange(E, device=cu.device) < newrun.sum()
    return cu_out, cv_out, torch.where(valid_out, w_out, 0.0), valid_out
