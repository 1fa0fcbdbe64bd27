"""CSR graph containers of the port.

An undirected graph is a *symmetric* CSR adjacency: every edge {u, v} is
the two arcs (u, v) and (v, u), with per-arc weights ``ew`` and per-node
weights ``nw`` (the layout of ``repro.graph.csr``).

* :class:`GraphNP` — host numpy arrays (generators, host planners, the
  numpy engines).  Same fields and dtypes as the reference's ``GraphNP``.
* :class:`GraphDev` — a device-resident, bucket-padded CSR of torch
  tensors: the output of the engine's device contraction.  Only ``(n, m)``
  and a few weight scalars live on the host; ``to_host()`` materializes a
  :class:`GraphNP` lazily.  Index tensors are int64 (torch's index type).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "GraphDev",
    "GraphNP",
    "arc_bucket",
    "from_edges",
    "from_reference",
    "pow2",
    "to_device_csr",
]


def pow2(x: int) -> int:
    """Smallest power of two >= x (the node/label-axis bucket policy)."""
    return 1 << max(0, int(x) - 1).bit_length()


def arc_bucket(m: int) -> int:
    """Arc-axis bucket: pow2 below 16384, then 16384-arc rungs, so large
    levels pay at most ~8% padding while small ones keep few buckets."""
    if m <= 16384:
        return pow2(max(m, 8))
    return -(-m // 16384) * 16384


@dataclass(frozen=True)
class GraphNP:
    """Host-side CSR graph (numpy).

    Attributes:
      indptr:  (n + 1,) int64 — CSR row pointers.
      indices: (m,)     int32 — arc heads (m counts *arcs*, 2x the edges).
      ew:      (m,)     float32 — arc weights.
      nw:      (n,)     float32 — node weights.
    """

    indptr: np.ndarray
    indices: np.ndarray
    ew: np.ndarray
    nw: np.ndarray

    @property
    def n(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def m(self) -> int:
        return int(self.indices.shape[0])

    @property
    def total_node_weight(self) -> float:
        return float(self.nw.sum())

    def degrees(self) -> np.ndarray:
        return self.indptr[1:] - self.indptr[:-1]

    def arc_sources(self) -> np.ndarray:
        return np.repeat(np.arange(self.n, dtype=np.int32), self.degrees())


class GraphDev:
    """Device-resident bucket-padded CSR graph (coarse levels of the V-cycle).

    Invariants (as emitted by ``contract_device`` and relied on by the
    engine's device pack gathers and arena):

    * ``indptr`` has ``Nb + 1`` entries with ``Nb = pow2(n)``; rows ``>= n``
      all hold ``m`` (sentinel-node gathers read degree 0);
    * ``indices`` / ``ew`` / ``src`` have ``Mb = arc_bucket(m)`` entries;
      arcs ``>= m`` hold index 0 / weight 0;
    * ``nw`` has ``Nb`` entries, 0 beyond ``n``.

    ``degrees()`` and ``to_host()`` download lazily and cache;
    ``on_materialize(nbytes)`` lets the owning engine count the traffic.
    """

    def __init__(self, indptr, indices, ew, nw, src, n: int, m: int,
                 nw_max: float = 0.0, ew_max: float = 0.0,
                 ew_integral: bool = False, on_materialize=None):
        self.indptr = indptr
        self.indices = indices
        self.ew = ew
        self.nw = nw
        self.src = src
        self._n = int(n)
        self._m = int(m)
        self.nw_max = float(nw_max)
        # weight metadata for the next contraction's packed-key decision:
        # integral weights stay integral under contraction (sums)
        self.ew_max = float(ew_max)
        self.ew_integral = bool(ew_integral)
        self.on_materialize = on_materialize
        self._indptr_host: Optional[np.ndarray] = None
        self._host: Optional[GraphNP] = None

    @property
    def n(self) -> int:
        return self._n

    @property
    def m(self) -> int:
        return self._m

    @property
    def total_node_weight(self) -> float:
        """Total node weight, reduced on device (padding is 0 — inert)."""
        return float(self.nw.sum())

    def _indptr_np(self) -> np.ndarray:
        if self._indptr_host is None:
            self._indptr_host = (
                self.indptr[: self._n + 1].cpu().numpy().astype(np.int64)
            )
            if self.on_materialize is not None:
                self.on_materialize(self._indptr_host.nbytes)
        return self._indptr_host

    def degrees(self) -> np.ndarray:
        return np.diff(self._indptr_np())

    def to_host(self) -> GraphNP:
        """Materialize a :class:`GraphNP` (cached) — one O(n + m) download."""
        if self._host is None:
            self._host = GraphNP(
                indptr=self._indptr_np(),
                indices=self.indices[: self._m].cpu().numpy().astype(np.int32),
                ew=self.ew[: self._m].cpu().numpy().astype(np.float32),
                nw=self.nw[: self._n].cpu().numpy().astype(np.float32),
            )
            if self.on_materialize is not None:
                self.on_materialize(self._m * 12 + self._n * 4)
        return self._host


def from_edges(
    n: int,
    u: np.ndarray,
    v: np.ndarray,
    w: np.ndarray | None = None,
    nw: np.ndarray | None = None,
    symmetrize: bool = True,
    dedup: bool = True,
) -> GraphNP:
    """Build a :class:`GraphNP` from an edge list (byte-identical to the
    reference's ``from_edges``).

    Args:
      n: number of nodes.
      u, v: int arrays of endpoints.  Self loops are dropped.
      w: optional edge weights (default: all ones).
      nw: optional node weights (default: all ones).
      symmetrize: if True, adds both arcs per input edge.
      dedup: if True, parallel arcs are merged (weights summed).
    """
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    if w is None:
        w = np.ones(u.shape[0], dtype=np.float32)
    w = np.asarray(w, dtype=np.float32)

    keep = u != v
    u, v, w = u[keep], v[keep], w[keep]

    if symmetrize:
        uu = np.concatenate([u, v])
        vv = np.concatenate([v, u])
        ww = np.concatenate([w, w])
    else:
        uu, vv, ww = u, v, w

    if dedup and uu.size:
        key = uu * np.int64(n) + vv
        order = np.argsort(key, kind="stable")
        key = key[order]
        ww = ww[order]
        boundary = np.empty(key.shape[0], dtype=bool)
        boundary[0] = True
        boundary[1:] = key[1:] != key[:-1]
        run_id = np.cumsum(boundary) - 1
        n_runs = int(run_id[-1]) + 1
        # bincount sums each run in input order in float64, exactly like
        # the reference's np.add.at, at a fraction of its cost
        merged_w = np.bincount(run_id, weights=ww, minlength=n_runs)
        first = np.flatnonzero(boundary)
        uu = (key[first] // n).astype(np.int32)
        vv = (key[first] % n).astype(np.int32)
        ww = merged_w.astype(np.float32)
    else:
        order = np.argsort(uu * np.int64(n) + vv, kind="stable")
        uu = uu[order].astype(np.int32)
        vv = vv[order].astype(np.int32)
        ww = ww[order]

    counts = np.bincount(uu, minlength=n).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    if nw is None:
        nw = np.ones(n, dtype=np.float32)
    return GraphNP(
        indptr=indptr,
        indices=vv.astype(np.int32),
        ew=ww.astype(np.float32),
        nw=np.asarray(nw, dtype=np.float32),
    )


def from_reference(indptr, indices, ew, nw) -> GraphNP:
    """The port's :class:`GraphNP` from the four numpy arrays of a reference
    ``repro.graph.GraphNP`` (how a graph built once is handed to both
    packages)."""
    return GraphNP(
        indptr=np.asarray(indptr, dtype=np.int64),
        indices=np.asarray(indices, dtype=np.int32),
        ew=np.asarray(ew, dtype=np.float32),
        nw=np.asarray(nw, dtype=np.float32),
    )


def to_device_csr(
    g: GraphNP,
    device: Optional[Union[str, torch.device]] = None,
    on_materialize=None,
) -> GraphDev:
    """Upload a host CSR into a bucket-padded :class:`GraphDev` satisfying
    the invariants ``contract_device`` outputs satisfy."""
    dev = resolve_device(device)
    n, m = g.n, g.m
    Nb = pow2(max(n, 8))
    Mb = arc_bucket(m)
    indptr = np.full(Nb + 1, m, dtype=np.int64)
    indptr[: n + 1] = g.indptr
    indices = np.zeros(Mb, dtype=np.int64)
    indices[:m] = g.indices
    ew = np.zeros(Mb, dtype=np.float32)
    ew[:m] = g.ew
    src = np.zeros(Mb, dtype=np.int64)
    src[:m] = g.arc_sources()
    nw = np.zeros(Nb, dtype=np.float32)
    nw[:n] = g.nw
    return GraphDev(
        indptr=torch.from_numpy(indptr).to(dev),
        indices=torch.from_numpy(indices).to(dev),
        ew=torch.from_numpy(ew).to(dev),
        nw=torch.from_numpy(nw).to(dev),
        src=torch.from_numpy(src).to(dev),
        n=n, m=m,
        nw_max=float(g.nw.max()) if n else 0.0,
        ew_max=float(g.ew.max()) if m else 0.0,
        ew_integral=bool(np.all(g.ew == np.round(g.ew))) if m else True,
        on_materialize=on_materialize,
    )
