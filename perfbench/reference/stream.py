"""A graph under a stream of edge additions and removals, rebuilt from its
edge multiset after any prefix of the stream."""

from __future__ import annotations

import numpy as np

from .partition import bad_labels, overload


class EdgeStream:
    """The original simple edges ``(lo, hi)`` of weight 1, then batches:
    batch ``t`` adds the pairs ``add_u[t], add_v[t]`` (weight 1 each) and
    removes the original edges ``removed[t]`` (indices into ``lo``)."""

    def __init__(self, n: int, lo: np.ndarray, hi: np.ndarray):
        self.n = n
        self.lo = np.asarray(lo, np.int64)
        self.hi = np.asarray(hi, np.int64)
        self.add_u, self.add_v, self.removed = [], [], []

    def push(self, add_u, add_v, removed) -> None:
        self.add_u.append(np.asarray(add_u, np.int64))
        self.add_v.append(np.asarray(add_v, np.int64))
        self.removed.append(np.asarray(removed, np.int64))

    def _prefix(self, t: int):
        """Adds and removals of batches ``0 .. t``."""
        cat = (lambda xs: np.concatenate(xs[: t + 1]) if t >= 0
               else np.zeros(0, np.int64))
        return cat(self.add_u), cat(self.add_v), cat(self.removed)

    def cut_after(self, t: int, labels) -> float:
        """Cut weight of ``labels`` on the graph after batch ``t``: each
        original edge not removed, plus each added pair, counted with its
        multiplicity."""
        lab = np.asarray(labels)
        au, av, rem = self._prefix(t)
        diff = lab[self.lo] != lab[self.hi]
        return float(np.count_nonzero(diff) - np.count_nonzero(diff[rem])
                     + np.count_nonzero(lab[au] != lab[av]))

    def judge(self, t: int, labels, reported_cut: float, k: int, eps: float) -> dict:
        if np.asarray(labels).shape != (self.n,):
            return dict(bad_labels=self.n, overload=float(self.n),
                        cut_gap=float(self.lo.size))
        return dict(bad_labels=bad_labels(labels, self.n, k), overload=overload(labels, k, eps),
                    cut_gap=abs(float(reported_cut) - self.cut_after(t, labels)))

    def csr_after(self, t: int) -> dict:
        """The symmetric CSR of the net edge multiset after batch ``t``: a
        pair's weight is its count, and it is an edge while that is above
        0."""
        au, av, rem = self._prefix(t)
        u = np.concatenate([self.lo, au, self.lo[rem]])
        v = np.concatenate([self.hi, av, self.hi[rem]])
        w = np.concatenate([np.ones(self.lo.size + au.size), -np.ones(rem.size)])
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        keys, inv = np.unique(lo * self.n + hi, return_inverse=True)
        net = np.bincount(inv.reshape(-1), weights=w)
        live = net > 0
        lo, hi, w = keys[live] // self.n, keys[live] % self.n, net[live]
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        ww = np.concatenate([w, w])
        order = np.lexsort((dst, src))
        indptr = np.zeros(self.n + 1, np.int64)
        indptr[1:] = np.cumsum(np.bincount(src, minlength=self.n))
        return dict(indptr=indptr, indices=dst[order], ew=ww[order],
                    nw=np.ones(self.n))


def array_gap(got: dict, want: dict) -> int:
    """Entries in which two CSR graphs differ (a length difference counts
    every entry of the longer array)."""
    gap = 0
    for name, w in want.items():
        g = np.asarray(got[name])
        if g.shape != w.shape:
            gap += max(g.size, w.size)
        else:
            gap += int(np.count_nonzero(g.astype(np.float64) != w.astype(np.float64)))
    return gap
