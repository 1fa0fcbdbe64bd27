"""One partition judged from the benchmark's own inputs: the edges it
generated, the renaming it applied, and the configuration's ``k`` and
``eps``."""

from __future__ import annotations

import math

import numpy as np


def lmax(total_node_weight: float, k: int, eps: float) -> float:
    """The balance bound ``(1 + eps) * ceil(c(V) / k)`` (arXiv:1404.4797 §II)."""
    return (1.0 + eps) * math.ceil(total_node_weight / k)


def bad_labels(labels, n: int, k: int) -> int:
    """How many of the ``n`` nodes lack a label in ``[0, k)``."""
    lab = np.asarray(labels)
    if lab.ndim != 1 or lab.shape[0] != n:
        return n
    return int(((lab < 0) | (lab >= k)).sum())


def cut(labels, lo: np.ndarray, hi: np.ndarray, weights=None) -> float:
    """Weight of the edges ``(lo, hi)`` whose ends lie in different blocks."""
    lab = np.asarray(labels)
    diff = lab[lo] != lab[hi]
    if weights is None:
        return float(np.count_nonzero(diff))
    return float(np.asarray(weights, np.float64)[diff].sum())


def overload(labels, k: int, eps: float, node_weights=None) -> float:
    """How far the heaviest block lies above ``lmax`` (0 when balanced)."""
    lab = np.asarray(labels).astype(np.int64)
    nw = np.ones(lab.shape[0]) if node_weights is None else np.asarray(node_weights,
                                                                        np.float64)
    ok = (lab >= 0) & (lab < k)
    bw = np.bincount(lab[ok], weights=nw[ok], minlength=k)
    return max(0.0, float(bw.max()) - lmax(float(nw.sum()), k, eps))


def judge(labels, reported_cut: float, n: int, lo, hi, k: int, eps: float,
          perm=None) -> dict:
    """``bad_labels``, ``overload`` and ``cut_gap`` of one returned
    partition of the graph whose node ``x`` the program saw as
    ``perm[x]``."""
    lab = np.asarray(labels)
    if lab.shape != (n,):
        return dict(bad_labels=n, overload=float(n), cut_gap=float(len(lo)))
    bad = bad_labels(lab, n, k)
    if perm is not None:
        lab = lab[perm]          # label of original node x
    return dict(bad_labels=bad, overload=overload(lab, k, eps),
                cut_gap=abs(float(reported_cut) - cut(lab, lo, hi)))
