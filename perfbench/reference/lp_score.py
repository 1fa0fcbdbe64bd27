"""The dense refinement's block scores: ``S[r, b] = sum_j w[r, j] *
[lbl[r, j] == b]`` for ``b`` in ``[0, k)``, labels outside contributing
nothing."""

from __future__ import annotations

import numpy as np


def row_scores(lbl: np.ndarray, w: np.ndarray, k: int) -> np.ndarray:
    lbl = np.asarray(lbl, np.int64)
    w = np.asarray(w, np.float64)
    R = lbl.shape[0]
    ok = (lbl >= 0) & (lbl < k)
    rows = np.broadcast_to(np.arange(R)[:, None], lbl.shape)
    return np.bincount((rows * k + lbl)[ok], weights=w[ok], minlength=R * k).reshape(R, k)


def score_gap(samples) -> float:
    """The largest gap between a launch's scores and the recomputation, over
    ``(lbl, w, scores, k)`` row samples."""
    gap = 0.0
    for lbl, w, got, k in samples:
        if lbl.shape[0]:
            gap = max(gap, float(np.abs(np.asarray(got, np.float64)
                                        - row_scores(lbl, w, k)).max()))
    return gap
