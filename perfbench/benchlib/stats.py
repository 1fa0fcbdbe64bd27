"""Whole-window statistics."""

from __future__ import annotations

import math
from typing import Sequence


def mean(xs: Sequence[float]) -> float:
    return math.fsum(xs) / len(xs)


def percentile(xs: Sequence[float], q: float) -> float:
    """The ``q``-th percentile of all samples, interpolated linearly between
    the two nearest ranks (numpy's default)."""
    s = sorted(xs)
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)

