"""The device's timeline over a window, from ``torch.profiler``.

Only device activities are recorded (kernels, copies, fills).  The first one
is an anchor launched at a known host time, which puts the device's
timeline on the host's ``perf_counter`` clock, where the program's spans
are."""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]      # seconds on the host's perf_counter clock


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(intervals: Sequence[Interval], t0: float, t1: float) -> float:
    """Seconds of ``[t0, t1]`` in which some interval ran."""
    return sum(max(0.0, min(b, t1) - max(a, t0)) for a, b in merge(intervals))


def gaps(intervals: Sequence[Interval], t0: float, t1: float) -> List[Interval]:
    """The idle stretches of ``[t0, t1]``."""
    out, cur = [], t0
    for a, b in merge(intervals):
        if a > cur:
            out.append((cur, min(a, t1)))
        cur = max(cur, b)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(a, b) for a, b in out if b > a]


def name_gaps(idle: Sequence[Interval], spans: Sequence[Tuple[str, float, float]],
              outside: str = "no span") -> Dict[str, float]:
    """Idle seconds by the innermost span (the latest start) open at each
    gap's middle; ``spans`` are ``(name, start, end)``."""
    sp = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in sp]
    reach, r = [], float("-inf")        # the latest end among spans[:i + 1]
    for s in sp:
        r = max(r, s[2])
        reach.append(r)
    out: Dict[str, float] = {}
    for a, b in idle:
        mid = 0.5 * (a + b)
        key = outside
        j = bisect.bisect_right(starts, mid) - 1
        while j >= 0 and reach[j] >= mid:
            if sp[j][2] >= mid:
                key = sp[j][0]
                break
            j -= 1
        out[key] = out.get(key, 0.0) + (b - a)
    return out


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its parameter list (the
    template arguments, which tell kernels apart, stay)."""
    if "<" not in name:
        return name
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] == ">":
            return name[:i]
    return name


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


@dataclass
class Timeline:
    window_s: float
    t0: float
    t1: float
    ops: List[Tuple[str, float, float]] = field(default_factory=list)  # name, start, end

    @property
    def busy_s(self) -> float:
        return busy([(a, b) for _, a, b in self.ops], self.t0, self.t1)

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, a, b in self.ops:
            key = short_name(name)
            out[key] = out.get(key, 0.0) + (b - a)
        return out

    def op_seconds(self, substring: str) -> Tuple[float, int]:
        """Device seconds and count of the operations whose name holds
        ``substring``."""
        sel = [b - a for name, a, b in self.ops if substring in name]
        return sum(sel), len(sel)

    def idle(self) -> List[Interval]:
        return gaps([(a, b) for _, a, b in self.ops], self.t0, self.t1)


def _device_ops(prof) -> List[Tuple[str, float, float]]:
    """``(name, start_s, end_s)`` of every device activity, on the
    profiler's clock."""
    from torch.autograd import DeviceType

    out = []
    try:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns() * 1e-9
                out.append((e.name(), s, s + e.duration_ns() * 1e-9))
    except AttributeError:
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                out.append((e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6))
    return out


class DeviceTrace:
    """``with DeviceTrace(device) as tr: ...`` then ``tr.timeline``."""

    def __init__(self, device):
        self.device = device
        self.timeline: Optional[Timeline] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._x = torch.zeros(1, device=self.device)
        torch.cuda.synchronize(self.device)
        self._t_anchor = time.perf_counter()
        self._x.add_(1.0)           # the anchor: the first device activity
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize(self.device)
        t_end = time.perf_counter()
        self._prof.__exit__(*exc)
        ops = sorted(_device_ops(self._prof), key=lambda o: o[1])
        if not ops:
            self.timeline = None
            return False
        shift = self._t_anchor - ops[0][1]
        ops = [(name, a + shift, b + shift) for name, a, b in ops[1:]]
        self.timeline = Timeline(window_s=t_end - self._t_anchor, t0=self._t_anchor,
                                 t1=t_end, ops=ops)
        return False
