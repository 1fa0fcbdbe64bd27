"""Metrics registry: the single store behind the engine's counters.

Pure-Python copy of the reference registry (``repro.obs.registry``):

* **counters** — monotonically increasing ints/floats (``sweep_calls``,
  ``h2d_bytes``);
* **gauges** — point-in-time values;
* **histograms** — log2-bucketed latency/size distributions: O(1) memory,
  Prometheus cumulative buckets and p50/p99 estimates;
* **series** — labeled counter families (``span_ms{phase="sweep"}``).

:class:`RegistryBackedStats` keeps the stats objects' attribute surface
(``eng.stats.sweep_calls += 1``, ``stats.buckets.add(key)``): counter
fields read and write through to a registry, bucket-key sets stay plain
Python sets.  Registries are per instance, never global.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

__all__ = ["MetricsRegistry", "RegistryBackedStats"]


def _log2_bucket(value: float) -> float:
    """Upper bound of the log2 bucket containing ``value`` (seconds/bytes).

    Buckets are powers of two of 1e-6 units, so sub-microsecond noise all
    lands in the first bucket.
    """
    if value <= 1e-6:
        return 1e-6
    return float(2 ** math.ceil(math.log2(value / 1e-6))) * 1e-6


class _Histogram:
    __slots__ = ("buckets", "count", "total", "vmin", "vmax")

    def __init__(self):
        self.buckets: Dict[float, int] = {}   # le upper bound -> count
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = 0.0

    def observe(self, value: float) -> None:
        le = _log2_bucket(float(value))
        self.buckets[le] = self.buckets.get(le, 0) + 1
        self.count += 1
        self.total += float(value)
        self.vmin = min(self.vmin, float(value))
        self.vmax = max(self.vmax, float(value))

    def quantile(self, q: float) -> float:
        """Upper-bound estimate of the q-quantile from the log2 buckets."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for le in sorted(self.buckets):
            seen += self.buckets[le]
            if seen >= target:
                return le
        return self.vmax

    def snapshot(self) -> dict:
        return dict(
            count=self.count, sum=self.total,
            min=0.0 if self.count == 0 else self.vmin, max=self.vmax,
            p50=self.quantile(0.50), p95=self.quantile(0.95),
            p99=self.quantile(0.99),
            buckets={f"{le:.6g}": c for le, c in sorted(self.buckets.items())},
        )


class MetricsRegistry:
    """Counters + gauges + log2 histograms + labeled series, one namespace."""

    def __init__(self, scope: str = ""):
        self.scope = scope
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Histogram] = {}
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}

    # ------------------------------------------------------------- counters

    def counter(self, name: str, value: float = 0) -> None:
        """Declare (idempotent): existing values are never clobbered."""
        self._counters.setdefault(name, value)

    def inc(self, name: str, delta: float = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + delta

    def get(self, name: str) -> float:
        return self._counters[name]

    def set_counter(self, name: str, value: float) -> None:
        self._counters[name] = value

    # --------------------------------------------------------------- gauges

    def gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    def get_gauge(self, name: str, default: float = 0.0) -> float:
        return self._gauges.get(name, default)

    # ----------------------------------------------------------- histograms

    def observe(self, name: str, value: float) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = _Histogram()
        h.observe(value)

    def histogram(self, name: str) -> Optional[_Histogram]:
        return self._hists.get(name)

    # --------------------------------------------------------------- series

    def series_inc(self, name: str, labels: dict, delta: float = 1) -> None:
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        self._series[key] = self._series.get(key, 0) + delta

    # ------------------------------------------------------------ lifecycle

    def reset(self) -> None:
        """Zero counters, clear gauges/histograms/series."""
        for k in self._counters:
            self._counters[k] = 0
        self._gauges.clear()
        self._hists.clear()
        self._series.clear()

    def snapshot(self) -> dict:
        return dict(
            scope=self.scope,
            counters=dict(self._counters),
            gauges=dict(self._gauges),
            histograms={k: h.snapshot() for k, h in self._hists.items()},
            series=[
                dict(name=name, labels=dict(labels), value=v)
                for (name, labels), v in sorted(self._series.items())
            ],
        )

    # ----------------------------------------------------------- prometheus

    def to_prometheus(self, prefix: str = "repro_") -> str:
        """Prometheus text exposition (0.0.4) of everything registered."""
        out = []

        def _san(name: str) -> str:
            return prefix + "".join(
                c if (c.isalnum() or c == "_") else "_" for c in name
            )

        for name in sorted(self._counters):
            mn = _san(name)
            out.append(f"# TYPE {mn} counter")
            out.append(f"{mn} {self._counters[name]:g}")
        for name in sorted(self._gauges):
            mn = _san(name)
            out.append(f"# TYPE {mn} gauge")
            out.append(f"{mn} {self._gauges[name]:g}")
        for name in sorted(self._hists):
            h = self._hists[name]
            mn = _san(name)
            out.append(f"# TYPE {mn} histogram")
            acc = 0
            for le in sorted(h.buckets):
                acc += h.buckets[le]
                out.append(f'{mn}_bucket{{le="{le:g}"}} {acc}')
            out.append(f'{mn}_bucket{{le="+Inf"}} {h.count}')
            out.append(f"{mn}_sum {h.total:g}")
            out.append(f"{mn}_count {h.count}")
        seen = set()
        for (name, labels), v in sorted(self._series.items()):
            mn = _san(name)
            if mn not in seen:
                seen.add(mn)
                out.append(f"# TYPE {mn} counter")
            lbl = ",".join(f'{k}="{val}"' for k, val in labels)
            out.append(f"{mn}{{{lbl}}} {v:g}")
        return "\n".join(out) + "\n"


class RegistryBackedStats:
    """Base for stats objects: counter fields live in a
    :class:`MetricsRegistry`, bucket-key fields stay real sets.

    Subclasses declare ``_COUNTER_FIELDS`` / ``_SET_FIELDS``;
    ``_COUNTER_PREFIX`` namespaces the registry keys while the attribute
    surface and ``snapshot()`` keys stay unprefixed.
    """

    _COUNTER_FIELDS: Tuple[str, ...] = ()
    _SET_FIELDS: Tuple[str, ...] = ()
    _COUNTER_PREFIX: str = ""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        object.__setattr__(
            self, "registry",
            registry if registry is not None
            else MetricsRegistry(type(self).__name__),
        )
        p = self._COUNTER_PREFIX
        for f in self._COUNTER_FIELDS:
            self.registry.counter(p + f)
        for f in self._SET_FIELDS:
            object.__setattr__(self, f, set())

    def __getattr__(self, name):
        # only reached when normal lookup fails: counter fields are never
        # instance attributes, everything else raises as usual
        cls = type(self)
        if name in cls._COUNTER_FIELDS:
            return self.registry.get(cls._COUNTER_PREFIX + name)
        raise AttributeError(
            f"{type(self).__name__!s} has no attribute {name!r}"
        )

    def __setattr__(self, name, value):
        cls = type(self)
        if name in cls._COUNTER_FIELDS:
            self.registry.set_counter(cls._COUNTER_PREFIX + name, value)
        else:
            object.__setattr__(self, name, value)

    def reset(self) -> None:
        p = self._COUNTER_PREFIX
        for f in self._COUNTER_FIELDS:
            self.registry.set_counter(p + f, 0)
        for f in self._SET_FIELDS:
            getattr(self, f).clear()

    def snapshot(self) -> dict:
        p = self._COUNTER_PREFIX
        d = {f: self.registry.get(p + f) for f in self._COUNTER_FIELDS}
        for f in self._SET_FIELDS:
            d[f + "_count"] = len(getattr(self, f))
        return d
