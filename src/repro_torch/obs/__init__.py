"""Observability for the port, one import surface (``repro.obs``'s):

* :class:`MetricsRegistry` / :class:`RegistryBackedStats` — the counter,
  gauge and histogram store behind every stats object;
* :func:`span` / :class:`Tracer` — nested spans with a device-sync close
  and Chrome-trace export, free when disabled;
* :func:`account` / :class:`DeviceMemoryAccountant` — device-memory
  accounting per buffer family, :func:`estimate_footprint` /
  :func:`will_fit` capacity planning;
* :func:`watchdog` / :class:`CompileWatchdog` — the shape-bucket and
  kernel-build guard (strict and seal modes);
* :func:`write_slo` — Prometheus text and a JSON snapshot of the serving
  SLO metrics.
"""

from .registry import MetricsRegistry, RegistryBackedStats
from .memory import (
    ALLOC_CHECK_MODULES, KNOWN_ALLOC_SITES, MEMORY_FAMILIES,
    DeviceMemoryAccountant, account, accountant, estimate_footprint, pin,
    set_accounting, will_fit,
)
from .trace import Span, Tracer, get_tracer, set_tracer, span
from .watchdog import (
    KERNEL_FAMILIES, KNOWN_JIT_SITES, CompileRecord, CompileWatchdog,
    WatchdogError, watchdog,
)
from .export import slo_snapshot, to_prometheus, write_slo

__all__ = [
    "MetricsRegistry", "RegistryBackedStats",
    "Span", "Tracer", "get_tracer", "set_tracer", "span",
    "CompileRecord", "CompileWatchdog", "WatchdogError", "watchdog",
    "KERNEL_FAMILIES", "KNOWN_JIT_SITES",
    "DeviceMemoryAccountant", "accountant", "set_accounting",
    "account", "pin", "estimate_footprint", "will_fit",
    "MEMORY_FAMILIES", "KNOWN_ALLOC_SITES", "ALLOC_CHECK_MODULES",
    "slo_snapshot", "to_prometheus", "write_slo",
]
