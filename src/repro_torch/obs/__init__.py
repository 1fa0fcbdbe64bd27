"""Observability for the port: the metrics registry and the span tracer.

The compile watchdog, memory accounting and SLO export of the reference
(``repro.obs``) are not ported yet.
"""

from .registry import MetricsRegistry, RegistryBackedStats
from .trace import Span, Tracer, get_tracer, set_tracer, span

__all__ = [
    "MetricsRegistry", "RegistryBackedStats",
    "Span", "Tracer", "get_tracer", "set_tracer", "span",
]
