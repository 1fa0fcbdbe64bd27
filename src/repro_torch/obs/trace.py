"""Span tracer with Chrome-trace-event export (Perfetto-loadable).

Spans are nested wall-clock intervals with an explicit device-sync
boundary: a span that wraps device work registers its output tensors via
``sp.sync_on(...)`` and the close synchronizes their CUDA device — but
only when tracing is enabled.  With tracing off, ``span()`` returns a
shared no-op singleton (one module-global load and a ``None`` check), so
an untraced run neither synchronizes nor allocates.

Usage::

    from repro_torch.obs import span, set_tracer, Tracer

    set_tracer(Tracer())            # enable (None disables again)
    with span("vcycle.sweep", cat="vcycle", mode="refine") as sp:
        out = engine.refine(...)
        sp.sync_on(out)             # close waits for the device
    get_tracer().export_chrome("trace.json")

Span names: ``vcycle.pack`` (chunk or ELL pack, host or device gather),
``vcycle.sweep`` (mode cluster | refine | dense), ``vcycle.contract``,
``vcycle.project``, ``vcycle.host`` (levels run by the numpy engine),
``vcycle.evolve`` (the coarsest-level GA) and ``vcycle.finish`` (the final
balance repair and cut of each V-cycle).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

import torch

__all__ = ["Tracer", "Span", "span", "get_tracer", "set_tracer"]


class _NoopSpan:
    """The disabled path: every method is a no-op, one shared instance."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def sync_on(self, *tensors):
        pass

    def set(self, **args):
        pass


_NOOP = _NoopSpan()


class Span:
    __slots__ = ("tracer", "name", "cat", "args", "_sync", "t0", "tid")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._sync = None
        self.t0 = 0.0
        self.tid = 0

    def __enter__(self):
        self.tid = threading.get_ident() & 0xFFFF
        self.t0 = time.perf_counter()
        return self

    def sync_on(self, *tensors):
        """Tensors whose device completion bounds this span."""
        self._sync = tensors

    def set(self, **args):
        self.args.update(args)

    def __exit__(self, *exc):
        if self._sync is not None:
            for t in self._sync:
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    torch.cuda.synchronize(t.device)
                    break
        self.tracer._record(self, time.perf_counter())
        return False


class Tracer:
    """Collects complete ("ph": "X") Chrome trace events, microsecond ts."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: List[dict] = []
        self._origin = time.perf_counter()
        self._lock = threading.Lock()

    def span(self, name: str, cat: str = "", **args):
        if not self.enabled:
            return _NOOP
        return Span(self, name, cat, args)

    def _record(self, sp: Span, t1: float) -> None:
        ev = dict(
            name=sp.name, cat=sp.cat or sp.name.split(".")[0], ph="X",
            ts=(sp.t0 - self._origin) * 1e6, dur=(t1 - sp.t0) * 1e6,
            pid=os.getpid(), tid=sp.tid,
        )
        if sp.args:
            ev["args"] = sp.args
        with self._lock:
            self.events.append(ev)

    def clear(self) -> None:
        with self._lock:
            self.events.clear()

    def export_chrome(self, path: str) -> str:
        """Write ``{"traceEvents": [...]}`` — drag into ui.perfetto.dev."""
        with self._lock:
            doc = dict(traceEvents=list(self.events), displayTimeUnit="ms")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


_tracer: Optional[Tracer] = None


def get_tracer() -> Optional[Tracer]:
    return _tracer


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or with ``None`` remove) the process-global tracer."""
    global _tracer
    prev, _tracer = _tracer, tracer
    return prev


def span(name: str, cat: str = "", **args):
    """The instrumentation entry point every module calls.

    Disabled fast path: one global load, one ``None`` test, return the
    shared no-op singleton.
    """
    t = _tracer
    if t is None or not t.enabled:
        return _NOOP
    return Span(t, name, cat, args)
