"""SLO export: Prometheus text format + JSON snapshots of serving metrics.

The serving stack's ``stats()`` dicts (session / resilient / durable /
deployment) stay the programmatic API; this module renders them — plus
the stack's :class:`MetricsRegistry` histograms/gauges and the shape-bucket
watchdog — into the two formats an operator scrapes:

* ``write_slo(prefix, ...)`` → ``<prefix>.metrics.json`` (snapshot) and
  ``<prefix>.prom`` (Prometheus 0.0.4 text, scrape-ready);
* ``slo_snapshot(...)`` → the dict behind the JSON file.

The catalog (the reference's docs/OBSERVABILITY.md): update latency histogram
(``update_seconds``), view-hit ratio (``view_hit_ratio``), escalations,
rollbacks, quarantine depth, failovers, WAL fsync latency
(``wal_fsync_seconds``), checkpoint duration, and the RPO/RTO
observables (``rpo_records_at_risk``, ``rto_last_restore_seconds``).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

from .registry import MetricsRegistry
from .watchdog import watchdog

__all__ = ["slo_snapshot", "to_prometheus", "write_slo"]


def _derived_gauges(stats: dict) -> dict:
    """SLO ratios computable from the flat counters."""
    out = {}
    upd = stats.get("updates_applied", 0)
    if upd:
        out["view_hit_ratio"] = stats.get("view_hits", 0) / upd
    committed = stats.get("tx_committed", 0)
    if committed or stats.get("tx_rollbacks", 0):
        out["rollback_ratio"] = stats.get("tx_rollbacks", 0) / max(
            committed + stats.get("tx_rollbacks", 0), 1
        )
    if "tx_quarantined" in stats:
        out["quarantine_depth"] = stats["tx_quarantined"]
    if "dr_wal_records_since_checkpoint" in stats:
        out["rpo_records_at_risk"] = stats["dr_wal_records_since_checkpoint"]
    if "dr_last_restore_seconds" in stats:
        out["rto_last_restore_seconds"] = stats["dr_last_restore_seconds"]
    # burn-rate SLO gauge fed by the session's flight recorder (the ring
    # buffer of recent per-update latencies): 1.0 = full error budget left
    if "slo_budget_remaining" in stats:
        out["slo_budget_remaining"] = stats["slo_budget_remaining"]
    return out


def slo_snapshot(
    stats: Optional[dict] = None,
    registries: Sequence[MetricsRegistry] = (),
    include_watchdog: bool = True,
) -> dict:
    snap = dict(stats=dict(stats or {}))
    snap["slo"] = _derived_gauges(snap["stats"])
    for reg in registries:
        snap.setdefault("registries", []).append(reg.snapshot())
    if include_watchdog:
        snap["compile_watchdog"] = watchdog().snapshot()
    return snap


def _num(v):
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, float)):
        return float(v)
    return None


def to_prometheus(
    stats: Optional[dict] = None,
    registries: Sequence[MetricsRegistry] = (),
    prefix: str = "repro_",
) -> str:
    """One scrape body: flat counters as untyped samples, registry
    histograms/gauges in full, watchdog totals."""
    lines = []
    merged = dict(stats or {})
    merged.update(_derived_gauges(merged))
    for key in sorted(merged):
        val = _num(merged[key])
        if val is None:
            continue
        name = prefix + "".join(
            c if (c.isalnum() or c == "_") else "_" for c in key
        )
        lines.append(f"{name} {val:g}")
    for reg in registries:
        lines.append(reg.to_prometheus(prefix=prefix))
    wd = watchdog().snapshot()
    lines.append(f"{prefix}compiles_total {wd['total_compiles']}")
    for fam, d in wd["kernels"].items():
        flab = fam.replace('"', "")
        lines.append(
            f'{prefix}compiles{{kernel="{flab}"}} {d["compiles"]}'
        )
        lines.append(
            f'{prefix}compile_wall_ms{{kernel="{flab}"}} {d["wall_ms"]:g}'
        )
    return "\n".join(lines) + "\n"


def write_slo(
    prefix: str,
    stats: Optional[dict] = None,
    registries: Sequence[MetricsRegistry] = (),
) -> dict:
    """Write ``<prefix>.metrics.json`` + ``<prefix>.prom``; returns paths."""
    snap = slo_snapshot(stats, registries)
    json_path = prefix + ".metrics.json"
    tmp = json_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
    os.replace(tmp, json_path)
    prom_path = prefix + ".prom"
    tmp = prom_path + ".tmp"
    with open(tmp, "w") as f:
        f.write(to_prometheus(stats, registries))
    os.replace(tmp, prom_path)
    return dict(json=json_path, prom=prom_path)
