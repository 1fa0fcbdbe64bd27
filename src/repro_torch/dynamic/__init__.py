"""Dynamic partitioning subsystem of the port: keep a graph AND its
partition resident on one device while absorbing streams of edge and node
updates (the torch twin of ``repro.dynamic``).

* :mod:`repro_torch.dynamic.store` — a mutable device-resident graph: base
  CSR plus a bounded COO delta overlay, merged back by a device compaction,
  an overlay view and a tombstone vacuum.
* :mod:`repro_torch.dynamic.repair` — the region expansion and the
  region-masked gain and balance rounds of incremental repair (the sweep
  itself runs in :meth:`repro_torch.core.engine.LPEngine.repair`).
* :mod:`repro_torch.dynamic.session` — :class:`PartitionSession`, the
  serving loop with its quality guard and escalation to ``partition()``.
* :mod:`repro_torch.dynamic.group` — :class:`SessionGroup`, batched repair
  over many tenants along an explicit lane axis.
"""

from .group import GroupStats, SessionGroup
from .session import PartitionSession, SessionConfig, UpdateResult
from .store import DynamicGraphStore, GraphUpdate, UpdateValidationError

__all__ = [
    "DynamicGraphStore",
    "GraphUpdate",
    "GroupStats",
    "PartitionSession",
    "SessionConfig",
    "SessionGroup",
    "UpdateResult",
    "UpdateValidationError",
]
