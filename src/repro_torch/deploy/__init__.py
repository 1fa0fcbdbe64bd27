"""Partition deployment subsystem of the port (the torch twin of
``repro.deploy``): turn labels into servable per-block artifacts and keep
them consistent under the dynamic session's updates.

* :mod:`repro_torch.deploy.extract` — device block shard extraction: one
  :class:`BlockShard` per block (block-local CSR, h-ring ghost halo,
  global<->local id maps, the interface-exchange schedule), with a
  bit-identical numpy oracle (:func:`extract_blocks_numpy`) and an exact
  reassembly inverse (:func:`reassemble`).
* :mod:`repro_torch.deploy.metrics` — per-block communication volume and
  boundary-node counts, from labels and from shard artifacts.
* :mod:`repro_torch.deploy.migrate` — :class:`ShardDeployment`: after each
  session update, a :class:`MigrationDelta` patches only the affected
  shards, escalating to full re-extraction when patching degenerates.
* :mod:`repro_torch.deploy.replicate` — :class:`ReplicatedDeployment`:
  R-way standby replicas per block with checksum-audited reads and
  failover.
"""

from .extract import (
    BlockExtractor,
    BlockShard,
    BlockShardNP,
    DeployStats,
    assemble_schedule,
    extract_blocks_numpy,
    ghost_exchange_numpy,
    reassemble,
)
from .metrics import block_comm_metrics_np, shard_comm_metrics
from .migrate import MigrationDelta, ShardDeployment
from .replicate import ReplicaMiss, ReplicatedDeployment

__all__ = [
    "BlockExtractor",
    "BlockShard",
    "BlockShardNP",
    "DeployStats",
    "MigrationDelta",
    "ReplicaMiss",
    "ReplicatedDeployment",
    "ShardDeployment",
    "assemble_schedule",
    "block_comm_metrics_np",
    "extract_blocks_numpy",
    "ghost_exchange_numpy",
    "reassemble",
    "shard_comm_metrics",
]
