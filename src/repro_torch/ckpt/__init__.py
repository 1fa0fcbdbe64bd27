"""Checkpointing of the port (the torch twin of ``repro.ckpt``): atomic
save and restore, and the elastic reshard onto any mesh."""

from .checkpoint import AsyncCheckpointer, latest_step, load, restore, save
from .elastic import reshard_restore, shardings_for

__all__ = ["save", "restore", "load", "latest_step", "AsyncCheckpointer",
           "reshard_restore", "shardings_for"]
