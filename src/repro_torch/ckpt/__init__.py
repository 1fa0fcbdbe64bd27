"""Checkpointing of the port (the torch twin of ``repro.ckpt``).  The
elastic reshard (``reshard_restore``, ``shardings_for``) comes with the
mesh and expert parallelism of the LM scaffolding (``ROADMAP.md``, Queue 1
item 4c)."""

from .checkpoint import AsyncCheckpointer, latest_step, load, restore, save

__all__ = ["save", "restore", "load", "latest_step", "AsyncCheckpointer"]
