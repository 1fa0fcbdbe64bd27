"""Checkpointing of the port (the torch twin of ``repro.ckpt``).  The
elastic reshard (``reshard_restore``, ``shardings_for``) waits for the
distributed path."""

from .checkpoint import AsyncCheckpointer, latest_step, load, restore, save

__all__ = ["save", "restore", "load", "latest_step", "AsyncCheckpointer"]
