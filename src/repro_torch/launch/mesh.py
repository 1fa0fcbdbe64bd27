"""The 1-D PE mesh of the distributed path (the port's ``make_mesh``).

The reference runs its distributed programs under ``shard_map`` over
``jax.devices()[:P]``.  The port keeps one controlling process and makes
the placement explicit: PE ``p`` lives on ``devices[p % len(devices)]``.
``devices`` defaults to every visible CUDA device, so on one card all PEs
share it, on four cards each takes its own, and the CPU tests pass
``["cpu"] * D``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..device import resolve_device

__all__ = ["make_mesh", "pe_devices"]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` names the current card: give it its index, so that equal
    placements compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def pe_devices(devices: Optional[Sequence] = None) -> Tuple[torch.device, ...]:
    """The device list as given, else every visible CUDA device; raises
    when a CUDA device is asked for (or defaulted to) and none is present."""
    if devices is None:
        resolve_device(None)
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    out = tuple(_indexed(resolve_device(d)) for d in devices)
    if not out:
        raise ValueError("the device list is empty")
    return out


def make_mesh(P: int, devices: Optional[Sequence] = None) -> Tuple[torch.device, ...]:
    """One device per PE, assigned cyclically from ``devices``."""
    if P < 1:
        raise ValueError(f"a mesh needs at least one PE, got {P}")
    devs = pe_devices(devices)
    return tuple(devs[p % len(devs)] for p in range(P))
