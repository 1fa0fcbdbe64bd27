"""Meshes of the port: the 1-D PE mesh of the distributed path and the
named meshes of the LM scaffolding (the port's ``make_mesh`` and
``make_production_mesh``).

The reference runs its distributed programs under ``shard_map`` over
``jax.devices()``.  The port keeps one controlling process and makes
the placement explicit: mesh position ``p`` (row-major over a named mesh's
axes) lives on ``devices[p % len(devices)]``.  ``devices`` defaults to
every visible CUDA device, so on one card every position shares it, on
four cards each takes its own, and the CPU tests pass ``["cpu"] * n``.
Collectives between positions are explicit tensor moves (``.to(device)``,
``torch.cat``, index gathers), which autograd differentiates; there is
no ``torch.distributed``, which needs one process per rank.  With
``devices=["meta"]`` a mesh of any size allocates nothing.  The smoke
run's machine has one card (``"count": 1``), so there every coordinate
shares it and no cross-card copy has been measured (``PERF.md``).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["make_mesh", "make_production_mesh", "pe_devices", "Mesh"]


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


class Mesh:
    """A named grid of devices, the port's ``jax.sharding.Mesh``:
    ``shape`` maps each axis name to its size in order, ``devices`` is the
    grid (a numpy object array of ``torch.device``) and ``device(coord)``
    the device at a coordinate (one index per axis)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], devices: Sequence):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes) or min(shape, default=0) < 1:
            raise ValueError(f"a mesh needs distinct axes and sizes >= 1: {shape}, {axes}")
        self.shape = OrderedDict(zip(axes, shape))
        self.axis_names = axes
        grid = np.empty(math.prod(shape), dtype=object)
        grid[:] = [devices[p % len(devices)] for p in range(grid.size)]
        self.devices = grid.reshape(shape)

    def device(self, coord) -> torch.device:
        return self.devices[tuple(coord)]

    def coords(self):
        """Every coordinate, row-major."""
        return list(np.ndindex(*self.shape.values()))

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)})"


def make_mesh(shape, axes=None, devices: Optional[Sequence] = None):
    """``make_mesh(P, devices=None)``: one device per PE of the distributed
    path, assigned cyclically from ``devices`` (a tuple of devices).
    ``make_mesh(shape, axes, devices=None)``: the reference's named mesh
    (e.g. ``(2, 2), ("data", "model")``), a :class:`Mesh` over ``devices``
    assigned cyclically."""
    if isinstance(shape, int):
        P, devs = shape, pe_devices(axes if devices is None else devices)
        if P < 1:
            raise ValueError(f"a mesh needs at least one PE, got {P}")
        return tuple(devs[p % len(devs)] for p in range(P))
    return Mesh(shape, axes, pe_devices(devices))


def make_production_mesh(*, multi_pod: bool = False, devices: Optional[Sequence] = None) -> Mesh:
    """16x16 single-pod ("data", "model") or 2x16x16 multi-pod ("pod",
    "data", "model"); ``devices=["meta"]`` sizes it without a device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)
