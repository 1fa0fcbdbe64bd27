"""The costs of one step, counted on the ``meta`` device: the port's
counterpart of ``repro.launch.hlo_analysis``.

The reference lowers and compiles a cell for XLA and reads its FLOPs, HBM
bytes and collective bytes from the compiled HLO text (``analyze_hlo``).
The port compiles nothing: :func:`count_step` runs the cell's step once,
on inputs that live on the ``meta`` device (shapes and dtypes, no
storage, no arithmetic), and counts what the step does:

* **flops**: the counts of ``torch.utils.flop_counter``'s registry, the
  one ``FlopCounterMode`` sums: the matmul family (mm, addmm, bmm,
  baddbmm, convolution, attention), as the reference counts only ``dot``
  and ``convolution``.  The counter applies the registry itself:
  ``FlopCounterMode``'s module tracker keeps activations alive past the
  backward pass and would inflate the peak of live bytes;
* **hbm_bytes**: the operand plus result bytes of every aten op the step
  dispatches, through a ``TorchDispatchMode``.  Views and the ops the
  reference treats as free (its ``_FREE_OPS``: copies within a dtype,
  reshapes, broadcasts, iota, constants) are not counted.  Nothing is
  fused, so this is an upper bound against the reference's fusion-level
  model, which counts one read and write per fused kernel: 1.063x and
  1.094x ``analyze_hlo``'s on the qwen2.5-3b and granite-moe-1b-a400m
  smoke cells of ``tests/test_torch_dryrun.py`` at 1x1;
* **collective_bytes**, under the reference's kind names: what the
  caller works out from the shapes and the shardings and hands in, as
  the port's mesh moves no bytes between devices that XLA would.  The
  reductions that the state's shardings imply are
  :func:`gradient_collectives`; ``launch.dryrun`` adds the model axis's
  activation all-reduces and ``moe_ep``'s all-to-alls
  (``dryrun.activation_collectives``), ``launch.dryrun_paper`` the
  exchange's all-gather and the block weights' all-reduce;
* **unknown_trip_loops**: always 0.  Python runs every loop of the step,
  so no loop's trip count is unknown;
* the peak of **live bytes** over the step: every tensor reachable from
  the step's arguments is live at the start, every op's results become
  live, and a buffer dies with its storage (counted per storage, with a
  finalizer on the storage, as ``obs.memory`` counts device buffers).

The port's mesh keeps values whole on one device (``models.sharding``:
``wsc`` changes no value, and only ``moe_ep`` slices weights), so the
counter sees the step's *global* work, every mesh coordinate's share of
it on the one ``meta`` device.  Per-device FLOPs, bytes and collective
bytes are the global counts divided by ``n_chips``; at a 2x4 mesh this
gives the reference's per-device FLOPs exactly.  The peak is global too:
``launch.dryrun`` estimates the per-device figure from it.
"""

from __future__ import annotations

import dataclasses
import math
import time
import weakref
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["HloCosts", "StepCosts", "count_step", "gradient_collectives", "shard_bytes",
           "tensor_bytes"]

#: aten ops that move no bytes in the reference's model (its ``_FREE_OPS``:
#: parameters and constants, broadcasts, reshapes, iota); views are free too
_FREE_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros",
    "new_ones", "new_full", "scalar_tensor", "lift_fresh", "lift_fresh_copy",
    "arange", "expand", "_unsafe_view",
})
#: copies, which are free within a dtype (XLA's ``copy``) and a convert
#: across dtypes
_COPY_OPS = frozenset({"clone", "copy_", "_to_copy"})


@dataclass
class HloCosts:
    flops: float
    hbm_bytes: float
    collective_bytes: Dict[str, float]
    unknown_trip_loops: int

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())


@dataclass
class StepCosts(HloCosts):
    """:class:`HloCosts` per device, with the global memory figures of the
    run: ``peak_bytes`` (live bytes at their peak), ``state_bytes`` (the
    bytes of the ``state`` given to :func:`count_step`) and ``seconds``
    (the host time of the counted run)."""

    peak_bytes: int = 0
    state_bytes: int = 0
    seconds: float = 0.0


def _tensors(tree):
    """Every tensor of ``tree`` (dicts, lists, tuples, named tuples), and
    the parameters and buffers of any module and the tensor fields of any
    dataclass in it."""
    leaves, _ = tree_flatten(tree)
    for x in leaves:
        if isinstance(x, torch.nn.Module):
            yield from x.parameters()
            yield from x.buffers()
        elif isinstance(x, torch.Tensor):
            yield x
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            yield from _tensors(list(vars(x).values()))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def tensor_bytes(tree) -> int:
    """Bytes of the distinct tensors of ``tree`` (each counted once)."""
    return _nbytes(list({id(t): t for t in _tensors(tree)}.values()))


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages behind ``tensors``."""
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[id(s)] = s.nbytes()
    return sum(seen.values())


class _Counter(TorchDispatchMode):
    """FLOPs and operand and result bytes of each counted op, and the live
    bytes per storage with their peak."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.live: Dict[int, int] = {}
        self.total = 0
        self.peak = 0

    def track(self, tensors) -> None:
        for t in tensors:
            s = t.untyped_storage()
            key, nb = id(s), s.nbytes()
            if nb == 0 or key in self.live:
                continue
            self.live[key] = nb
            self.total += nb
            weakref.finalize(s, self._release, key)
        self.peak = max(self.peak, self.total)

    def _release(self, key: int) -> None:
        self.total -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        name = func.overloadpacket.__name__
        free = func.is_view or name in _FREE_OPS
        if name in _COPY_OPS:
            free = args[1 if name == "copy_" else 0].dtype == out.dtype
        if not free:
            self.hbm_bytes += _nbytes((args, kwargs)) + _nbytes(out)
        self.track(_tensors(out))
        return out


def count_step(step, *args, n_chips: int = 1, state=None,
               collectives: Optional[Dict[str, float]] = None, **kwargs) -> StepCosts:
    """Run ``step(*args, **kwargs)`` once under the counter (see the module
    docstring) and return its costs per device: the global counts divided
    by ``n_chips``.  ``state``: the tensors (or a tree, or a module) that
    the step keeps across calls, live from the start (as every tensor of
    the arguments is) and counted in ``state_bytes``;
    ``collectives``: global collective bytes (kind -> bytes) the caller
    works out itself, added to the tally.  The inputs may live on any
    device; the dry run puts them on ``meta``."""
    coll: Dict[str, float] = dict(collectives or {})
    counter = _Counter()
    counter.track(_tensors((args, kwargs, state)))
    t0 = time.perf_counter()
    with counter:
        out = step(*args, **kwargs)
    seconds = time.perf_counter() - t0
    del out
    coll = {k: v / n_chips for k, v in coll.items() if v}
    return StepCosts(
        flops=float(counter.flops) / n_chips,
        hbm_bytes=counter.hbm_bytes / n_chips,
        collective_bytes=coll,
        unknown_trip_loops=0,
        peak_bytes=counter.peak,
        state_bytes=_storage_bytes(_tensors(state)),
        seconds=seconds,
    )


def shard_bytes(tensors, shardings) -> int:
    """Bytes one mesh coordinate holds of ``tensors`` placed with
    ``shardings`` (two trees of the same structure, a ``NamedSharding``
    per tensor): each leaf's ``shard_shape`` times its element size."""
    ts, shs = tree_flatten(tensors)[0], tree_flatten(shardings)[0]
    if len(ts) != len(shs):
        raise ValueError(f"{len(ts)} tensors, {len(shs)} shardings")
    return sum(math.prod(sh.shard_shape(t.shape)) * t.element_size() for t, sh in zip(ts, shs))


def gradient_collectives(params: Dict[str, torch.Tensor], shardings, dp_axes, *,
                         train: bool) -> Dict[str, float]:
    """Global operand bytes of the collectives that the parameters'
    shardings imply, summed over the mesh's coordinates.  A parameter
    split over data axes (FSDP) is all-gathered over them before each
    forward pass that uses it (two in training: the pass and remat's
    recompute), and in training its gradient is reduce-scattered back
    (the operand: the gathered block); a parameter the data axes
    replicate has its gradient all-reduced over them."""
    passes = 2 if train else 1
    out: Dict[str, float] = {}

    def add(kind, b):
        out[kind] = out.get(kind, 0.0) + b

    for name, p in params.items():
        sh = shardings[name]
        mesh = sh.mesh
        n_coords = math.prod(mesh.shape.values())
        shard = math.prod(sh.shard_shape(p.shape)) * p.element_size()
        named = {a for e in sh.spec if e is not None
                 for a in (e if isinstance(e, tuple) else (e,))}
        split = math.prod(mesh.shape[a] for a in dp_axes if a in named)
        dp = math.prod(mesh.shape[a] for a in dp_axes)
        if split > 1:
            add("all-gather", passes * shard * n_coords)
            if train:
                add("reduce-scatter", split * shard * n_coords)
        elif dp > 1 and train:
            add("all-reduce", shard * n_coords)
    return out
