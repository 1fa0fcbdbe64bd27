"""Elastic scaling: restore any checkpoint onto a different mesh (the
torch twin of ``repro.ckpt.elastic``).

Checkpoints store full (unsharded) host arrays, so resharding to a new mesh
is a pure placement problem: build the new mesh's ``NamedSharding``s from
the same name-based rules (``repro_torch.models.sharding.param_pspecs``)
and place each leaf, one shard per mesh coordinate on its device.  The
tensors themselves never change; only how they are sliced does.
"""

from __future__ import annotations

from typing import Any

from ..launch.steps import norm_spec as _norm_spec
from ..models.sharding import NamedSharding
from .checkpoint import restore

__all__ = ["reshard_restore", "shardings_for"]


def _map2(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``'s leaves and ``specs``'s entries at
    the same places; the recursion follows ``tree``, so a spec (a tuple)
    is never taken apart."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        children = [_map2(fn, v, s) for v, s in zip(tree, specs)]
        return type(tree)(*children) if hasattr(tree, "_fields") else type(tree)(children)
    return fn(tree, specs)


def shardings_for(tree, specs, mesh):
    """A ``NamedSharding`` on ``mesh`` per leaf of ``tree``, from its spec
    with the axes that do not divide its dimension dropped (GSPMD would
    pad them; ``shard_map`` would reject them)."""
    return _map2(lambda leaf, spec: NamedSharding(mesh, _norm_spec(spec, leaf.shape, mesh)),
                 tree, specs)


def reshard_restore(path: str, step: int, like: Any, specs: Any, mesh):
    """Restore ``like``-shaped state onto ``mesh`` (any shape)."""
    return restore(path, step, like, shardings=shardings_for(like, specs, mesh))
