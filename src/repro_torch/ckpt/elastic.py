"""Elastic scaling: restore any checkpoint onto a different mesh (the
torch twin of ``repro.ckpt.elastic``).

Checkpoints store full (unsharded) host arrays, so resharding to a new mesh
is a pure placement problem: build the new mesh's ``NamedSharding``s from
the same name-based rules (``repro_torch.models.sharding.param_pspecs``)
and place each leaf, one shard per mesh coordinate on its device.  The
tensors themselves never change; only how they are sliced does.

Specs are checked as the reference's ``jax.tree.map`` and ``_norm_spec``
check them: a spec tree of another structure raises ``ValueError``, and a
spec naming an axis past its leaf's rank raises ``IndexError``.
"""

from __future__ import annotations

from typing import Any

from ..models.sharding import P, NamedSharding
from .checkpoint import restore

__all__ = ["reshard_restore", "shardings_for"]


def _norm_spec(spec, shape, mesh) -> P:
    """Drop sharding on axes that do not divide (GSPMD would pad; shard_map
    would reject) — the safe default when the new mesh is smaller/larger.
    The reference's own copy: unlike ``launch.steps.norm_spec`` it has no
    rank guard, so a named entry past the leaf's rank raises."""
    parts = []
    for i, ax in enumerate(spec):
        if ax is None:
            parts.append(None)
            continue
        sizes = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            sizes *= mesh.shape[a]
        parts.append(ax if shape[i] % sizes == 0 else None)
    parts += [None] * (len(shape) - len(parts))
    return P(*parts)


def _map2(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``'s leaves and ``specs``'s entries at
    the same places; the recursion follows ``tree``, so a spec (a tuple)
    is never taken apart.  ``specs`` must have ``tree``'s structure (the
    same dict keys, sequences of the same type and length), else
    ``ValueError``, as ``jax.tree.map`` raises."""
    if isinstance(tree, dict):
        if not isinstance(specs, dict) or set(specs) != set(tree):
            raise ValueError(f"dict keys {sorted(tree)} vs spec tree {specs!r}")
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if isinstance(specs, P) or type(specs) is not type(tree) or len(specs) != len(tree):
            raise ValueError(f"{type(tree).__name__} of {len(tree)} entries vs spec tree "
                             f"{specs!r}")
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
