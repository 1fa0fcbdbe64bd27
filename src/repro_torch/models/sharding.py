"""Parameter and activation sharding rules of the LM port (the torch twin
of ``repro.models.sharding``): FSDP over the data (+pod) axes, tensor
parallelism over the model axis, expert parallelism for MoE.

Rules are name-based over the ``LM``'s named parameters.  The reference
stacks the layers of a scanned unit position into one leaf and gives it a
leading ``None`` axis; the port's layers are not stacked, so each gets
the same spec without it (``convert.reference_leaves`` maps the names).

``P``, ``NamedSharding`` and ``ShardedTensor`` are the port's stand-ins for
``jax.sharding.PartitionSpec``, ``NamedSharding`` and a sharded
``jax.Array``.  Placement leaves values alone: the reference's own
``launch.train`` jits its step without shardings and only ``moe_ep``
slices weights, so the port keeps parameters whole on one device and
``wsc`` (the reference's ``with_sharding_constraint``) changes no value.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

__all__ = ["param_pspecs", "act_specs", "DP", "TP", "wsc", "P", "NamedSharding",
           "ShardedTensor"]


class P(tuple):
    """A PartitionSpec: one entry per tensor axis, each a mesh axis name,
    a tuple of names (split over their product, the first major) or
    ``None`` (replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def wsc(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The reference's ``with_sharding_constraint``: ``x`` unchanged.
    With a mesh, every axis ``spec`` names must be one of the mesh's, as
    GSPMD requires; a dimension the axes do not divide is fine (GSPMD
    pads it)."""
    if mesh is not None:
        for entry in spec:
            for a in _axes(entry):
                if a not in mesh.shape:
                    raise ValueError(f"{spec} names axis {a!r}, not in {mesh}")
    return x


TP = "model"


def DP(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def _rule(name: str, ndim: int, dp, tp) -> P:
    """PartitionSpec for a leaf called ``name`` with ``ndim`` dims."""
    two = {
        # (in, out) projections: FSDP on input dim, TP on output dim
        "wq": P(dp, tp), "wk": P(dp, tp), "wv": P(dp, tp),
        "w_up": P(dp, tp), "w_gate": P(dp, tp),
        "wz": P(dp, tp), "wx": P(dp, tp),
        "wB": P(dp, None), "wC": P(dp, None), "wdt": P(dp, None),
        # (in, out) with TP on input dim (row-parallel)
        "wo": P(tp, dp), "w_down": P(tp, dp),
        "embed": P(tp, dp),          # vocab-sharded embedding
        "lm_head": P(dp, tp),        # vocab-sharded logits
        "conv_w": P(None, tp),
        "router": P(None, None),
    }
    three = {
        # MoE expert weights: experts over TP, FSDP on d_model dim
        "w_up": P(tp, dp, None),
        "w_gate": P(tp, dp, None),
        "w_down": P(tp, None, dp),
    }
    one = {
        "bq": P(tp), "bk": P(tp), "bv": P(tp),
        "conv_b": P(tp),
    }
    if ndim >= 3 and name in three:
        return P(*three[name], *([None] * (ndim - 3)))
    if ndim >= 2 and name in two:
        return P(*two[name], *([None] * (ndim - 2)))
    if ndim == 1 and name in one:
        return one[name]
    return P(*([None] * ndim))  # norms, scalars, biases: replicated


def _dp_entry(multi_pod: bool):
    dp = DP(multi_pod)
    return dp if len(dp) > 1 else dp[0]


def param_pspecs(params, multi_pod: bool) -> Dict[str, P]:
    """Parameter name -> PartitionSpec over ``params`` (an ``LM``, or any
    tensors keyed by parameter name, such as an optimizer moment)."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    dp = _dp_entry(multi_pod)
    return {name: _rule(name.rsplit(".", 1)[-1], t.dim(), dp, TP) for name, t in params.items()}


def act_specs(multi_pod: bool) -> Dict[str, P]:
    """Common activation PartitionSpecs."""
    dp = _dp_entry(multi_pod)
    return {
        "tokens": P(dp, None),
        "hidden": P(dp, None, None),
        "hidden_tp": P(dp, None, TP),
        "logits": P(dp, None, TP),
        "kv_cache": P(dp, TP, None, None),   # (B, S, n_kv, d_head): seq over TP
        "ssm_state": P(dp, TP, None, None),  # (B, H, P, N): heads over TP
    }


class NamedSharding:
    """A ``(mesh, spec)`` pair, as ``jax.sharding.NamedSharding``: which
    block of a tensor each mesh coordinate holds.  Tensor axis ``i`` is
    split into ``prod(mesh.shape[a] for a in spec[i])`` blocks, the first
    named axis major; axes the spec leaves out (or ``None``) are whole."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)
        for entry in self.spec:
            for a in _axes(entry):
                if a not in mesh.shape:
                    raise ValueError(f"{self.spec} names axis {a!r}, not in {mesh}")

    def _splits(self, shape):
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} has more entries than {tuple(shape)} has axes")
        out = []
        for i, n in enumerate(shape):
            axes = _axes(self.spec[i]) if i < len(self.spec) else ()
            k = math.prod(self.mesh.shape[a] for a in axes)
            if n % k:
                raise ValueError(f"axis {i} of {tuple(shape)} does not split into {k} "
                                 f"blocks ({self.spec} on {self.mesh})")
            out.append((axes, n // k))
        return out

    def shard_shape(self, shape) -> Tuple[int, ...]:
        return tuple(b for _, b in self._splits(shape))

    def index(self, coord, shape) -> Tuple[slice, ...]:
        """The block of a ``shape`` tensor that coordinate ``coord`` holds."""
        at = dict(zip(self.mesh.axis_names, coord))
        out = []
        for axes, b in self._splits(shape):
            j = 0
            for a in axes:
                j = j * self.mesh.shape[a] + at[a]
            out.append(slice(j * b, (j + 1) * b))
        return tuple(out)

    def place(self, t: torch.Tensor, dtype=None) -> "ShardedTensor":
        """``t`` split onto the mesh, in ``dtype`` (default ``t``'s): ``t``
        goes to each distinct device of the mesh once, and each
        coordinate's block is copied out of it there."""
        dtype = dtype or t.dtype
        whole, shards = {}, {}
        for c in self.mesh.coords():
            dev = self.mesh.device(c)
            if dev not in whole:
                whole[dev] = t.to(dev, dtype)
            shards[c] = whole[dev][self.index(c, t.shape)].clone()
        return ShardedTensor(self, tuple(t.shape), dtype, shards)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh}, {self.spec})"


class ShardedTensor:
    """A tensor placed on a mesh, the port's sharded ``jax.Array``: its
    ``sharding``, global ``shape`` and ``dtype``, and ``shards``, one
    tensor per mesh coordinate on that coordinate's device (replicated
    blocks are copies)."""

    def __init__(self, sharding: NamedSharding, shape, dtype, shards: Dict):
        self.sharding, self.shape, self.dtype, self.shards = sharding, shape, dtype, shards

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the mesh's first)."""
        sh = self.sharding
        coords = sh.mesh.coords()
        dev = sh.mesh.device(coords[0]) if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for c in coords:
            out[sh.index(c, self.shape)] = self.shards[c].to(dev)
        return out
