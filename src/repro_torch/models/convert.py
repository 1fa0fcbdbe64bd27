"""The weight carry between the reference and the port.

The reference keeps an LM's parameters as a pytree: ``embed``,
``final_norm``, optional ``lm_head``, ``scan`` (one dict per position of
the repeated unit, each leaf stacked over the units) and ``rem`` (one dict
per remainder layer); its decode caches have the same ``scan``/``rem``
layout.  The port holds a flat list of layers with the same names inside
each (``LM.layers[l].attn.wq``).  These functions move a tree given as
nested dicts and lists of numpy arrays into the port and back.  A bfloat16
leaf arrives as an ``ml_dtypes`` array, which ``torch.from_numpy`` rejects;
it goes through float32, which holds every bfloat16 value exactly.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from .model import LM

__all__ = ["from_reference_params", "caches_from_reference", "caches_to_reference"]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A float32 copy of a bfloat16 tensor (numpy has no bfloat16), else the
    tensor's own dtype."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for name, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{name}.")
        else:
            yield prefix + name, v


def _layer_trees(cfg: ArchConfig, tree) -> Iterator[Tuple[int, Dict]]:
    """(layer index, that layer's subtree) in ``cfg.layer_plan()`` order,
    unstacking the scanned units."""
    n_units, unit, _ = cfg.scan_split()
    U = len(unit)
    for i, stacked in enumerate(tree["scan"]):
        for u in range(n_units):
            yield u * U + i, {p: a[u] for p, a in _leaves(stacked)}
    for j, lp in enumerate(tree["rem"]):
        yield n_units * U + j, dict(_leaves(lp))


def from_reference_params(cfg: ArchConfig, tree, device=None) -> LM:
    """The port's LM holding the reference's parameters ``tree`` (default
    device: the card)."""
    dev = resolve_device(device)
    sd = {name: tree[name] for name in ("embed", "final_norm", "lm_head") if name in tree}
    for l, leaves in _layer_trees(cfg, tree):
        sd.update({f"layers.{l}.{p}": a for p, a in leaves.items()})
    model = LM(cfg, device=torch.device("meta"))
    model.load_state_dict({k: _tensor(a, dev) for k, a in sd.items()}, strict=True,
                          assign=True)
    return model


def caches_from_reference(cfg: ArchConfig, tree, device=None) -> List[dict]:
    """The reference's decode caches as the port's per-layer list."""
    dev = resolve_device(device)
    out = [None] * cfg.n_layers
    for l, leaves in _layer_trees(cfg, tree):
        out[l] = {p: _tensor(a, dev) for p, a in leaves.items()}
    return out


def caches_to_reference(cfg: ArchConfig, caches: List[dict]):
    """The port's per-layer caches in the reference's layout, as numpy
    (bfloat16 as float32)."""
    n_units, unit, _ = cfg.scan_split()
    U = len(unit)
    scan = [{name: np.stack([_numpy(caches[u * U + i][name]) for u in range(n_units)])
             for name in caches[i]} for i in range(U)]
    rem = [{name: _numpy(t) for name, t in c.items()} for c in caches[n_units * U:]]
    return {"scan": scan, "rem": rem}
