"""The weight carry between the reference and the port.

The reference keeps an LM's parameters as a pytree: ``embed``,
``final_norm``, optional ``lm_head``, ``scan`` (one dict per position of
the repeated unit, each leaf stacked over the units) and ``rem`` (one dict
per remainder layer); its decode caches, gradients and optimizer states
have the same ``scan``/``rem`` layout.  The port holds a flat list of
layers with the same names inside each (``LM.layers[l].attn.wq``).  These
functions move a tree given as nested dicts and lists of numpy arrays
into the port and back.  A bfloat16
leaf arrives as an ``ml_dtypes`` array, which ``torch.from_numpy`` rejects;
it goes through float32, which holds every bfloat16 value exactly.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..optim.adamw import AdamWState
from .model import LM

__all__ = ["from_reference_params", "params_to_reference", "reference_leaves",
           "opt_from_reference", "opt_to_reference", "caches_from_reference",
           "caches_to_reference"]


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


def _named(cfg: ArchConfig, tree) -> Dict[str, object]:
    """A parameter-shaped reference tree as name -> leaf, with the port's
    names (``layers.3.attn.wq``) in ``named_parameters()`` order."""
    flat = {name: tree[name] for name in ("embed", "final_norm", "lm_head") if name in tree}
    for l, leaves in _layer_trees(cfg, tree):
        flat.update({f"layers.{l}.{p}": a for p, a in leaves.items()})
    order = [name for name, _ in LM(cfg, device=torch.device("meta")).named_parameters()]
    if sorted(order) != sorted(flat):
        raise ValueError(f"the tree's leaves do not match {cfg.name}'s parameters")
    return {name: flat[name] for name in order}


def _nest(flat: Dict[str, object]) -> Dict:
    """``{"attn.wq": a}`` -> ``{"attn": {"wq": a}}``."""
    out: Dict = {}
    for path, a in flat.items():
        *heads, last = path.split(".")
        d = out
        for h in heads:
            d = d.setdefault(h, {})
        d[last] = a
    return out


def from_reference_params(cfg: ArchConfig, tree, device=None) -> LM:
    """The port's LM holding the reference's parameters ``tree`` (default
    device: the card)."""
    dev = resolve_device(device)
    model = LM(cfg, device=torch.device("meta"))
    model.load_state_dict({k: _tensor(a, dev) for k, a in _named(cfg, tree).items()},
                          strict=True, assign=True)
    return model


def reference_leaves(cfg: ArchConfig) -> Dict[str, str]:
    """Each parameter name of the port -> the reference leaf that holds it
    (``layers.3.attn.wq`` -> ``scan.1.attn.wq`` for a unit of two layers):
    the layers of one scanned unit position share one reference leaf."""
    n_units, unit, _ = cfg.scan_split()
    U = len(unit)
    out = {}
    for name, _ in LM(cfg, device=torch.device("meta")).named_parameters():
        out[name] = name
        if name.startswith("layers."):
            _, l, path = name.split(".", 2)
            l = int(l)
            out[name] = (f"scan.{l % U}.{path}" if l < n_units * U
                         else f"rem.{l - n_units * U}.{path}")
    return out


def params_to_reference(cfg: ArchConfig, named) -> Dict:
    """The port's parameters, or any tensors keyed by their names (the
    gradients, an optimizer moment), in the reference's layout as numpy
    (bfloat16 as float32); ``named`` is an ``LM`` or a name -> tensor
    mapping."""
    if isinstance(named, torch.nn.Module):
        named = dict(named.named_parameters())
    n_units, unit, rem = cfg.scan_split()
    U = len(unit)
    out = {name: _numpy(named[name]) for name in ("embed", "final_norm", "lm_head")
           if name in named}

    def layer(l):
        pre = f"layers.{l}."
        return {k[len(pre):]: t for k, t in named.items() if k.startswith(pre)}

    out["scan"] = [_nest({p: np.stack([_numpy(layer(u * U + i)[p]) for u in range(n_units)])
                          for p in layer(i)}) for i in range(U)]
    out["rem"] = [_nest({p: _numpy(t) for p, t in layer(n_units * U + j).items()})
                  for j in range(len(rem))]
    return out


def opt_to_reference(cfg: ArchConfig, opt):
    """The port's optimizer state (an ``AdamWState``, or ``(AdamWState,
    residuals)`` under gradient compression) with each dict in the
    reference's layout as numpy; the step as a numpy int32 scalar."""
    if not hasattr(opt, "_fields"):
        state, res = opt
        return opt_to_reference(cfg, state), params_to_reference(cfg, res)
    return type(opt)(step=_numpy(opt.step),
                     **{f: params_to_reference(cfg, getattr(opt, f))
                        for f in ("mu", "nu", "master")})


def opt_from_reference(cfg: ArchConfig, state, device=None):
    """The reference's optimizer state (its ``AdamWState``, or ``(state,
    residuals)`` under gradient compression; numpy or JAX leaves) as the
    port's, dicts keyed by parameter name (default device: the card)."""
    dev = resolve_device(device)
    if not hasattr(state, "_fields"):
        st, res = state
        return (opt_from_reference(cfg, st, dev),
                {k: _tensor(a, dev) for k, a in _named(cfg, res).items()})
    return AdamWState(step=_tensor(state.step, dev),
                      **{f: {k: _tensor(a, dev) for k, a in _named(cfg, getattr(state, f)).items()}
                         for f in ("mu", "nu", "master")})


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
