"""The LM of the port (the torch twin of ``repro.models``): an
``nn.Module`` per block and one for the whole LM, plain functions on
tensors with the reference's names, the weight carry from the reference
(``convert``) and the mesh sharding rules (``sharding``)."""

from .convert import (caches_from_reference, caches_to_reference, from_reference_params,
                      opt_from_reference, opt_to_reference, params_to_reference,
                      reference_leaves)
from .model import LM, decode_step, forward, init_caches, init_params, loss_fn, prefill
from .sharding import DP, TP, act_specs, param_pspecs

__all__ = ["init_params", "forward", "loss_fn", "prefill", "decode_step", "init_caches",
           "LM", "from_reference_params", "params_to_reference", "opt_from_reference",
           "opt_to_reference", "reference_leaves", "caches_from_reference",
           "caches_to_reference", "param_pspecs", "act_specs", "DP", "TP"]
