"""The LM of the port (the torch twin of ``repro.models``): an
``nn.Module`` per block and one for the whole LM, plain functions on
tensors with the reference's names, and the weight carry from the
reference (``convert``).  The mesh sharding rules (``param_pspecs``,
``act_specs``, ``DP``, ``TP``) come with the expert-parallel slice
(``ROADMAP.md``, Queue 1 item 4c)."""

from .convert import (caches_from_reference, caches_to_reference, from_reference_params,
                      opt_from_reference, opt_to_reference, params_to_reference,
                      reference_leaves)
from .model import LM, decode_step, forward, init_caches, init_params, loss_fn, prefill

__all__ = ["init_params", "forward", "loss_fn", "prefill", "decode_step", "init_caches",
           "LM", "from_reference_params", "params_to_reference", "opt_from_reference",
           "opt_to_reference", "reference_leaves", "caches_from_reference",
           "caches_to_reference"]
