from .ops import repair_balance_device, walk_inputs
from .walk import repair_balance_walk, repair_balance_walk_ref, shared_k_limit

__all__ = ["repair_balance_device", "repair_balance_walk", "repair_balance_walk_ref",
           "shared_k_limit", "walk_inputs"]
