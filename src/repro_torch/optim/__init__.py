"""The port's optimizer (the torch twin of ``repro.optim``): AdamW with
decoupled weight decay, global-norm clipping and a float32 master, int8
error-feedback gradient compression, and the warmup-cosine schedule.
States are dicts keyed by the LM's ``named_parameters()`` names."""

from .adamw import AdamWState, adamw_init, adamw_update
from .compression import compress_decompress, ef_init
from .schedule import warmup_cosine

__all__ = ["AdamWState", "adamw_init", "adamw_update", "warmup_cosine",
           "ef_init", "compress_decompress"]
