"""PyTorch/CUDA port of the multilevel graph partitioner.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``graph``, ``core``, ``kernels``, ``obs``) so each module's counterpart is
easy to find.  It imports ``torch`` and numpy, never ``jax`` and never
``repro``.  Entry points take ``device=None`` and then run on CUDA; on a
machine without a CUDA device they raise instead of falling back to the
CPU (pass ``device="cpu"`` to run on the CPU, as the parity tests do).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
