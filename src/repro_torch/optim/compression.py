"""Int8 error-feedback gradient compression for the DP/pod-axis allreduce
(``repro.optim.compression``).

Quantize each gradient leaf to int8 with a per-leaf scale before the
data-parallel reduction, keep the quantization residual locally and add it
back next step (error feedback), so the compression bias does not
accumulate.  ``round`` is half-to-even, as ``jnp.round``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

__all__ = ["ef_init", "compress_decompress"]


def ef_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero float32 residuals, one per parameter."""
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


def compress_decompress(grads: Dict[str, torch.Tensor], residuals: Dict[str, torch.Tensor],
                        groups: Optional[Dict[str, str]] = None):
    """Returns (dequantized int8-grade grads, new residuals).

    Each group of leaves shares one scale, the largest magnitude over all
    of them; ``groups`` maps each leaf's name to its group, and without it
    every leaf is a group of its own.  The reference quantizes each leaf of
    its parameter tree, in which one leaf stacks a scanned unit position's
    layers: ``repro_torch.models.reference_leaves`` gives the LM's names
    that grouping.

    On a real pod the int8 payload is what crosses the pod axis; here the
    quantize->dequantize round trip (plus error feedback) is applied so
    training sees exactly the compressed values.
    """
    members: Dict[str, List[str]] = {}
    for k in grads:
        members.setdefault(k if groups is None else groups[k], []).append(k)
    deq, res = {}, {}
    for names in members.values():
        xs = [grads[k].float() + residuals[k] for k in names]
        amax = torch.stack([x.abs().max() for x in xs]).max()
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        for k, x in zip(names, xs):
            q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
            deq[k] = q.float() * scale
            res[k] = x - deq[k]
    return {k: deq[k] for k in grads}, {k: res[k] for k in grads}
