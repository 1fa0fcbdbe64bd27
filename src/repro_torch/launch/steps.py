"""The train, prefill and decode steps of the port (the torch twin of
``repro.launch.steps``) and the abstract state they run on.

The reference builds these for a mesh and jits them with explicit
shardings; the port runs them eagerly on one device.  The mesh specs
(``state_specs``, ``norm_spec``) come with the mesh slice (``ROADMAP.md``,
Queue 1 item 4c) and the dry-run's ``input_specs`` with item 4d.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ArchConfig
from ..models.convert import reference_leaves
from ..models.model import LM, decode_step, loss_fn, prefill
from ..optim.adamw import adamw_init, adamw_update
from ..optim.compression import compress_decompress

__all__ = ["make_train_step", "make_prefill", "make_decode_step", "abstract_params",
           "abstract_opt"]


def abstract_params(cfg: ArchConfig) -> LM:
    """The LM on the ``meta`` device: every parameter's shape and dtype, no
    storage."""
    return LM(cfg, device=torch.device("meta"))


def abstract_opt(aparams):
    """The optimizer state of ``aparams`` (an ``LM`` or name -> tensor) on
    their device; on the ``meta`` device it allocates nothing."""
    if isinstance(aparams, torch.nn.Module):
        aparams = dict(aparams.named_parameters())
    return adamw_init(aparams)


def make_train_step(cfg: ArchConfig, *, lr: float = 3e-4, remat: bool = True,
                    compress_grads: bool = False):
    """``train_step(params, opt, batch) -> (params, opt, {"loss", "ce",
    "gnorm"})``: the loss and its gradients by autograd, int8 error-feedback
    compression of the gradients when ``compress_grads`` (``opt`` is then
    ``(AdamWState, residuals)``; one scale per reference leaf, so the
    layers of a scanned unit position share theirs), and one AdamW step.
    ``params`` is the ``LM``; it and the optimizer state are updated in
    place (the reference donates both to its jitted step) and returned."""

    groups = reference_leaves(cfg) if compress_grads else None

    def train_step(params: LM, opt, batch: Dict[str, torch.Tensor]):
        if compress_grads:
            opt, residuals = opt
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        loss, metrics = loss_fn(cfg, params, batch, remat=remat)
        loss.backward()
        grads = {k: p.grad for k, p in named.items()}
        for p in named.values():
            p.grad = None
        if compress_grads:
            grads, residuals = compress_decompress(grads, residuals, groups)
        _, opt, gnorm = adamw_update(grads, opt, named, lr=lr)
        if compress_grads:
            opt = (opt, residuals)
        return params, opt, {"loss": loss.detach(), "ce": metrics["ce"].detach(),
                             "gnorm": gnorm}

    return train_step


def make_prefill(cfg: ArchConfig):
    """``prefill_step(params, batch) -> (last-position logits, caches)``."""

    def prefill_step(params: LM, batch):
        return prefill(cfg, params, batch["tokens"], prefix_embeds=batch.get("prefix_embeds"))

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``serve_step(params, token, caches, pos) -> (logits, caches)``; the
    attention caches are written in place, as the reference donates them."""

    def serve_step(params: LM, token, caches, pos):
        return decode_step(cfg, params, token, caches, pos)

    return serve_step
