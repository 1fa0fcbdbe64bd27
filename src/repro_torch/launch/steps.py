"""The train, prefill and decode steps of the port (the torch twin of
``repro.launch.steps``), the abstract state they run on and its shardings.

The reference builds these for a mesh and jits them with explicit
shardings; the port runs them eagerly, with the parameters and optimizer
state whole on one device, as the reference's own ``launch.train``
leaves them (its jit takes no shardings).  The mesh reaches the model,
whose MoE layers then run ``moe_ep`` over it.  ``state_specs`` gives the shardings
the reference would place the state with (``NamedSharding`` of
``models.sharding``), and ``input_specs`` the ``meta``-device inputs of a
dry-run cell.  The reference's ``compile_*`` builders lower and compile
for XLA; the port compiles nothing, and its dry run
(``launch.dryrun``) runs these same steps once on the ``meta`` device.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ArchConfig, Shape
from ..models.convert import reference_leaves
from ..models.model import LM, decode_step, init_caches, loss_fn, prefill
from ..models.sharding import P, NamedSharding, param_pspecs
from ..optim.adamw import AdamWState, adamw_init, adamw_update
from ..optim.compression import compress_decompress

__all__ = ["input_specs", "state_specs", "norm_spec", "make_train_step", "make_prefill",
           "make_decode_step", "abstract_params", "abstract_opt"]


def norm_spec(spec: P, shape, mesh) -> P:
    """Drop sharding on axes that don't divide the dimension (and entries
    past the tensor's rank)."""
    parts = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            parts.append(None)
            continue
        size = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            size *= mesh.shape[a]
        parts.append(ax if shape[i] % size == 0 else None)
    parts += [None] * (len(shape) - len(parts))
    return P(*parts)


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


def input_specs(cfg: ArchConfig, shape: Shape) -> dict:
    """``meta`` stand-ins for every model input of this cell, where the
    reference gives ``ShapeDtypeStruct``s: int32 tokens (as
    ``data.pipeline`` gives them) and float32 ``prefix_embeds`` for train
    and prefill; for decode one int32 token per sequence, the caches of an
    S-length context and a 0-d int32 position."""
    B, S = shape.batch, shape.seq
    meta = torch.device("meta")
    if shape.kind in ("train", "prefill"):
        out = {"tokens": torch.empty((B, S), dtype=torch.int32, device=meta)}
        if cfg.n_prefix:
            out["prefix_embeds"] = torch.empty((B, cfg.n_prefix, cfg.d_model),
                                               dtype=torch.float32, device=meta)
        return out
    return {"token": torch.empty((B,), dtype=torch.int32, device=meta),
            "caches": init_caches(cfg, B, S, device=meta),
            "pos": torch.empty((), dtype=torch.int32, device=meta)}


def state_specs(cfg: ArchConfig, mesh, multi_pod: bool):
    """(abstract params, abstract opt, param shardings, opt shardings):
    the ``meta``-device ``LM`` and optimizer state, and name ->
    ``NamedSharding`` of ``param_pspecs`` with the axes that do not divide
    dropped (``norm_spec``); the optimizer's moments and master share the
    parameters' and its step is replicated."""
    ap = abstract_params(cfg)
    specs = param_pspecs(ap, multi_pod)
    psh = {k: NamedSharding(mesh, norm_spec(specs[k], p.shape, mesh))
           for k, p in ap.named_parameters()}
    ao = abstract_opt(ap)
    osh = AdamWState(step=NamedSharding(mesh, P()), mu=psh, nu=psh, master=psh)
    return ap, ao, psh, osh


def make_train_step(cfg: ArchConfig, mesh=None, *, multi_pod: bool = False, lr: float = 3e-4,
                    remat: bool = True, compress_grads: bool = False):
    """``train_step(params, opt, batch) -> (params, opt, {"loss", "ce",
    "gnorm"})``: the loss and its gradients by autograd, int8 error-feedback
    compression of the gradients when ``compress_grads`` (``opt`` is then
    ``(AdamWState, residuals)``; one scale per reference leaf, so the
    layers of a scanned unit position share theirs), and one AdamW step.
    ``params`` is the ``LM``; it and the optimizer state are updated in
    place (the reference donates both to its jitted step) and returned.
    ``mesh`` (None: no mesh) and ``multi_pod`` go to ``loss_fn``."""

    groups = reference_leaves(cfg) if compress_grads else None

    def train_step(params: LM, opt, batch: Dict[str, torch.Tensor]):
        if compress_grads:
            opt, residuals = opt
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        loss, metrics = loss_fn(cfg, params, batch, mesh=mesh, multi_pod=multi_pod,
                                remat=remat)
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


def make_prefill(cfg: ArchConfig, mesh=None, *, multi_pod: bool = False):
    """``prefill_step(params, batch) -> (last-position logits, caches)``."""

    def prefill_step(params: LM, batch):
        return prefill(cfg, params, batch["tokens"], mesh=mesh, multi_pod=multi_pod,
                       prefix_embeds=batch.get("prefix_embeds"))

    return prefill_step


def make_decode_step(cfg: ArchConfig, mesh=None, *, multi_pod: bool = False):
    """``serve_step(params, token, caches, pos) -> (logits, caches)``; the
    attention caches are written in place, as the reference donates them."""

    def serve_step(params: LM, token, caches, pos):
        return decode_step(cfg, params, token, caches, pos, mesh=mesh, multi_pod=multi_pod)

    return serve_step
