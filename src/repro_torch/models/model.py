"""Unified decoder-only LM of the port, covering every architecture family
of the reference (``repro.models.model``): dense GQA transformers, 5:1
local:global sliding-window stacks, pure SSD stacks, MoE FFNs and hybrid
mamba+attention+MoE interleaves, driven by ``ArchConfig.pattern_unit`` /
``ffn_unit``.

The reference stacks the layers of each scanned unit position and unrolls
the remainder; the port holds one flat list of layers in
``cfg.layer_plan()`` order, and its decode caches are one dict per layer.
The modality frontends of the [audio]/[vlm] entries are stubs, as in the
reference: ``prefix_embeds`` are concatenated in front of the token
embeddings.

``mesh`` and ``multi_pod`` are the reference's: with a mesh whose model
axis is larger than 1 every MoE FFN runs ``moe_ep`` over it (tokens past
an expert's capacity are dropped, so the values differ from the dense
MoE's); everything else the mesh touches is placement, which leaves the
values alone (``sharding.wsc``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from .layers import FFN, Attention, normal, rmsnorm
from .mamba2 import Mamba2, init_mamba_cache
from .moe import MoE
from .sharding import P, act_specs, wsc

__all__ = ["init_params", "forward", "loss_fn", "prefill", "decode_step", "init_caches",
           "LM", "Layer"]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class Layer(nn.Module):
    """One layer: pre-norm mixer (attention or Mamba-2) and pre-norm FFN
    (dense, MoE or none), each added to the residual stream.  Its
    submodules carry the reference's parameter names (``mix_norm``,
    ``attn``/``mamba``, ``ffn_norm``, ``ffn``/``moe``)."""

    def __init__(self, cfg: ArchConfig, mix: str, ffnk: str, gen=None, device=None):
        super().__init__()
        self.mix, self.ffnk, self.eps = mix, ffnk, cfg.norm_eps
        f32 = torch.float32
        self.mix_norm = nn.Parameter(torch.zeros((cfg.d_model,), dtype=f32, device=device))
        if mix in ("attn", "attn_local"):
            self.attn = Attention(cfg, mix, gen, device)
        elif mix == "mamba":
            self.mamba = Mamba2(cfg, gen, device)
        else:
            raise ValueError(mix)
        if ffnk in ("dense", "moe"):
            self.ffn_norm = nn.Parameter(torch.zeros((cfg.d_model,), dtype=f32, device=device))
            if ffnk == "dense":
                self.ffn = FFN(cfg, gen, device)
            else:
                self.moe = MoE(cfg, gen, device)
        elif ffnk != "none":
            raise ValueError(ffnk)

    def _ffn(self, x, mesh=None, multi_pod=False):
        if self.ffnk == "none":
            return x * 0.0, 0.0
        h = rmsnorm(x, self.ffn_norm, self.eps)
        if self.ffnk == "dense":
            return self.ffn(h), 0.0
        return self.moe(h, mesh, multi_pod)

    def forward(self, x, positions, return_cache=False, mesh=None, multi_pod=False):
        """(x, aux, cache): the layer over a whole sequence; a MoE FFN runs
        ``moe_ep`` over a ``mesh`` whose model axis is larger than 1."""
        h = rmsnorm(x, self.mix_norm, self.eps)
        if self.mix == "mamba":
            y, cache = self.mamba(h, return_cache=return_cache)
        else:
            y, cache = self.attn(h, positions=positions, return_cache=return_cache)
        x = x + y
        y2, aux = self._ffn(x, mesh, multi_pod)
        return x + y2, aux, cache

    def decode(self, x, cache, pos: int, mesh=None, multi_pod=False):
        """(x, cache): one token at position ``pos`` against the layer's cache."""
        h = rmsnorm(x, self.mix_norm, self.eps)
        if self.mix == "mamba":
            y, cache = self.mamba.decode(h, cache)
        else:
            y, cache = self.attn.decode(h, cache, pos)
        x = x + y
        y2, _ = self._ffn(x, mesh, multi_pod)
        return x + y2, cache


class LM(nn.Module):
    """The whole LM: token embedding, ``cfg.layer_plan()``'s layers, final
    norm and the head (``embed.T`` when the embeddings are tied): the
    ``params`` that ``forward``, ``prefill`` and ``decode_step`` take, as
    the reference's functions take its parameter tree.  Built from ``gen``
    on ``device``; on the ``meta`` device (no generator) it allocates
    nothing, for ``load_state_dict(..., assign=True)``."""

    def __init__(self, cfg: ArchConfig, gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg)
        self.embed = nn.Parameter(normal(gen, (cfg.vocab, cfg.d_model), dt, device, 0.02))
        self.final_norm = nn.Parameter(
            torch.zeros((cfg.d_model,), dtype=torch.float32, device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                normal(gen, (cfg.d_model, cfg.vocab), dt, device, cfg.d_model ** -0.5))
        self.layers = nn.ModuleList(Layer(cfg, mix, ffnk, gen, device)
                                    for mix, ffnk in cfg.layer_plan())

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def init_params(cfg: ArchConfig, gen: torch.Generator, device=None) -> LM:
    """A random LM drawn from ``gen``, which must live on ``device``
    (default: the card)."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"the generator is on {gen.device}, the parameters go to {dev}")
    return LM(cfg, gen, dev)


def _embed_tokens(cfg, params: LM, tokens, prefix_embeds):
    x = params.embed[tokens].to(_dtype(cfg))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _run_layers(layers, x, positions, collect_caches: bool, mesh, multi_pod):
    """(x, aux, caches) after ``layers`` in order."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    hidden = act_specs(multi_pod)["hidden"]
    for layer in layers:
        x, a, c = layer(x, positions, return_cache=collect_caches, mesh=mesh,
                        multi_pod=multi_pod)
        x = wsc(x, hidden, mesh)
        aux = aux + a
        caches.append(c)
    return x, aux, caches


def forward(cfg: ArchConfig, params: LM, tokens: torch.Tensor, *, mesh=None,
            multi_pod: bool = False, prefix_embeds: Optional[torch.Tensor] = None,
            remat: bool = True, collect_caches: bool = False):
    """Returns (logits (B,S,V), aux, caches|None); caches are one dict per
    layer.  With ``remat`` each whole unit of ``cfg.scan_split()`` (its
    ``len(unit)`` consecutive layers) is rematerialized in the backward
    pass, as the reference checkpoints its scanned unit body; the
    remainder layers are not."""
    sp = act_specs(multi_pod)
    x = wsc(_embed_tokens(cfg, params, tokens, prefix_embeds), sp["hidden"], mesh)
    positions = torch.arange(x.shape[1], device=x.device)
    n_units, unit, _ = cfg.scan_split()
    U = len(unit)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for u in range(n_units):
        layers = params.layers[u * U:(u + 1) * U]
        if remat:
            x, a, c = checkpoint(_run_layers, layers, x, positions, collect_caches, mesh,
                                 multi_pod, use_reentrant=False)
        else:
            x, a, c = _run_layers(layers, x, positions, collect_caches, mesh, multi_pod)
        aux = aux + a
        caches += c
    x, a, c = _run_layers(params.layers[n_units * U:], x, positions, collect_caches, mesh,
                          multi_pod)
    aux = aux + a
    caches += c
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = wsc(x @ params.head(), sp["logits"], mesh)
    return logits, aux, caches if collect_caches else None


def loss_fn(cfg: ArchConfig, params: LM, batch: dict, *, mesh=None, multi_pod: bool = False,
            remat: bool = True):
    """Next-token CE on the full-length forward, shifted on the label side,
    plus 0.01 x the MoE aux loss: (loss, {"ce", "aux"})."""
    tokens = batch["tokens"]
    prefix = batch.get("prefix_embeds")
    logits, aux, _ = forward(cfg, params, tokens, mesh=mesh, multi_pod=multi_pod,
                             prefix_embeds=prefix, remat=remat)
    npfx = 0 if prefix is None else prefix.shape[1]
    if npfx:
        logits = logits[:, npfx:]
    logits = logits[:, :-1]                      # predict token t+1 from t
    labels = tokens[:, 1:]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, labels[..., None])[..., 0]
    ce = torch.mean(lse - tgt)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------------
# serving: prefill + single-token decode
# --------------------------------------------------------------------------


@torch.no_grad()
def prefill(cfg: ArchConfig, params: LM, tokens: torch.Tensor, *, mesh=None,
            multi_pod: bool = False, prefix_embeds: Optional[torch.Tensor] = None):
    """Full-sequence forward that also emits per-layer caches; returns
    (last-position logits, caches)."""
    logits, _, caches = forward(cfg, params, tokens, mesh=mesh, multi_pod=multi_pod,
                                prefix_embeds=prefix_embeds, remat=False,
                                collect_caches=True)
    return logits[:, -1], caches


def init_caches(cfg: ArchConfig, batch: int, max_seq: int, device=None) -> List[dict]:
    """Zeroed decode caches, one dict per layer (default device: the card)."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    out = []
    for mix, _ in cfg.layer_plan():
        if mix == "mamba":
            s = cfg.ssm
            out.append(init_mamba_cache(batch, cfg.d_model, s.d_state, s.headdim, s.expand,
                                        s.conv_width, dt, dev))
            continue
        w = max_seq if mix == "attn" else min(cfg.sliding_window, max_seq)
        shape = (batch, w, cfg.n_kv_heads, cfg.d_head)
        out.append({"k": torch.zeros(shape, dtype=dt, device=dev),
                    "v": torch.zeros(shape, dtype=dt, device=dev)})
    return out


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: LM, token: torch.Tensor, caches: List[dict],
                pos: int, *, mesh=None, multi_pod: bool = False):
    """One-token decode: (B,) token ids + caches -> ((B,V) logits, caches).

    The attention layers' K/V tensors in ``caches`` are written in place
    (the reference donates its caches to the jitted step); carry on with
    the returned list, whose Mamba entries are new tensors."""
    x = params.embed[token[:, None]].to(_dtype(cfg))
    new = []
    for layer, cache in zip(params.layers, caches):
        x, c = layer.decode(x, cache, pos, mesh, multi_pod)
        new.append(c)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    sp = act_specs(multi_pod)["logits"]
    return wsc((x @ params.head())[:, 0], P(sp[0], sp[2]), mesh), new
