"""Mixture-of-Experts FFN of the LM port: the router and the dense MoE
(``repro.models.moe``'s ``router_topk`` and ``moe_dense``), the path the
reference takes without a mesh.  Every expert computes every token and the
top-k gates combine them.  The expert-parallel ``moe_ep`` (``shard_map`` and
``all_to_all`` over a mesh's model axis) comes with the expert-parallel
slice (``ROADMAP.md``, Queue 1 item 4c).
"""

from __future__ import annotations

import torch

from .layers import ACTS, ParamBlock, normal

__all__ = ["init_moe_params", "moe_dense", "router_topk", "MoE"]


def init_moe_params(gen, d_model, d_ff, n_experts, glu, dtype, device=None):
    si, so = d_model ** -0.5, d_ff ** -0.5
    p = {
        "router": normal(gen, (d_model, n_experts), torch.float32, device, si),
        "w_up": normal(gen, (n_experts, d_model, d_ff), dtype, device, si),
        "w_down": normal(gen, (n_experts, d_ff, d_model), dtype, device, so),
    }
    if glu:
        p["w_gate"] = normal(gen, (n_experts, d_model, d_ff), dtype, device, si)
    return p


def router_topk(x: torch.Tensor, router_w: torch.Tensor, topk: int):
    """x (T, D) -> (probs (T,k), idx (T,k), aux load-balancing loss), in
    float32.  ``jax.lax.top_k`` puts the lower index first among equal
    probabilities; ``torch.topk`` promises no order, so the port takes the
    first k of a stable descending sort, which does."""
    logits = (x.float() @ router_w).float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :topk], topi[:, :topk]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    E = router_w.shape[1]
    # Switch-style aux loss: E * sum_e mean_prob_e * mean_assign_e
    assign = torch.zeros((x.shape[0], E), dtype=torch.float32, device=x.device)
    assign.scatter_(1, topi, 1.0)
    aux = E * torch.sum(probs.mean(0) * assign.mean(0))
    return topv, topi, aux


def moe_dense(params, x: torch.Tensor, *, topk: int, glu: bool = True, act: str = "silu"):
    """Dense MoE: every expert computes every token (the reference's
    oracle and single-device path)."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    topv, topi, aux = router_topk(xt, params["router"], topk)
    E = params["router"].shape[1]
    a = ACTS[act]
    ys = []
    for e in range(E):
        if glu:
            h = a(xt @ params["w_gate"][e]) * (xt @ params["w_up"][e])
        else:
            h = a(xt @ params["w_up"][e])
        ys.append(h @ params["w_down"][e])
    ys = torch.stack(ys, dim=1)  # (T, E, D)
    # a row's top-k indices are distinct, so the reference's scatter-add
    # into zeros is this plain scatter
    gate = torch.zeros((xt.shape[0], E), dtype=ys.dtype, device=x.device)
    gate.scatter_(1, topi, topv.to(ys.dtype))
    y = torch.einsum("ted,te->td", ys, gate)
    return y.reshape(B, S, D), aux


class MoE(ParamBlock):
    """The MoE FFN of one layer (dense dispatch)."""

    def __init__(self, cfg, gen=None, device=None):
        m = cfg.moe
        super().__init__(init_moe_params(gen, cfg.d_model, m.d_ff, m.n_experts, cfg.glu,
                                         getattr(torch, cfg.dtype), device))
        self.topk, self.glu, self.act = m.topk, cfg.glu, cfg.act

    def forward(self, x):
        return moe_dense(self, x, topk=self.topk, glu=self.glu, act=self.act)
