"""Mixture-of-Experts FFN of the LM port (the torch twin of
``repro.models.moe``): the router, the dense MoE (every expert computes
every token; the reference's path without a mesh and its oracle) and the
expert-parallel ``moe_ep``, the reference's path when a mesh's model axis
is larger than 1.

``moe_ep`` follows the reference's ``shard_map`` body shard by shard, on
the devices of :class:`~repro_torch.launch.mesh.Mesh` coordinates:

  1. the tokens are split over the data axes (if they divide the batch)
     and over the model axis (if it divides a sequence longer than 1);
     otherwise the coordinates hold replicas, which compute the same
     tokens, so the port computes each distinct block once;
  2. local top-k routing; assignments are packed token-major into
     per-expert buffers of a capacity ``cap`` taken from the block's own
     token count (a stable sort by expert and ``searchsorted`` starts);
     assignments past ``cap`` are dropped and fall through on the
     residual;
  3. the all-to-all over the model axis: expert group ``j`` of every
     block of a data row goes to that row's coordinate ``j``
     (``.to(device)`` and ``torch.cat``);
  4. the owner's expert FFN on its slice of the whole weights (the
     reference all-gathers their FSDP-sharded ``D`` axis; autograd sums
     the slices' gradients as its ``psum_scatter`` would);
  5. the all-to-all back and the combine, each token's contributions
     added in ascending expert order in the activations' dtype (the order
     of the reference's scatter-add over slots), never by atomics.
"""

from __future__ import annotations

import math

import torch

from .layers import ACTS, ParamBlock, normal
from .sharding import DP, TP

__all__ = ["init_moe_params", "moe_dense", "moe_ep", "ep_blocks", "router_topk", "MoE"]


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


def _expert_ffn(xe, w_up, w_gate, w_down, glu: bool, act: str):
    """(E, C, D) rows through each expert's FFN (the reference's einsums)."""
    a = ACTS[act]
    if glu:
        h = a(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    else:
        h = a(torch.bmm(xe, w_up))
    return torch.bmm(h, w_down)


def _pack(xt, router_w, topk: int, n_experts: int, cap: int):
    """One shard's routing and packing: (buf (E, cap, D), topv, topi,
    pos (T, k) slot offsets, aux).  Assignment ``a = t * k + j`` is token
    t's j-th choice; a stable sort by expert gives each expert's
    assignments in that order, and assignment a sits at offset ``pos`` in
    its expert's buffer, dropped when ``pos >= cap``.  Each buffer row
    gathers the assignment that fills it (an empty row reads a zero row),
    so no index is written twice."""
    T, D = xt.shape
    dev = xt.device
    topv, topi, aux = router_topk(xt, router_w, topk)
    A = T * topk
    a_exp = topi.reshape(-1)
    order = torch.sort(a_exp, stable=True).indices
    se = a_exp[order]
    experts = torch.arange(n_experts, device=dev)
    start = torch.searchsorted(se, experts)
    count = torch.searchsorted(se, experts, right=True) - start
    pos_sorted = torch.arange(A, device=dev) - start[se]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted                       # a permutation: one write each
    c = torch.arange(cap, device=dev)
    at = (start[:, None] + c).clamp_max(A - 1)
    src = torch.where(c < count[:, None], order[at], A)        # (E, cap)
    xa = torch.cat([xt.unsqueeze(1).expand(T, topk, D).reshape(A, D),
                    xt.new_zeros((1, D))])
    return xa[src], topv, topi, pos.view(T, topk), aux


def _combine(back, topv, topi, pos, cap: int, dtype):
    """Token outputs from the expert outputs ``back`` (E, cap, D): each
    kept assignment's row times its gate, summed per token in ascending
    expert order (ascending slot order, as the reference's scatter-add
    applies them) in ``dtype``, one rounding per add."""
    E, _, D = back.shape
    T, k = topi.shape
    order = torch.argsort(topi, dim=1)            # a row's experts are distinct
    e = torch.gather(topi, 1, order)
    p = torch.gather(pos, 1, order)
    w = torch.gather(topv, 1, order)
    slot = torch.where(p < cap, e * cap + p, E * cap)       # dropped: a zero row
    rows = torch.cat([back.reshape(E * cap, D), back.new_zeros((1, D))])
    contrib = (rows[slot.reshape(-1)].view(T, k, D) * w.to(back.dtype)[..., None]).to(dtype)
    y = torch.zeros((T, D), dtype=dtype, device=back.device)
    for j in range(k):
        y = y + contrib[:, j]
    return y


def _coord(mesh, dp_axes, i: int, tp_axis: str, m: int):
    """The mesh coordinate of data row ``i`` (row-major over ``dp_axes``)
    and model index ``m``; other axes at 0."""
    at = {tp_axis: m}
    for a in reversed(dp_axes):
        at[a] = i % mesh.shape[a]
        i //= mesh.shape[a]
    return tuple(at.get(a, 0) for a in mesh.axis_names)


def ep_blocks(B: int, S: int, mesh, dp_axes, tp_axis: str, topk: int, n_experts: int,
              capacity_factor: float):
    """(blocks over the data axes, blocks over the model axis, capacity per
    expert) of ``moe_ep`` on (B, S) tokens: adaptive activation sharding,
    the batch over the data axes if they divide it, the sequence over the
    model axis if it divides a sequence longer than 1 (decode steps with
    S == 1 replicate over it; a batch the data axes do not divide
    replicates over them), and the capacity from a block's own tokens."""
    dp_size = math.prod(mesh.shape[a] for a in dp_axes)
    P_m = mesh.shape[tp_axis]
    nb = dp_size if B % dp_size == 0 else 1
    ns = P_m if (S > 1 and S % P_m == 0) else 1
    T = (B // nb) * (S // ns)
    return nb, ns, int(T * topk / n_experts * capacity_factor) + 1


def moe_ep(
    params,
    x: torch.Tensor,        # (B, S, D)
    *,
    mesh,
    topk: int,
    n_experts: int,
    capacity_factor: float = 1.25,
    glu: bool = True,
    act: str = "silu",
    dp_axes=("data",),
    tp_axis: str = "model",
    stats=None,
):
    """Expert-parallel MoE over ``mesh`` (see the module docstring):
    (y (B, S, D) on ``x``'s device, aux).  ``stats``, a dict if given,
    receives ``cap``, ``keep`` (per distinct block, data row major, the
    (T, k) mask of kept assignments in token-major order), ``dropped``
    (a tensor) and ``assignments``."""
    B, S, D = x.shape
    dp_axes = tuple(dp_axes)
    P_m = mesh.shape[tp_axis]
    dp_size = math.prod(mesh.shape[a] for a in dp_axes)
    E_local = n_experts // P_m
    assert E_local * P_m == n_experts, (n_experts, P_m)
    if D % dp_size:
        raise ValueError(f"d_model {D} does not split over the data axes ({dp_size})")
    nb, ns, cap = ep_blocks(B, S, mesh, dp_axes, tp_axis, topk, n_experts, capacity_factor)
    Bl, Sl = B // nb, S // ns
    T = Bl * Sl
    w_gate = params["w_gate"] if glu else None

    rows, auxes, keeps = [], [], []
    for i in range(nb):
        homes = [mesh.device(_coord(mesh, dp_axes, i, tp_axis, s)) for s in range(ns)]
        packs = []
        for s, dev in enumerate(homes):
            xt = x[i * Bl:(i + 1) * Bl, s * Sl:(s + 1) * Sl].to(dev).reshape(T, D)
            packs.append(_pack(xt, params["router"].to(dev), topk, n_experts, cap))
        # the all-to-all over the model axis, the owners' FFN and the way back
        back = [[] for _ in range(ns)]
        for j in range(P_m):
            own = mesh.device(_coord(mesh, dp_axes, i, tp_axis, j))
            ex = slice(j * E_local, (j + 1) * E_local)
            recv = torch.cat([pk[0][ex].to(own) for pk in packs], dim=1)
            ye = _expert_ffn(recv, params["w_up"][ex].to(own),
                             None if w_gate is None else w_gate[ex].to(own),
                             params["w_down"][ex].to(own), glu, act)
            for s, dev in enumerate(homes):
                back[s].append(ye[:, s * cap:(s + 1) * cap].to(dev))
        ys = []
        for s, (buf, topv, topi, pos, aux) in enumerate(packs):
            y = _combine(torch.cat(back[s]), topv, topi, pos, cap, buf.dtype)
            ys.append(y.view(Bl, Sl, D).to(x.device))
            auxes.append(aux.to(x.device))
            keeps.append(pos < cap)
        rows.append(torch.cat(ys, dim=1))
    y = torch.cat(rows, dim=0)
    # pmean over the data axes, then over the model axis
    aux = torch.stack(auxes).view(nb, ns).mean(0).mean()
    if stats is not None:
        stats.update(cap=cap, keep=keeps, assignments=nb * ns * T * topk,
                     dropped=sum((~k).sum().to(x.device) for k in keeps))
    return y, aux


class MoE(ParamBlock):
    """The MoE FFN of one layer: dense dispatch, or ``moe_ep`` when a mesh
    with a model axis larger than 1 is given.  ``dispatch`` holds the
    last ``moe_ep`` call's ``stats``."""

    def __init__(self, cfg, gen=None, device=None):
        m = cfg.moe
        super().__init__(init_moe_params(gen, cfg.d_model, m.d_ff, m.n_experts, cfg.glu,
                                         getattr(torch, cfg.dtype), device))
        self.topk, self.glu, self.act = m.topk, cfg.glu, cfg.act
        self.n_experts, self.capacity_factor = m.n_experts, m.capacity_factor
        self.dispatch: dict = {}

    def forward(self, x, mesh=None, multi_pod: bool = False):
        if mesh is None or mesh.shape.get(TP, 1) == 1:
            return moe_dense(self, x, topk=self.topk, glu=self.glu, act=self.act)
        stats = {}
        out = moe_ep(self, x, mesh=mesh, topk=self.topk, n_experts=self.n_experts,
                     capacity_factor=self.capacity_factor, glu=self.glu, act=self.act,
                     dp_axes=DP(multi_pod), tp_axis=TP, stats=stats)
        # set only once the call completes: remat's recompute may stop early
        self.dispatch = stats
        return out
