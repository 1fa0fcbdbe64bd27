"""AdamW with decoupled weight decay, global-norm clipping and mixed
precision (bf16 params + float32 master/optimizer states), the torch twin
of ``repro.optim.adamw`` with its arithmetic and operation order.

The reference builds new trees; the port updates its state and the
parameters in place, one leaf at a time, so that a full-width step holds
one leaf's float32 temporaries at a time rather than a float32 copy of
every gradient.  ``torch.optim.AdamW`` is not a substitute: it applies the
decay before the moment update, as ``p * (1 - lr * wd)``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Union

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update"]


class AdamWState(NamedTuple):
    step: torch.Tensor    # int32 scalar
    mu: dict
    nu: dict
    master: dict          # float32 master copy of params


def adamw_init(params: Dict[str, torch.Tensor]) -> AdamWState:
    """Zero moments and a float32 master of ``params`` (name -> tensor).
    The master is a copy even of a float32 parameter, which the in-place
    update would otherwise write twice."""
    dev = next(iter(params.values())).device
    f32 = torch.float32
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu={k: torch.zeros_like(p, dtype=f32) for k, p in params.items()},
        nu={k: torch.zeros_like(p, dtype=f32) for k, p in params.items()},
        master={k: p.detach().to(f32, copy=True) for k, p in params.items()},
    )


@torch.no_grad()
def adamw_update(
    grads: Dict[str, torch.Tensor],
    state: AdamWState,
    params: Dict[str, torch.Tensor],
    *,
    lr: Union[float, torch.Tensor] = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
):
    """One step: returns ``(params, state, gnorm)``, ``gnorm`` taken before
    clipping.  ``state``'s moments and master and the tensors of ``params``
    are written in place (the parameters get the master cast to their
    dtype); the returned state holds the same dicts and a new step."""
    gnorm = torch.sqrt(
        sum(torch.sum(g * g) for g in (g.float() for g in grads.values())) + 1e-12)
    scale = torch.clamp_max(clip_norm / gnorm, 1.0)
    step = state.step + 1
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    for k, g in grads.items():
        g = g.float() * scale
        mu, nu, m = state.mu[k], state.nu[k], state.master[k]
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        mhat = mu / c1
        nhat = nu / c2
        m.sub_(lr * (mhat / (torch.sqrt(nhat) + eps) + weight_decay * m))
        params[k].copy_(m)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu, master=state.master), gnorm
