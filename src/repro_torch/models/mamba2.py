"""Mamba-2 (SSD, state-space duality) block of the LM port, in the
reference's chunked-scan formulation (``repro.models.mamba2``).

The SSD recurrence per head h (state size N, head dim P):

    h_t = a_t * h_{t-1} + dt_t * B_t (x) x_t        a_t = exp(dt_t * A_h)
    y_t = C_t . h_t + D_h * x_t

computed chunk-parallel (arXiv:2405.21060): within a chunk of Q tokens the
quadratic "attention-like" form, per block of heads so the (B, Q, Q, hb)
working set stays bounded; across chunks a Python loop (the reference's
``lax.scan``) carries the float32 (B, H, P, N) state.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from .layers import ParamBlock, normal, rmsnorm

__all__ = ["init_mamba_params", "mamba_block", "mamba_decode", "init_mamba_cache",
           "Mamba2"]


def init_mamba_params(gen, d_model, d_state, headdim, expand, conv_width, dtype,
                      device=None):
    d_inner = expand * d_model
    H = d_inner // headdim
    sc = d_model ** -0.5
    f32 = torch.float32
    return {
        "wz": normal(gen, (d_model, d_inner), dtype, device, sc),
        "wx": normal(gen, (d_model, d_inner), dtype, device, sc),
        "wB": normal(gen, (d_model, d_state), dtype, device, sc),
        "wC": normal(gen, (d_model, d_state), dtype, device, sc),
        "wdt": normal(gen, (d_model, H), dtype, device, sc),
        "dt_bias": torch.zeros((H,), dtype=f32, device=device),
        "A_log": torch.zeros((H,), dtype=f32, device=device),
        "D_skip": torch.ones((H,), dtype=f32, device=device),
        "conv_w": normal(gen, (conv_width, d_inner), dtype, device, 0.2),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "norm_w": torch.zeros((d_inner,), dtype=f32, device=device),
        "wo": normal(gen, (d_inner, d_model), dtype, device, d_inner ** -0.5),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)).  ``F.softplus`` returns x itself above its threshold
    (20) and log1p(exp(x)) below it; this is the reference's formula."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B,S,C), w (W,C) causal depthwise conv + bias."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i: i + x.shape[1]] * w[i][None, None, :] for i in range(W))
    return out + b[None, None, :]


def _ssd_chunked(X, dt, A, Bm, Cm, h0, chunk: int, head_block: int = 8):
    """X (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,N), h0 (B,H,P,N).

    A loop over chunks carries the state; within a chunk the quadratic term
    is computed per *head block*.  ``REPRO_SSD_CHUNK`` overrides the chunk
    length and ``REPRO_SSD_DTYPE=bf16`` keeps the X/B/C streams in bf16, as
    in the reference; decay cumsums, exps and the state stay float32.
    Returns (Y (B,S,H,P) float32, h_final)."""
    B, S0, H, Pd = X.shape
    Q = int(os.environ.get("REPRO_SSD_CHUNK", "0")) or chunk
    Q = min(Q, S0)
    nc = (S0 + Q - 1) // Q
    S = nc * Q
    if S != S0:
        # pad with dt=0 steps: decay exp(0)=1 and zero input leave the
        # carried state untouched; padded outputs are sliced away below
        X = F.pad(X, (0, 0, 0, 0, 0, S - S0))
        dt = F.pad(dt, (0, 0, 0, S - S0))
        Bm = F.pad(Bm, (0, 0, 0, S - S0))
        Cm = F.pad(Cm, (0, 0, 0, S - S0))
    hb = head_block
    while H % hb:
        hb //= 2
    la = dt * A[None, None, :]                      # log a_t  (B,S,H), negative
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=X.device))

    ssd_dt = torch.bfloat16 if os.environ.get("REPRO_SSD_DTYPE") == "bf16" else torch.float32
    Xc = X.to(ssd_dt).reshape(B, nc, Q, H, Pd)
    dtc, lac = dt.reshape(B, nc, Q, H), la.reshape(B, nc, Q, H)
    Bc, Cc = Bm.to(ssd_dt).reshape(B, nc, Q, -1), Cm.to(ssd_dt).reshape(B, nc, Q, -1)

    h = h0.float()
    Ys = []
    for c in range(nc):
        Xq, dtq, laq, Bq, Cq = Xc[:, c], dtc[:, c], lac[:, c], Bc[:, c], Cc[:, c]
        cs = torch.cumsum(laq, dim=1)               # (B,Q,H) inclusive
        seg = cs[:, -1, :]                          # (B,H)
        CB = torch.einsum("bqn,bsn->bqs", Cq, Bq).float()
        Yi = []
        for h_lo in range(0, H, hb):                # intra-chunk, head-blocked
            csb = cs[:, :, h_lo:h_lo + hb]
            # the exponent is masked before exp: above the diagonal it is
            # positive and overflows to inf at long chunks, and the
            # backward of a where() after exp multiplies that inf by 0
            M = torch.exp(torch.where(tri[None, :, :, None],
                                      csb[:, :, None, :] - csb[:, None, :, :],
                                      float("-inf")))               # (B,Q,Q,hb)
            Xb = Xq[:, :, h_lo:h_lo + hb]
            sc = (CB[:, :, :, None] * M * dtq[:, None, :, h_lo:h_lo + hb]).to(Xb.dtype)
            Yi.append(torch.einsum("bqsh,bshp->bqhp", sc, Xb).float())
        Y_intra = torch.cat(Yi, dim=2)
        # inter-chunk from carried state
        Y_inter = torch.einsum("bqn,bqh,bhpn->bqhp", Cq.float(), torch.exp(cs), h)
        # state update
        dec_to_end = torch.exp(seg[:, None, :] - cs)                # (B,Q,H)
        st = torch.einsum("bqh,bqn,bqhp->bhpn", dtq * dec_to_end, Bq.float(), Xq.float())
        h = torch.exp(seg)[:, :, None, None] * h + st
        Ys.append(Y_intra + Y_inter)
    Y = torch.stack(Ys, dim=1).reshape(B, S, H, Pd)[:, :S0]
    return Y, h


def mamba_block(
    params,
    x: torch.Tensor,                 # (B,S,D)
    *,
    d_state: int,
    headdim: int,
    chunk: int = 256,
    h0: Optional[torch.Tensor] = None,
    return_cache: bool = False,
):
    B, S, D = x.shape
    d_inner = params["wx"].shape[1]
    H = d_inner // headdim
    z = x @ params["wz"]
    xr = x @ params["wx"]
    xc = F.silu(_causal_depthwise_conv(xr, params["conv_w"], params["conv_b"]))
    Bm = x @ params["wB"]
    Cm = x @ params["wC"]
    dt = _softplus((x @ params["wdt"]).float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])
    X = xc.reshape(B, S, H, headdim)
    if h0 is None:
        h0 = torch.zeros((B, H, headdim, d_state), dtype=torch.float32, device=x.device)
    Y, h_fin = _ssd_chunked(X, dt, A, Bm, Cm, h0, chunk)
    Y = Y + params["D_skip"][None, None, :, None] * X.float()
    y = Y.reshape(B, S, d_inner).to(x.dtype)
    # the block's norm uses the default eps, not cfg.norm_eps
    y = rmsnorm(y * F.silu(z), params["norm_w"])
    out = y @ params["wo"]
    if not return_cache:
        return out, None
    # the last W-1 raw inputs of the conv (a copy: a slice would hold xr)
    W = params["conv_w"].shape[0]
    conv_cache = xr[:, -(W - 1):].clone() if S >= W - 1 else F.pad(xr, (0, 0, W - 1 - S, 0))
    return out, {"h": h_fin, "conv": conv_cache}


def init_mamba_cache(batch, d_model, d_state, headdim, expand, conv_width, dtype,
                     device=None):
    d_inner = expand * d_model
    H = d_inner // headdim
    return {
        "h": torch.zeros((batch, H, headdim, d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, conv_width - 1, d_inner), dtype=dtype, device=device),
    }


def mamba_decode(
    params,
    x: torch.Tensor,                 # (B,1,D)
    cache: dict,
    *,
    d_state: int,
    headdim: int,
):
    """Single-token recurrent step: O(1) state update (the SSM decode
    path).  Returns new state tensors; ``cache`` is left as it was."""
    B = x.shape[0]
    d_inner = params["wx"].shape[1]
    H = d_inner // headdim
    z = x @ params["wz"]
    xr = x @ params["wx"]                            # (B,1,d_inner)
    hist = torch.cat([cache["conv"], xr], dim=1)     # (B,W,d_inner)
    conv_out = torch.einsum("bwc,wc->bc", hist, params["conv_w"]) + params["conv_b"]
    xc = F.silu(conv_out)[:, None, :]                # (B,1,d_inner)
    Bm = (x @ params["wB"])[:, 0]                    # (B,N)
    Cm = (x @ params["wC"])[:, 0]
    dt = _softplus((x @ params["wdt"])[:, 0].float() + params["dt_bias"][None, :])  # (B,H)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt * A[None, :])                   # (B,H)
    X = xc.reshape(B, H, headdim)
    h = cache["h"] * a[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, Bm.float(), X.float())
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), h)
    y = y + params["D_skip"][None, :, None] * X.float()
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), params["norm_w"])
    out = y @ params["wo"]
    return out, {"h": h, "conv": hist[:, 1:]}


class Mamba2(ParamBlock):
    """The Mamba-2 mixer of one layer."""

    def __init__(self, cfg, gen=None, device=None):
        s = cfg.ssm
        super().__init__(init_mamba_params(gen, cfg.d_model, s.d_state, s.headdim, s.expand,
                                           s.conv_width, getattr(torch, cfg.dtype), device))
        self.d_state, self.headdim, self.chunk = s.d_state, s.headdim, s.chunk

    def forward(self, x, return_cache=False):
        return mamba_block(self, x, d_state=self.d_state, headdim=self.headdim,
                           chunk=self.chunk, return_cache=return_cache)

    def decode(self, x, cache):
        return mamba_decode(self, x, cache, d_state=self.d_state, headdim=self.headdim)
