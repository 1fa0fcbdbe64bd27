"""Transformer building blocks of the LM port: RMSNorm, RoPE, GQA attention
(full, sliding-window, decode against a KV cache) and the dense FFN.

The plain functions carry the reference's names and arithmetic
(``repro.models.layers``); they take their parameters as a mapping of
name -> tensor with the reference's names, which the blocks below are.
Attention is *query-chunked*: a Python loop over query blocks stands in for
the reference's ``lax.scan``, so the (S, S) score matrix is never
materialised.  Scores, softmax and the value sum run in float32 (the
reference's default ``REPRO_ATTN_DTYPE=f32``), and the output is cast back
to the activations' dtype before ``wo``.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# REPRO_CACHE_UPDATE ("where" | "dus") picks how the reference writes the
# decode token into the KV cache.  Both write the same values; they differ
# only in how GSPMD partitions a sequence-sharded cache.  The port has no
# GSPMD and makes one indexed write whatever the switch says.
_CACHE_UPDATE = os.environ.get("REPRO_CACHE_UPDATE", "where")

__all__ = [
    "rmsnorm",
    "rope_table",
    "apply_rope",
    "attention",
    "decode_attention",
    "ffn",
    "init_attn_params",
    "init_ffn_params",
    "Attention",
    "FFN",
]

_NEG = -1e30

#: the reference's activations; ``jax.nn.gelu`` defaults to the tanh form
ACTS = {
    "silu": F.silu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope_table(positions: torch.Tensor, d_head: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin tables (..., d_head/2)."""
    half = d_head // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., H, d_head); cos/sin broadcastable (..., 1, d_head/2).  Split
    halves (not interleaved), computed in float32 and cast back."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def _acc_dtype(bf16_dtype: torch.dtype) -> torch.dtype:
    """Attention's matmul operand dtype: float32, or under
    ``REPRO_ATTN_DTYPE=bf16`` the given one (bf16 in prefill, the cache's
    dtype in decode, as in the reference).  "f32" keeps K/V/P in float32
    through the softmax pipeline.  The switch is read at each call, so a
    dry-run variant (``launch.dryrun.VARIANTS``) takes effect in-process."""
    return torch.float32 if os.environ.get("REPRO_ATTN_DTYPE", "f32") == "f32" else bf16_dtype


def _qkv(params, x, n_heads, n_kv, d_head):
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return (q.reshape(B, S, n_heads, d_head), k.reshape(B, S, n_kv, d_head),
            v.reshape(B, S, n_kv, d_head))


def attention(
    params,
    x: torch.Tensor,                # (B, S, D)
    *,
    n_heads: int,
    n_kv: int,
    d_head: int,
    rope_theta: float = 10_000.0,
    window: Optional[int] = None,   # sliding-window width (None = global)
    q_chunk: int = 1024,
    positions: Optional[torch.Tensor] = None,
    return_cache: bool = False,
):
    """Causal self-attention (training / prefill).  Query-chunked; the last
    chunk is shorter where the reference pads it (its padded rows are
    sliced away, and every query row is independent of the others)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(params, x, n_heads, n_kv, d_head)
    cos, sin = rope_table(positions, d_head, rope_theta)
    q = apply_rope(q, cos[:, None, :], sin[:, None, :])
    k = apply_rope(k, cos[:, None, :], sin[:, None, :])
    rep = n_heads // n_kv
    scale = d_head ** -0.5
    qc = max(1, min(q_chunk, S))

    acc_dt = _acc_dtype(torch.bfloat16)
    kT = k.to(acc_dt)
    vT = v.to(acc_dt)
    kpos = torch.arange(S, device=x.device)
    outs = []
    for start in range(0, S, qc):
        qb = q[:, start:start + qc]                      # (B, qc, H, dh)
        n = qb.shape[1]
        qpos = torch.arange(start, start + n, device=x.device)
        mask = qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        qg = qb.reshape(B, n, n_kv, rep, d_head)
        s = torch.einsum("bqgrd,bsgd->bgrqs", qg.to(acc_dt), kT).float() * scale
        s = s.masked_fill(~mask, _NEG)
        p = torch.softmax(s, dim=-1).to(acc_dt)
        o = torch.einsum("bgrqs,bsgd->bqgrd", p, vT).float()
        outs.append(o.reshape(B, n, n_heads, d_head))
    o = torch.cat(outs, dim=1)
    y = o.to(x.dtype).reshape(B, S, n_heads * d_head) @ params["wo"]
    if not return_cache:
        return y, None
    # serving cache: keep only the window for sliding-window layers
    if window is not None and S >= window:
        kc, vc = k[:, S - window:].contiguous(), v[:, S - window:].contiguous()
    else:
        kc, vc = k, v
    return y, {"k": kc, "v": vc}


def _attend(qg: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, n_valid: int,
            scale: float) -> torch.Tensor:
    """One query per (batch, KV group, repeat) against the cache's first
    ``n_valid`` slots: qg (B, G, R, dh), ck/cv (B, S_c, G, dh) -> (B, G, R,
    dh) float32.  The cache is contracted in the accumulation dtype (an f32
    cast of a bf16 cache where ``REPRO_ATTN_DTYPE=f32``, as JAX's promotion
    computes it)."""
    acc_dt = _acc_dtype(ck.dtype)
    s = torch.einsum("bgrd,bsgd->bgrs", qg.to(acc_dt), ck.to(acc_dt)).float() * scale
    s[..., n_valid:] = _NEG
    p = torch.softmax(s, dim=-1).to(acc_dt)
    return torch.einsum("bgrs,bsgd->bgrd", p, cv.to(acc_dt)).float()


def decode_attention(
    params,
    x: torch.Tensor,               # (B, 1, D)
    cache: dict,                   # {"k","v"}: (B, S_cache, n_kv, d_head)
    pos: int,                      # current position
    *,
    n_heads: int,
    n_kv: int,
    d_head: int,
    rope_theta: float = 10_000.0,
    window: Optional[int] = None,
):
    """Single-token decode with KV cache (ring buffer for windowed layers).

    Writes the token's K and V into ``cache`` in place (the reference
    donates the cache to its jitted step) and returns the same tensors.
    A position past a global cache's end raises ``IndexError`` (the
    reference drops or clamps that write)."""
    B = x.shape[0]
    ck, cv = cache["k"], cache["v"]
    S_c = ck.shape[1]
    q, k, v = _qkv(params, x, n_heads, n_kv, d_head)
    cos, sin = rope_table(torch.full((1,), pos, device=x.device), d_head, rope_theta)
    q = apply_rope(q, cos[:, None, :], sin[:, None, :])
    k = apply_rope(k, cos[:, None, :], sin[:, None, :])
    slot = pos % S_c if window is not None else pos
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    if window is not None:
        # ring buffer: all slots valid once full
        n_valid = S_c if pos >= S_c else slot + 1
    else:
        n_valid = pos + 1
    qg = q.reshape(B, n_kv, n_heads // n_kv, d_head)
    o = _attend(qg, ck, cv, n_valid, d_head ** -0.5)
    y = o.reshape(B, 1, n_heads * d_head).to(x.dtype) @ params["wo"]
    return y, {"k": ck, "v": cv}


# --------------------------------------------------------------------------
# FFN
# --------------------------------------------------------------------------


def ffn(params, x: torch.Tensor, *, glu: bool = True, act: str = "silu") -> torch.Tensor:
    a = ACTS[act]
    if glu:
        return (a(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]
    return a(x @ params["w_up"]) @ params["w_down"]


# --------------------------------------------------------------------------
# initializers and blocks
# --------------------------------------------------------------------------


def normal(gen: Optional[torch.Generator], shape, dtype, device, scale: float) -> torch.Tensor:
    """``scale`` times a standard normal draw in ``dtype`` (the reference's
    ``jax.random.normal(key, shape, dtype) * scale``); the generator lives
    on ``device`` (None on the ``meta`` device)."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * scale


def init_attn_params(gen, d_model, n_heads, n_kv, d_head, qkv_bias, dtype, device=None):
    sc = d_model ** -0.5
    p = {
        "wq": normal(gen, (d_model, n_heads * d_head), dtype, device, sc),
        "wk": normal(gen, (d_model, n_kv * d_head), dtype, device, sc),
        "wv": normal(gen, (d_model, n_kv * d_head), dtype, device, sc),
        "wo": normal(gen, (n_heads * d_head, d_model), dtype, device, sc),
    }
    if qkv_bias:
        for name, n in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros((n * d_head,), dtype=dtype, device=device)
    return p


def init_ffn_params(gen, d_model, d_ff, glu, dtype, device=None):
    si, so = d_model ** -0.5, d_ff ** -0.5
    p = {
        "w_up": normal(gen, (d_model, d_ff), dtype, device, si),
        "w_down": normal(gen, (d_ff, d_model), dtype, device, so),
    }
    if glu:
        p["w_gate"] = normal(gen, (d_model, d_ff), dtype, device, si)
    return p


class ParamBlock(nn.Module):
    """A block whose parameters carry the reference's names; it is itself
    the ``params`` mapping its plain function reads (``block["wq"]``,
    ``"bq" in block``)."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._parameters[name]

    def __contains__(self, name: str) -> bool:
        return name in self._parameters


class Attention(ParamBlock):
    """GQA attention of one layer: global (``mix="attn"``) or sliding-window
    (``mix="attn_local"``, with the local RoPE base)."""

    def __init__(self, cfg, mix: str, gen=None, device=None):
        super().__init__(init_attn_params(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.qkv_bias,
            getattr(torch, cfg.dtype), device))
        local = mix == "attn_local"
        self.window = cfg.sliding_window if local else None
        self.kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
                       rope_theta=cfg.rope_theta_local if local else cfg.rope_theta,
                       window=self.window)

    def forward(self, x, positions=None, return_cache=False):
        return attention(self, x, positions=positions, return_cache=return_cache, **self.kw)

    def decode(self, x, cache, pos):
        return decode_attention(self, x, cache, pos, **self.kw)


class FFN(ParamBlock):
    """Dense FFN of one layer (GLU or plain)."""

    def __init__(self, cfg, gen=None, device=None):
        super().__init__(init_ffn_params(gen, cfg.d_model, cfg.d_ff, cfg.glu,
                                         getattr(torch, cfg.dtype), device))
        self.glu, self.act = cfg.glu, cfg.act

    def forward(self, x):
        return ffn(self, x, glu=self.glu, act=self.act)
