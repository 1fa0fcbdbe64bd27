"""Architecture & shape configuration schema for the assigned-arch pool."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

__all__ = ["MoESpec", "SSMSpec", "ArchConfig", "Shape", "SHAPES"]


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    topk: int
    d_ff: int                 # per-expert hidden size
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMSpec:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                 # dense-FFN hidden size (0 = no dense FFN)
    vocab: int
    qkv_bias: bool = False
    glu: bool = True
    act: str = "silu"
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0
    norm_eps: float = 1e-6
    head_dim: Optional[int] = None          # default d_model // n_heads
    sliding_window: Optional[int] = None    # width for "attn_local" layers
    # repeating layer pattern; the stack is the unit repeated (+ remainder)
    pattern_unit: Tuple[str, ...] = ("attn",)        # attn | attn_local | mamba
    ffn_unit: Tuple[str, ...] = ("dense",)           # dense | moe | none
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    tie_embeddings: bool = False
    frontend: Optional[str] = None          # "audio" | "vision" (stub embeds)
    n_prefix: int = 0                       # stub frontend prefix length
    sub_quadratic: bool = False             # eligible for long_500k
    dtype: str = "bfloat16"
    source: str = ""                        # provenance tag

    @property
    def d_head(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_plan(self):
        """Full per-layer (mix, ffn) list of length n_layers."""
        u, f = self.pattern_unit, self.ffn_unit
        assert len(u) == len(f), (self.name, u, f)
        plan = []
        while len(plan) < self.n_layers:
            for m, ff in zip(u, f):
                plan.append((m, ff))
        return plan[: self.n_layers]

    def scan_split(self):
        """(n_units, unit, remainder_plan): scan over whole units."""
        u = len(self.pattern_unit)
        n_units = self.n_layers // u
        rem = self.layer_plan()[n_units * u :]
        return n_units, list(zip(self.pattern_unit, self.ffn_unit)), rem

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config: one forward/train step on CPU."""
        unit = len(self.pattern_unit)
        moe = (
            replace(self.moe, n_experts=min(self.moe.n_experts, 4),
                    topk=min(self.moe.topk, 2), d_ff=64)
            if self.moe
            else None
        )
        ssm = replace(self.ssm, d_state=16, headdim=8, chunk=16) if self.ssm else None
        kv = max(1, min(self.n_kv_heads, 2))
        heads = max(kv, 4 - (4 % kv))
        return replace(
            self,
            name=self.name + "-smoke",
            # two scanned units + a remainder layer iff the real config has one
            n_layers=2 * unit + (1 if self.n_layers % unit else 0),
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            sliding_window=8 if self.sliding_window else None,
            moe=moe,
            ssm=ssm,
            n_prefix=4 if self.frontend else 0,
            dtype="float32",
        )


@dataclass(frozen=True)
class Shape:
    name: str
    kind: str       # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}
