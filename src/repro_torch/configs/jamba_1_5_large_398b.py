"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16e top-2 — Mamba+attention 1:7 interleave, MoE every
other layer [arXiv:2403.19887; hf]."""
from .base import ArchConfig, MoESpec, SSMSpec

# one Jamba block = 8 layers: attention at position 4, mamba elsewhere;
# MoE on odd positions (every other layer), dense FFN on even positions.
_MIX = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")
_FFN = ("dense", "moe") * 4

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536, qkv_bias=False, glu=True, act="silu",
    pattern_unit=_MIX, ffn_unit=_FFN,
    moe=MoESpec(n_experts=16, topk=2, d_ff=24576),
    ssm=SSMSpec(d_state=128, headdim=64, expand=2, conv_width=4, chunk=256),
    sub_quadratic=True,
    source="arXiv:2403.19887; hf",
)
