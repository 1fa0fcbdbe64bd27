"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from .base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=0, vocab=49155, qkv_bias=False, glu=True, act="silu",
    pattern_unit=("attn",), ffn_unit=("moe",),
    moe=MoESpec(n_experts=32, topk=8, d_ff=512),
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
