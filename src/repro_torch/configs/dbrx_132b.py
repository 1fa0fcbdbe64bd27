"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified]."""
from .base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab=100352, qkv_bias=False, glu=True, act="silu",
    rope_theta=500_000.0,
    pattern_unit=("attn",), ffn_unit=("moe",),
    moe=MoESpec(n_experts=16, topk=4, d_ff=10752),
    source="hf:databricks/dbrx-base; unverified",
)
