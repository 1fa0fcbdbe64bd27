"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, vocab=151936, qkv_bias=True, glu=True, act="silu",
    rope_theta=1_000_000.0,
    pattern_unit=("attn",), ffn_unit=("dense",),
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)
