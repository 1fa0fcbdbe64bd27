"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global sliding-window, 128k context
[hf:google/gemma-3-1b-pt; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab=262144, qkv_bias=False, glu=True, act="gelu",
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    sliding_window=1024,
    # 5 local : 1 global, repeated; 62 = 10 units + 2 remainder (local)
    pattern_unit=("attn_local",) * 5 + ("attn",),
    ffn_unit=("dense",) * 6,
    sub_quadratic=True,  # 5/6 of layers have O(S*w) attention + windowed KV
    source="hf:google/gemma-3-1b-pt; unverified",
)
