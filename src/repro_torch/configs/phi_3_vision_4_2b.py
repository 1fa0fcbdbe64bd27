"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (kv=32 => MHA) d_ff=8192
vocab=32064 — phi3-mini backbone + CLIP frontend (STUB: precomputed patch
embeddings) [hf:microsoft/Phi-3-vision-128k-instruct; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064, qkv_bias=False, glu=True, act="silu",
    pattern_unit=("attn",), ffn_unit=("dense",),
    frontend="vision", n_prefix=576,   # 24x24 CLIP patches
    source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
)
