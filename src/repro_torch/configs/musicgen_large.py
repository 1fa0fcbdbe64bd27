"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32 => MHA) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].
The EnCodec/conditioning frontend is a STUB: input_specs provide
precomputed conditioning frame embeddings (prefix_embeds)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048, qkv_bias=False, glu=False, act="gelu",
    pattern_unit=("attn",), ffn_unit=("dense",),
    frontend="audio", n_prefix=64,
    source="arXiv:2306.05284; hf",
)
