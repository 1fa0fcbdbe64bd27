"""mini-lm: a ~60M-param dense LM for the end-to-end CPU training demo
(deliverable: train a ~100M-class model for a few hundred steps).  NOT part
of the assigned-architecture pool (excluded from the dry-run cell grid)."""
from .base import ArchConfig

MINI_LM = ArchConfig(
    name="mini-lm", family="dense",
    n_layers=12, d_model=512, n_heads=8, n_kv_heads=2, head_dim=64,
    d_ff=2048, vocab=16384, qkv_bias=False, glu=True, act="silu",
    pattern_unit=("attn",), ffn_unit=("dense",),
    dtype="float32",
    source="local demo config",
)
