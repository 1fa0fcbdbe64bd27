"""mamba2-2.7b [ssm]: 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from .base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,  # attention unused
    d_ff=0, vocab=50280, glu=True, act="silu",
    pattern_unit=("mamba",), ffn_unit=("none",),
    ssm=SSMSpec(d_state=128, headdim=64, expand=2, conv_width=4, chunk=256),
    tie_embeddings=True,
    sub_quadratic=True,
    source="arXiv:2405.21060; unverified",
)
