"""--arch <id> registry for all assigned architectures."""

from .base import SHAPES, ArchConfig, Shape
from .dbrx_132b import CONFIG as _dbrx
from .gemma3_27b import CONFIG as _gemma3
from .granite_moe_1b_a400m import CONFIG as _granite
from .internlm2_20b import CONFIG as _internlm2
from .jamba_1_5_large_398b import CONFIG as _jamba
from .mamba2_2_7b import CONFIG as _mamba2
from .musicgen_large import CONFIG as _musicgen
from .phi_3_vision_4_2b import CONFIG as _phi3v
from .qwen1_5_110b import CONFIG as _qwen110
from .qwen2_5_3b import CONFIG as _qwen3b

ARCHS = {
    "qwen2.5-3b": _qwen3b,
    "qwen1.5-110b": _qwen110,
    "gemma3-27b": _gemma3,
    "internlm2-20b": _internlm2,
    "musicgen-large": _musicgen,
    "phi-3-vision-4.2b": _phi3v,
    "mamba2-2.7b": _mamba2,
    "dbrx-132b": _dbrx,
    "granite-moe-1b-a400m": _granite,
    "jamba-1.5-large-398b": _jamba,
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def cells():
    """All (arch, shape) dry-run cells, with skip reasons where applicable."""
    out = []
    for aid, cfg in ARCHS.items():
        for sname, shape in SHAPES.items():
            skip = None
            if sname == "long_500k" and not cfg.sub_quadratic:
                skip = "pure full-attention stack: no sub-quadratic mechanism"
            out.append((aid, sname, skip))
    return out
