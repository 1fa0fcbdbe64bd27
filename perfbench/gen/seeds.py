"""Seeds derived from ``--seed``: one stream per purpose and index, so that
item ``i`` of a pool is the same whatever the pool's size."""

from __future__ import annotations

import numpy as np

GRAPH, PERM, PARTITION, STREAM, SAMPLE = range(5)


def derive(seed: int, purpose: int, index: int = 0) -> int:
    """A 63-bit seed from ``(seed, purpose, index)``; ``seed`` may be any
    non-negative integer, larger than 32 bits too."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"--seed must be non-negative, got {seed}")
    words = [seed & 0xFFFFFFFF, seed >> 32, purpose, index]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def torch_generator(seed: int, purpose: int, index: int, device):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, purpose, index))
    return g
