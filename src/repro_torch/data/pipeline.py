"""Deterministic synthetic token pipeline with sharded, resumable batches
(the port's copy of ``repro.data.pipeline``; host numpy, bit for bit the
reference's batches).

Deterministic-by-step: batch(step) is a pure function of (seed, step), so a
restarted job replays the exact stream from its checkpoint cursor — the data
half of the fault-tolerance story.  A Zipf-ish unigram mixture with induced
bigram structure gives the LM something learnable (loss drops well below
log(V) within a few hundred steps on small models).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["TokenPipeline"]


@dataclass
class TokenPipeline:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    n_prefix: int = 0
    d_model: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        # zipf unigrams
        ranks = np.arange(1, self.vocab + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(self.vocab, size=(self.batch, self.seq), p=probs)
        # induced structure: with p=0.5, next token = (prev * 31 + 7) % vocab
        # (applied column-by-column so the bigram chain is consistent)
        mask = rng.random((self.batch, self.seq - 1)) < 0.5
        for j in range(1, self.seq):
            nxt = (toks[:, j - 1] * 31 + 7) % self.vocab
            toks[:, j] = np.where(mask[:, j - 1], nxt, toks[:, j])
        out = {"tokens": toks.astype(np.int32)}
        if self.n_prefix:
            out["prefix_embeds"] = rng.standard_normal(
                (self.batch, self.n_prefix, self.d_model), dtype=np.float32
            )
        return out
