"""Batched serving driver of the port: prefill a request batch, then decode
greedily (the torch twin of ``repro.launch.serve``).

Example (reduced config on the CPU; leave ``--device`` out to run on the
card):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --smoke \\
      --batch 4 --prompt-len 32 --gen 16 --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch
import torch.nn.functional as F

from ..configs import get_config
from ..configs.base import ArchConfig
from ..device import resolve_device
from ..models.model import decode_step, init_params, prefill

__all__ = ["pad_caches", "make_inputs", "generate", "main"]


def pad_caches(cfg: ArchConfig, caches: List[dict], cur_len: int, max_len: int) -> List[dict]:
    """Grow prefill caches to decode capacity: each attention cache's ``k``
    and ``v`` whose sequence length is ``cur_len`` get ``max_len - cur_len``
    zero slots; every other cache keeps its shape.

    The reference picks the leaves to grow by shape (sequence axis ==
    ``cur_len`` and last axis == ``cfg.d_head``), which also grows a Mamba
    state whose head count equals ``cur_len`` and whose ``d_state`` equals
    ``d_head``, and its first decode step then fails.  The port picks them
    by name; wherever the reference serves, both grow the same tensors."""
    pad = max_len - cur_len
    out = []
    for c in caches:
        if pad > 0 and "k" in c and c["k"].shape[1] == cur_len:
            c = {name: F.pad(t, (0, 0, 0, 0, 0, pad)) for name, t in c.items()}
        out.append(c)
    return out


def make_inputs(cfg: ArchConfig, seed: int, batch: int, prompt_len: int,
                device: torch.device):
    """(model, prompts, prefix_embeds) drawn from one generator seeded with
    ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = init_params(cfg, gen, device)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen, device=device)
    pe = (torch.randn((batch, cfg.n_prefix, cfg.d_model), generator=gen, device=device)
          if cfg.n_prefix else None)
    return model, prompts, pe


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg: ArchConfig, model, prompts: torch.Tensor,
             prefix_embeds: Optional[torch.Tensor], gen: int) -> torch.Tensor:
    """Prefill ``prompts`` (B, S), grow the caches, then decode ``gen``
    greedy tokens (the first from the prefill's logits); prints the
    reference's three lines and returns the (B, gen) tokens."""
    dev = prompts.device
    B, S = prompts.shape
    cur = S + cfg.n_prefix
    t0 = time.perf_counter()
    last_logits, caches = prefill(cfg, model, prompts, prefix_embeds=prefix_embeds)
    caches = pad_caches(cfg, caches, cur, cur + gen)
    _sync(dev)
    print(f"[prefill] {B}x{S} in {time.perf_counter() - t0:.1f}s", flush=True)

    tok = last_logits.argmax(-1)                 # the first maximum, as jnp.argmax
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = decode_step(cfg, model, tok, caches, cur + i)
        tok = logits.argmax(-1)
        out.append(tok)
    toks = torch.stack(out, dim=1)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"[decode] {gen - 1} steps in {dt:.1f}s "
          f"({(gen - 1) * B / max(dt, 1e-9):.1f} tok/s)", flush=True)
    print("[sample tokens]", toks[0].cpu().numpy()[:16], flush=True)
    return toks


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    dev = resolve_device(args.device)
    model, prompts, pe = make_inputs(cfg, args.seed, args.batch, args.prompt_len, dev)
    return generate(cfg, model, prompts, pe, args.gen)


if __name__ == "__main__":
    main()
