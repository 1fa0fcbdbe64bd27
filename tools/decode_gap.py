#!/usr/bin/env python3
"""How far the first decode step's logits stray from forward's logits at
the same position, by depth and dtype: an LM of an architecture's full
width, cut to each depth asked for, draws its weights from one seed; it
prefills S tokens, decodes token S + 1, and runs forward over the S + 1
tokens.  Prints one JSON line per (depth, dtype) with ||d|| / ||forward||
and max |d|.  Exact arithmetic gives 0; what remains is rounding, so the
float32 rows show whether the two paths compute the same function and the
bfloat16 rows how much bf16 rounding the stack amplifies.

    PYTHONPATH=src python tools/decode_gap.py --arch mamba2-2.7b --layers 4 16 --device cpu
    PYTHONPATH=src python tools/decode_gap.py --arch mamba2-2.7b --layers 4 16 --reference

``--reference`` also runs the reference package (JAX, on the CPU) on the
same weights, stacked into its parameter tree; its rows carry
``"package": "repro"``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _gap(torch, first, full) -> dict:
    d = first.float() - full.float()
    return dict(rel_l2=float(d.norm() / full.float().norm()), max_abs=float(d.abs().max()))


def port_gap(torch, cfg, model, tokens, S: int) -> dict:
    from repro_torch.launch.serve import pad_caches
    from repro_torch.models import decode_step, forward, prefill

    _, caches = prefill(cfg, model, tokens[:, :S])
    first, _ = decode_step(cfg, model, tokens[:, S], pad_caches(cfg, caches, S, S + 1), S)
    with torch.no_grad():
        full = forward(cfg, model, tokens)[0][:, -1]
    return _gap(torch, first, full)


def reference_gap(torch, cfg, model, tokens, S: int) -> dict:
    """The reference's prefill, decode_step and forward on the port
    model's weights (imported here: the port itself never imports JAX)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import repro.configs as RC
    import repro.models.model as RM
    from repro.launch.serve import pad_caches as pad_caches_ref

    rcfg = dataclasses.replace(RC.get_config(cfg.name), n_layers=cfg.n_layers, dtype=cfg.dtype)
    dt = jnp.dtype(cfg.dtype)
    n_units, unit, _ = cfg.scan_split()
    U = len(unit)

    def arr(t):
        a = t.detach().float().cpu().numpy()
        return jnp.asarray(a, dt if t.dtype == torch.bfloat16 else jnp.float32)

    def layer(lay):
        out = {}
        for name, p in lay.named_parameters():
            node = out
            *path, leaf = name.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = arr(p)
        return out

    layers = [layer(l) for l in model.layers]
    params = {"embed": arr(model.embed), "final_norm": arr(model.final_norm),
              "scan": [jax.tree.map(lambda *xs: jnp.stack(xs),
                                    *[layers[u * U + i] for u in range(n_units)])
                       for i in range(U)],
              "rem": layers[n_units * U:]}
    if not cfg.tie_embeddings:
        params["lm_head"] = arr(model.lm_head)
    tok = np.asarray(tokens.cpu().numpy(), np.int32)
    _, caches = jax.jit(lambda p, t: RM.prefill(rcfg, p, t))(params, tok[:, :S])
    caches = pad_caches_ref(rcfg, caches, S, S + 1)
    first, _ = jax.jit(lambda p, t, c: RM.decode_step(rcfg, p, t, c, jnp.int32(S)))(
        params, tok[:, S], caches)
    full = jax.jit(lambda p, t: RM.forward(rcfg, p, t, remat=False)[0][:, -1])(params, tok)
    return _gap(torch, torch.from_numpy(np.array(first, np.float32)),
                torch.from_numpy(np.array(full, np.float32)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 16])
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--reference", action="store_true",
                    help="also run the reference package (JAX on the CPU)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params

    dev = resolve_device(args.device)
    for L in args.layers:
        for dtype in args.dtypes:
            cfg = dataclasses.replace(get_config(args.arch), n_layers=L, dtype=dtype)
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            model = init_params(cfg, gen, dev)
            tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len + 1),
                                   generator=gen, device=dev)
            row = dict(arch=args.arch, layers=L, dtype=dtype, batch=args.batch,
                       prompt=args.prompt_len, device=str(dev), package="repro_torch")
            print(json.dumps({**row, **port_gap(torch, cfg, model, tokens, args.prompt_len)}),
                  flush=True)
            if args.reference:
                gap = reference_gap(torch, cfg, model, tokens, args.prompt_len)
                print(json.dumps({**row, "package": "repro", "device": "cpu", **gap}),
                      flush=True)
            del model
    return 0


if __name__ == "__main__":
    sys.exit(main())
