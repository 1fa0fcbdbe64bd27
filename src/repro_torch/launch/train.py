"""End-to-end training entry point of the port with checkpoint/restart (the
torch twin of ``repro.launch.train``).

Example (reduced config on the CPU; leave ``--device`` out to run on the
card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --ckpt-every 20 \\
      --device cpu

Fault tolerance: the data pipeline is deterministic-by-step and checkpoints
store (params, opt, step); ``--resume`` restarts from the last COMPLETE step
and replays the exact stream — killing the process at any point loses at
most ``ckpt_every`` steps.  The checkpoint tree is ``({name: parameter},
opt)``; on a different mesh shape, elastic restore re-places the same
tensors (``repro_torch.ckpt.elastic``).

``--mesh DxM`` builds a ("data", "model") mesh over ``[--device] * (D*M)``,
else over every visible card cyclically; the parameters and optimizer
state stay whole on its first device, as the reference's ``launch.train``
leaves them, and with M > 1 the MoE layers run ``moe_ep`` over it.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..ckpt import AsyncCheckpointer, latest_step, restore
from ..configs import get_config
from ..configs.base import ArchConfig
from ..data import TokenPipeline
from ..device import resolve_device
from ..models.model import LM, init_params
from ..optim import adamw_init, ef_init
from .mesh import make_mesh
from .steps import make_train_step

__all__ = ["make_state", "main"]


def make_state(cfg: ArchConfig, seed: int, device: torch.device) -> LM:
    """The LM to train, drawn from a generator seeded with ``seed`` on
    ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_params(cfg, gen, device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="1x1", help="e.g. 2x4 => data=2,model=4")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    if args.arch == "mini-lm":
        from ..configs.mini_lm import MINI_LM

        cfg = MINI_LM
    else:
        cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    d, m = (int(x) for x in args.mesh.split("x"))
    devices = None if args.device is None else [resolve_device(args.device)] * (d * m)
    mesh = make_mesh((d, m), ("data", "model"), devices)
    dev = mesh.device((0, 0))

    pipe = TokenPipeline(
        vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=args.seed,
        n_prefix=cfg.n_prefix, d_model=cfg.d_model,
    )
    train_step = make_train_step(cfg, mesh, multi_pod=False, lr=args.lr, remat=True,
                                 compress_grads=args.compress_grads)

    model = make_state(cfg, args.seed, dev)
    named = dict(model.named_parameters())
    opt = adamw_init(named)
    if args.compress_grads:
        opt = (opt, ef_init(named))
    start = 0
    ck = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and args.ckpt_dir:
        s = latest_step(args.ckpt_dir)
        if s is not None:
            (params, opt), extra = restore(args.ckpt_dir, s, (named, opt))
            with torch.no_grad():
                for k, t in params.items():
                    named[k].copy_(t)
            start = int(extra["step"]) + 1
            print(f"[resume] restored step {s}, continuing at {start}")

    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(step).items()}
        batch["tokens"] = batch["tokens"].long()
        model, opt, metrics = train_step(model, opt, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {loss:8.4f} ce {float(metrics['ce']):8.4f} "
                  f"gnorm {float(metrics['gnorm']):7.3f} ({dt:.1f}s)")
        if ck and args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ck.submit(step, (named, opt), {"step": step, "seed": args.seed})
    if ck:
        ck.submit(args.steps - 1, (named, opt), {"step": args.steps - 1,
                                                 "seed": args.seed})
        ck.wait()
    print(f"[done] first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
