"""Multi-pod dry run of the port: every (architecture x input shape) cell on
the production meshes, counted on the ``meta`` device, with its roofline
terms (the torch twin of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 256 or 512 placeholder XLA
devices and reads its costs from the HLO.  The port compiles nothing: it
builds the cell's state and inputs on the ``meta`` device, runs the cell's
step once under ``launch.hlo_analysis.count_step`` and writes what it
counted in the reference's record, with ``"counter": "meta"``:
``t_lower_s`` holds the counted run's seconds, ``t_compile_s`` is null,
and ``counts`` keeps the per-device counts that ``launch.reanalyze``
re-derives the roofline from.

``bytes_per_device`` is an estimate.  The reference's is XLA's per-device
argument + output - alias + temp bytes.  The port's meta run holds every
mesh coordinate's work on one device, so it sees the global peak of live
bytes.  The estimate is the exact state bytes one coordinate holds (the
parameters and, in training, the optimizer state, from each leaf's
``NamedSharding.shard_shape``) plus the rest of the global peak shared
evenly: ``(global peak - global state bytes) / n_chips``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --driver            # all cells, subprocesses
  python -m repro_torch.launch.dryrun --driver --mesh multi
  python -m repro_torch.launch.dryrun --driver --smoke --arch qwen2.5-3b --mesh 2x2
``--mesh`` takes ``single`` (16x16), ``multi`` (2x16x16) or a ("data",
"model") mesh ``DxM``; ``--smoke`` counts the reduced configs; with
``--driver``, ``--arch`` and ``--shape`` take comma-separated subsets.
Results accumulate as JSON under results/dryrun/.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

VARIANTS = {
    # name -> environment switches, read by the model code at call time
    "base": {"REPRO_CACHE_UPDATE": "dus", "REPRO_ATTN_DTYPE": "f32",
             "REPRO_SSD_DTYPE": "f32"},
    "where_update": {"REPRO_CACHE_UPDATE": "where", "REPRO_ATTN_DTYPE": "f32"},
    "attn_bf16": {"REPRO_CACHE_UPDATE": "where", "REPRO_ATTN_DTYPE": "bf16"},
    "opt": {"REPRO_CACHE_UPDATE": "where", "REPRO_ATTN_DTYPE": "bf16",
            "REPRO_SSD_DTYPE": "bf16"},
    "ssd_q128": {"REPRO_SSD_DTYPE": "bf16", "REPRO_SSD_CHUNK": "128"},
    "ssd_q64": {"REPRO_SSD_DTYPE": "bf16", "REPRO_SSD_CHUNK": "64"},
    "ssd_bf16": {"REPRO_SSD_DTYPE": "bf16"},
}

_SRC = str(Path(__file__).resolve().parents[2])


@contextlib.contextmanager
def _variant_env(variant: str):
    """The variant's switches in the environment for the run, the previous
    values restored after it."""
    switches = VARIANTS.get(variant, {})
    old = {k: os.environ.get(k) for k in switches}
    os.environ.update(switches)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _meta_mesh(mesh_kind: str):
    """(mesh on the ``meta`` device, multi_pod, n_chips) of a mesh kind:
    the production meshes, or a ("data", "model") mesh ``DxM``."""
    from .mesh import make_mesh, make_production_mesh

    if mesh_kind in ("single", "multi"):
        multi = mesh_kind == "multi"
        return make_production_mesh(multi_pod=multi, devices=["meta"]), multi, \
            512 if multi else 256
    d, m = (int(v) for v in mesh_kind.split("x"))
    return make_mesh((d, m), ("data", "model"), ["meta"]), False, d * m


def activation_collectives(cfg, shape, params, shardings, mesh, multi_pod: bool) -> dict:
    """Global operand bytes (summed over the mesh's coordinates) of the
    collectives that a model axis larger than 1 puts on activations, as
    XLA partitions the reference's step; the port's mesh keeps values
    whole and moves none of them.  Each coordinate holds the hidden states
    of its batch rows, (B / data, S, D) in the model's dtype:

    * all-reduce: one of the hidden states after each row-parallel
      product (``wo``, ``w_down`` and the vocabulary-split embedding
      lookup) in each forward pass that runs it (remat's recompute runs
      the scanned units' layers a second time), and in training one after
      each column-parallel product that reads a hidden state (``wq``,
      ``wk``, ``wv``, ``w_up``, ``w_gate``, ``wz``, ``wx``, the head), for
      the gradient of its input: XLA reduces each of them on its own;
    * all-to-all: ``moe_ep``'s two exchanges of an (E, cap, D) buffer on
      every coordinate (``models.moe.ep_blocks`` gives cap) per MoE layer
      and pass, the backward pass's pair included."""
    import math

    import torch

    from ..models.moe import ep_blocks
    from ..models.sharding import DP, TP

    if mesh.shape.get(TP, 1) == 1:
        return {}
    n_coords = math.prod(mesh.shape.values())
    dp_axes = DP(multi_pod)
    dp = math.prod(mesh.shape[a] for a in dp_axes)
    train = shape.kind == "train"
    B, S = shape.batch, 1 if shape.kind == "decode" else shape.seq + cfg.n_prefix
    act = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    hidden = (B // dp if B % dp == 0 else B) * S * cfg.d_model * act
    n_units, unit, _ = cfg.scan_split()
    recomputed = n_units * len(unit) if train else 0      # layers remat runs twice

    def passes(name):
        layer = int(name.split(".")[1]) if name.startswith("layers.") else recomputed
        return 1 + (layer < recomputed)

    D = cfg.d_model
    n_ar = train and cfg.tie_embeddings                  # the head, embed.T
    for name, p in params.items():
        spec = shardings[name].spec
        if p.dim() == 2:      # (in, out); a row-parallel one writes, a column one reads D
            row, col = (TP in (e if isinstance(e, tuple) else (e,)) for e in spec[:2])
            n_ar += passes(name) * (row and p.shape[1] == D) + (train and col
                                                                and p.shape[0] == D)
    out = {"all-reduce": float(n_ar * hidden * n_coords)}
    if cfg.moe is not None:
        _, _, cap = ep_blocks(B, S, mesh, dp_axes, TP, cfg.moe.topk, cfg.moe.n_experts,
                              cfg.moe.capacity_factor)
        buf = cfg.moe.n_experts * cap * cfg.d_model * act
        n_a2a = sum(2 * (passes(f"layers.{i}") + train)
                    for i, (_, ffn) in enumerate(cfg.layer_plan()) if ffn == "moe")
        out["all-to-all"] = float(n_a2a * buf * n_coords)
    return out


def count_cell(cfg, shape, mesh, multi_pod: bool, n_chips: int):
    """(costs per device, state bytes per device) of one cell: its step
    once on the ``meta`` device with the reference's inputs; decode writes
    the last position of an S-length context.  The collectives are those
    the shardings imply (``hlo_analysis.gradient_collectives``) and
    :func:`activation_collectives`."""
    from ..models.sharding import DP
    from .hlo_analysis import count_step, gradient_collectives, shard_bytes
    from .steps import input_specs, make_decode_step, make_prefill, make_train_step, \
        state_specs

    ap, ao, psh, osh = state_specs(cfg, mesh, multi_pod)
    named = dict(ap.named_parameters())
    ins = input_specs(cfg, shape)
    train = shape.kind == "train"
    coll = gradient_collectives(named, psh, DP(multi_pod), train=train)
    for kind, b in activation_collectives(cfg, shape, named, psh, mesh, multi_pod).items():
        coll[kind] = coll.get(kind, 0.0) + b
    if train:
        step = make_train_step(cfg, mesh, multi_pod=multi_pod, remat=True)
        hc = count_step(step, ap, ao, ins, n_chips=n_chips, state=(ap, ao), collectives=coll)
        return hc, shard_bytes((named, ao), (psh, osh))
    if shape.kind == "prefill":
        hc = count_step(make_prefill(cfg, mesh, multi_pod=multi_pod), ap, ins,
                        n_chips=n_chips, state=ap, collectives=coll)
    else:
        hc = count_step(make_decode_step(cfg, mesh, multi_pod=multi_pod), ap, ins["token"],
                        ins["caches"], shape.seq - 1, n_chips=n_chips, state=ap,
                        collectives=coll)
    return hc, shard_bytes(named, psh)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             variant: str = "base", smoke: bool = False) -> dict:
    from ..configs import SHAPES, get_config
    from .roofline import param_counts, roofline

    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    shape = SHAPES[shape_name]
    mesh, multi_pod, n_chips = _meta_mesh(mesh_kind)
    t0 = time.time()
    with _variant_env(variant):
        hc, state_dev = count_cell(cfg, shape, mesh, multi_pod, n_chips)
    t_count = time.time() - t0
    rl = roofline(hc, n_chips, cfg, shape)
    rl["xla_cost_analysis_flops"] = None
    rl["xla_cost_analysis_bytes"] = None
    rl["unknown_trip_loops"] = hc.unknown_trip_loops
    pc = param_counts(cfg)
    transient = (hc.peak_bytes - hc.state_bytes) / n_chips
    bytes_per_dev = int(state_dev + transient)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "variant": variant,
        "kind": shape.kind,
        "n_chips": n_chips,
        "status": "ok",
        "counter": "meta",
        "smoke": smoke,
        "t_lower_s": round(t_count, 3),
        "t_compile_s": None,
        "bytes_per_device": bytes_per_dev,
        "gib_per_device": round(bytes_per_dev / 2**30, 3),
        "bytes_per_device_estimate": {
            "state_bytes_per_device": state_dev,
            "transient_bytes_per_device": transient,
            "global_peak_bytes": hc.peak_bytes,
            "global_state_bytes": hc.state_bytes,
        },
        "params_total": pc["total"],
        "params_active": pc["active"],
        "counts": {"flops": hc.flops, "hbm_bytes": hc.hbm_bytes,
                   "collective_bytes": hc.collective_bytes,
                   "unknown_trip_loops": hc.unknown_trip_loops},
        "roofline": rl,
    }


def cell_path(out_dir, arch, shape, mesh_kind, variant="base"):
    safe = arch.replace("/", "_").replace(".", "_")
    return os.path.join(out_dir, f"{safe}__{shape}__{mesh_kind}__{variant}.json")


def _driver(args) -> list:
    """One subprocess per cell of ``configs.cells()`` (``--arch`` and
    ``--shape`` subsets), on ``--mesh`` or both production meshes; skipped
    cells get a skip record, a failed one an error record.  Returns the
    records' paths."""
    from ..configs import cells

    archs = args.arch.split(",") if args.arch else None
    shapes = args.shape.split(",") if args.shape else None
    meshes = (args.mesh,) if args.mesh else ("single", "multi")
    todo, paths = [], []
    for aid, sname, skip in cells():
        if (archs and aid not in archs) or (shapes and sname not in shapes):
            continue
        for mesh_kind in meshes:
            p = cell_path(args.out, aid, sname, mesh_kind, args.variant)
            paths.append(p)
            if skip:
                with open(p, "w") as f:
                    json.dump({"arch": aid, "shape": sname, "mesh": mesh_kind,
                               "status": "skip", "reason": skip}, f, indent=1)
                continue
            if os.path.exists(p) and not args.force:
                continue
            todo.append((aid, sname, mesh_kind, p))
    print(f"[driver] {len(todo)} cells to run")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        x for x in (_SRC, os.environ.get("PYTHONPATH")) if x))
    for i, (aid, sname, mesh_kind, p) in enumerate(todo):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", aid,
               "--shape", sname, "--mesh", mesh_kind, "--variant", args.variant,
               "--out", args.out] + (["--smoke"] if args.smoke else [])
        t0 = time.time()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout,
                               env=env)
            rc, err = r.returncode, r.stderr[-4000:]
        except subprocess.TimeoutExpired:
            rc, err = None, f"timeout: the cell ran past --timeout {args.timeout} s"
        secs = time.time() - t0
        print(f"[driver {i+1}/{len(todo)}] {aid} x {sname} x {mesh_kind}: "
              f"{'ok' if rc == 0 and os.path.exists(p) else 'FAIL'} ({secs:.0f}s)", flush=True)
        if rc != 0:
            with open(p, "w") as f:
                json.dump({"arch": aid, "shape": sname, "mesh": mesh_kind, "status": "error",
                           "error": err, "t_driver_s": round(secs, 1)}, f, indent=1)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default=None,
                    help="single | multi | DxM (default: single; the driver runs both)")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--driver", action="store_true",
                    help="run every cell in a fresh subprocess")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--smoke", action="store_true", help="the reduced configs")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.driver:
        return _driver(args)

    mesh_kind = args.mesh or "single"
    p = cell_path(args.out, args.arch, args.shape, mesh_kind, args.variant)
    try:
        rec = run_cell(args.arch, args.shape, mesh_kind, args.out, args.variant, args.smoke)
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": mesh_kind,
               "variant": args.variant, "status": "error",
               "error": traceback.format_exc()[-4000:]}
        with open(p, "w") as f:
            json.dump(rec, f, indent=1)
        print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh", "status")}))
        sys.exit(1)
    with open(p, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
