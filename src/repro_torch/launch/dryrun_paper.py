"""Dry run of the PAPER's own distributed SCLaP sweep at web scale, counted
on the ``meta`` device (the torch twin of ``repro.launch.dryrun_paper``).

The reference lowers and compiles one coarsening sweep (3 LP iterations
over 4 chunks a PE, each phase followed by the interface exchange) and one
refinement sweep (6 iterations, block weights summed over PEs, k = 16)
for a uk-2007-scale graph, n = 105.8M nodes and m = 3.3G edges, over 256
or 512 PEs, and reads one PE's costs from the HLO.  This is the scale the
paper partitions in 15.2 s on 512 cores.

The port runs one PE's program on the ``meta`` device: its
``ShardTensors`` at the reference's shard shapes in the port's own dtypes
(int64 indices and labels, bool masks, float32 weights; the reference's
are int32, so the port's arguments are larger, and both figures are
printed), then ``iters x C`` phases of ``core.distributed_lp.shard_phase``,
each followed by ``exchange`` with the PE's send buffer standing in for
every PE's: the ``(P, maxI)`` stack, the reference's ``all_gather``.  In refinement each phase first
sums the ``(k + 1)`` block weights over PEs (the reference's ``psum``, an
all-reduce).  The counts are one PE's, so nothing is divided.

  python -m repro_torch.launch.dryrun_paper [--mesh single|multi]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..core.distributed_lp import ShardTensors, block_weights, exchange, shard_phase
from ..kernels.lp_score.threefry import fold_in, prng_key, split
from .hlo_analysis import count_step
from .roofline import roofline_terms

__all__ = ["shard_dims", "reference_arg_bytes", "pe_tensors", "pe_sweep", "main"]

#: (mode, LP iterations) of the two sweeps; refinement takes ``--k`` blocks
MODES = (("cluster", 3), ("refine", 6))
GHOST_FRAC = 0.10        # paper: <0.5% (rgg) .. 40% (del); web ~10%
CHUNKS = 4               # chunks per shard
U = float(np.float32(1e6))


def shard_dims(n: float, m: float, n_chips: int) -> dict:
    """One PE's shard shapes, by the reference's arithmetic
    (``dryrun_paper.py:56-65``): ``m`` undirected edges, 2m arcs."""
    n, arcs = int(n), int(2 * m)
    maxN = -(-n // n_chips)
    maxM = -(-arcs // n_chips)
    maxG = int(maxN * GHOST_FRAC) // 8 * 8 + 8
    return dict(P=n_chips, n=n, arcs=arcs, maxN=maxN, maxM=maxM, maxG=maxG, maxI=maxG,
                C=CHUNKS, Nc=-(-maxN // CHUNKS) // 8 * 8 + 8,
                Ec=-(-maxM // CHUNKS) // 8 * 8 + 8)


def reference_arg_bytes(d: dict) -> int:
    """Bytes of the reference's arguments on one PE: int32 ids and labels,
    float32 weights, bool masks, the two per-PE counts and the replicated
    PRNG key (two uint32)."""
    C, Nc, Ec, maxN, maxG, maxI = (d[k] for k in ("C", "Nc", "Ec", "maxN", "maxG", "maxI"))
    return (C * Nc * (4 + 1) + C * Ec * (4 + 4 + 4 + 1) + maxN * 4 + maxG * (4 + 4 + 4)
            + maxI * 4 + 2 * 4 + maxN * 4 + maxG * 4 + 2 * 4)


def pe_tensors(d: dict, device, gen=None, k: int = 16):
    """(ShardTensors, local labels, ghost labels) of one PE at the shapes
    ``d`` on ``device``: uninitialized (the ``meta`` device), or with
    ``gen`` a seeded synthetic layout with every index in range (each
    chunk's nodes in order, arcs in random slots with random local-ext
    destinations, unit weights, labels below ``k``)."""
    dev = torch.device(device)
    C, Nc, Ec, maxN, maxG, maxI = (d[k_] for k_ in ("C", "Nc", "Ec", "maxN", "maxG", "maxI"))
    i64, f32, b = torch.int64, torch.float32, torch.bool

    def ints(hi, shape):
        if gen is None:
            return torch.empty(shape, dtype=i64, device=dev)
        return torch.randint(0, hi, shape, generator=gen, device=dev)

    def fill(shape, dtype, value):
        if gen is None:
            return torch.empty(shape, dtype=dtype, device=dev)
        return torch.full(shape, value, dtype=dtype, device=dev)

    nodes = torch.arange(C * Nc, device=dev).view(C, Nc)
    nodes = torch.where(nodes < maxN, nodes, -1)
    st = ShardTensors(
        device=dev,
        ch_nodes=nodes,
        ch_node_valid=nodes >= 0,
        ch_edge_dst=ints(maxN + maxG, (C, Ec)),
        ch_edge_w=fill((C, Ec), f32, 1.0),
        ch_edge_slot=ints(Nc, (C, Ec)) if gen is None else
        torch.sort(ints(Nc, (C, Ec)), dim=1).values,
        ch_edge_valid=fill((C, Ec), b, True),
        nw_local=fill((maxN,), f32, 1.0),
        ghost_nw=fill((maxG,), f32, 1.0),
        ghost_owner=ints(d["P"], (maxG,)),
        ghost_slot=ints(maxI, (maxG,)),
        iface_nodes=ints(maxN, (maxI,)),
        local_valid=fill((maxN,), b, True),
        ghost_valid=fill((maxG,), b, True),
    )
    return st, ints(max(k, 1), (maxN,)), ints(max(k, 1), (maxG,))


def pe_sweep(st: ShardTensors, ll, lg, *, iters: int, k: int, n_pes: int, seed: int = 0):
    """One PE's sweep: ``iters x C`` phases of ``shard_phase`` (cluster
    mode when ``k == 0``, else refinement against the block weights summed
    over PEs), each followed by the PE's exchange.  Returns the labels."""
    C = st.ch_nodes.shape[0]
    key = fold_in(prng_key(seed), 0)
    for ph in range(iters * C):
        key, sub = split(key)
        table = None
        if k:
            table = block_weights(st, ll, k)      # summed over PEs by the all-reduce
            table[k] = float("inf")
        ll = shard_phase(st, ph % C, ll, lg, sub, U, table, k)
        lg = exchange([st], [ll], [lg], n_pes)[0]
    return ll, lg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--n", type=float, default=105.8e6)
    ap.add_argument("--m", type=float, default=3.3e9)   # undirected edges
    ap.add_argument("--k", type=int, default=16)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    n_chips = 512 if args.mesh == "multi" else 256
    d = shard_dims(args.n, args.m, n_chips)
    rec_all = {}
    for mode, iters in MODES:
        kk = args.k if mode == "refine" else 0
        st, ll, lg = pe_tensors(d, "meta", k=kk)
        args_t = [v for v in vars(st).values() if isinstance(v, torch.Tensor)] + [ll, lg]
        port_bytes = sum(t.numel() * t.element_size() for t in args_t)
        phases = iters * d["C"]
        coll = {"all-gather": phases * d["maxI"] * ll.element_size()}
        if kk:
            coll["all-reduce"] = phases * (kk + 1) * 4
        hc = count_step(pe_sweep, st, ll, lg, iters=iters, k=kk, n_pes=n_chips,
                        state=args_t, collectives=coll)
        rec = {
            "arch": "paper-sclap", "shape": f"uk2007_{mode}", "mesh": args.mesh,
            "variant": "base", "kind": mode, "n_chips": n_chips,
            "status": "ok", "counter": "meta", "t_lower_s": round(hc.seconds, 3),
            "t_compile_s": None,
            "bytes_per_device": hc.peak_bytes,
            "gib_per_device": round(hc.peak_bytes / 2**30, 3),
            "arg_bytes": {"port_dtypes": port_bytes,
                          "reference_dtypes": reference_arg_bytes(d)},
            "graph": {"n": d["n"], "arcs": d["arcs"], "ghost_frac": GHOST_FRAC,
                      "chunks": d["C"], "Nc": d["Nc"], "Ec": d["Ec"]},
            "counts": {"flops": hc.flops, "hbm_bytes": hc.hbm_bytes,
                       "collective_bytes": hc.collective_bytes,
                       "unknown_trip_loops": hc.unknown_trip_loops},
            "roofline": {**roofline_terms(hc), "unknown_trip_loops": hc.unknown_trip_loops},
        }
        path = os.path.join(args.out, f"paper-sclap__uk2007_{mode}__{args.mesh}__base.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(json.dumps({"shape": rec["shape"], "mesh": rec["mesh"],
                          "t_lower_s": rec["t_lower_s"], "gib_per_device": rec["gib_per_device"],
                          "arg_gib_port_dtypes": round(port_bytes / 2**30, 3),
                          "arg_gib_reference_dtypes": round(reference_arg_bytes(d) / 2**30, 3)}))
        rec_all[mode] = rec
    return rec_all


if __name__ == "__main__":
    main()
