"""Inputs of ``lp_sweep_batched`` for the chunk-step kernel's tests: each
case is the CPU tensors and keyword arguments of one sweep, built as the
engine, the batched GA and the region repair build theirs (packs from
``pack_chunks``, padded to a bucket by ``pad_pack``).  The card tests run
each on the card (the kernel) and on the CPU (its plain version)."""

import numpy as np
import torch

from repro_torch.core.label_propagation import make_order
from repro_torch.graph import GraphNP, barabasi_albert, mesh2d, pack_chunks, pad_pack, rmat


def _reweighted(g, rng, float_w: bool):
    """``g`` with node weights 1-3 and, with ``float_w``, edge weights in
    (0, 1] that no order of addition sums alike (each edge's two arcs keep
    one weight)."""
    nw = rng.integers(1, 4, g.n).astype(np.float32)
    ew = g.ew
    if float_w:
        src = np.repeat(np.arange(g.n), np.diff(g.indptr))
        lo, hi = np.minimum(src, g.indices), np.maximum(src, g.indices)
        ew = (np.sin(lo * 12.9898 + hi * 78.233) * 0.5 + 0.5 + 1e-3).astype(np.float32)
    return GraphNP(indptr=g.indptr, indices=g.indices, ew=ew, nw=nw)


def _pack_np(g, refine: bool, seed: int, max_nodes=256, max_edges=4096):
    """A pack padded to twice its chunks, 8 more slots and 512 more arcs,
    and its live chunk count."""
    pack = pack_chunks(g, make_order(g, "random" if refine else "degree", seed),
                       max_nodes=max_nodes, max_edges=max_edges, block=8)
    C, N = pack.nodes.shape
    E = pack.edge_dst.shape[1]
    return pad_pack(pack, 2 * C, N + 8, E + 512), C


def _tensors(pack):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dt) for a, dt in (
        (pack.nodes, torch.int64), (pack.node_valid, torch.bool),
        (pack.edge_dst, torch.int64), (pack.edge_w, torch.float32),
        (pack.edge_src_slot, torch.int64), (pack.edge_valid, torch.bool))]


def _rows(g, A, refine: bool, k: int, B: int, rng, W=None):
    """(B, A) labels, (B, W) block weights, (A,) node weights and U."""
    n = g.n
    nw = np.zeros(A, np.float32)
    nw[:n] = g.nw
    L = float(np.ceil(g.nw.sum() / k) * 1.03)
    if refine:
        lab = np.full((B, A), k, np.int32)
        lab[:, :n] = rng.integers(0, k, (B, n))
        W = W or k + 1
        w = np.zeros((B, W), np.float32)
        for b in range(B):
            w[b, :k] = np.bincount(lab[b, :n], weights=g.nw, minlength=k)
        w[:, k] = np.inf
        return lab, w, nw, L
    lab = np.broadcast_to(np.arange(A, dtype=np.int32), (B, A)).copy()
    w = np.full((B, A), np.inf, np.float32)
    w[:, :n] = g.nw
    return lab, w, nw, max(float(g.nw.max()), L / 14)


def _single(g, *, refine, restrict, k=8, B=1, seed=0, float_w=False, iters=3,
            permute=None, max_nodes=256, max_edges=4096):
    rng = np.random.default_rng(seed)
    g = _reweighted(g, rng, float_w)
    pack, live = _pack_np(g, refine, seed, max_nodes=max_nodes, max_edges=max_edges)
    A = 1 << g.n.bit_length()
    lab, w, nw, U = _rows(g, A, refine, k, B, rng)
    if restrict:
        r = np.full(A, -1, np.int32)
        r[: g.n] = rng.integers(0, 3, g.n)
    else:
        r = np.zeros(1, np.int32)
    seeds = [int(s) for s in rng.integers(0, 2**31, B)]
    args = (*_tensors(pack), torch.from_numpy(lab), torch.from_numpy(w),
            torch.from_numpy(nw), torch.from_numpy(r), U, seeds, k if refine else g.n, live)
    kw = dict(iters=iters, refine_mode=refine, use_restrict=restrict,
              permute_chunks=refine if permute is None else permute)
    return args, kw


def _lanes(seed=5, k=4):
    """Three region-repair lanes: graphs of one shape bucket, each with its
    own pack, node weights, U and live chunk count (uneven), and block
    weights wider than k + 1, as ``repair_lanes`` hands them in."""
    rng = np.random.default_rng(seed)
    gs = [_reweighted(g, rng, False) for g in
          (rmat(9, 8, seed=1), barabasi_albert(300, 3, seed=2), mesh2d(14))]
    plans = [_pack_np(g, True, seed) for g in gs]
    C = max(p.nodes.shape[0] for p, _ in plans)
    N = max(p.nodes.shape[1] for p, _ in plans)
    E = max(p.edge_dst.shape[1] for p, _ in plans)
    A = 1 << max(g.n for g in gs).bit_length()
    packs, labs, ws, nws, Us = [], [], [], [], []
    for g, (p, _) in zip(gs, plans):
        packs.append(_tensors(pad_pack(p, C, N, E)))
        lab, w, nw, U = _rows(g, A, True, k, 1, rng, W=k + 4)
        labs.append(lab[0])
        ws.append(w[0])
        nws.append(nw)
        Us.append(U)
    pack = [torch.stack([p[i] for p in packs]) for i in range(6)]
    args = (*pack, torch.from_numpy(np.stack(labs)), torch.from_numpy(np.stack(ws)),
            torch.from_numpy(np.stack(nws)), torch.zeros(1, dtype=torch.int32), Us,
            [11, 12, 13], k, [live for _, live in plans])
    return args, dict(iters=3, refine_mode=True, use_restrict=False, permute_chunks=True)


def _hub_graph():
    """Hubs past a warp's table (256 arcs), one of them longer than a piece
    (2,048 arcs), so blocks share it."""
    g = rmat(13, 16, seed=3)
    assert int(np.diff(g.indptr).max()) > 2048
    return g


HUB = dict(max_nodes=512, max_edges=16384)

#: name -> a function returning ``(args, kwargs)`` of one sweep
CASES = {
    "cluster": lambda: _single(rmat(11, 8, seed=1), refine=False, restrict=False),
    "cluster_restrict": lambda: _single(rmat(11, 8, seed=1), refine=False, restrict=True),
    "refine": lambda: _single(rmat(11, 8, seed=2), refine=True, restrict=False),
    "refine_restrict": lambda: _single(rmat(11, 8, seed=2), refine=True, restrict=True),
    "refine_in_order": lambda: _single(mesh2d(30), refine=True, restrict=False,
                                       permute=False),
    "ga": lambda: _single(barabasi_albert(600, 4, seed=2), refine=True, restrict=False,
                          k=4, B=6),
    "lanes": _lanes,
    "float_w": lambda: _single(rmat(11, 8, seed=4), refine=True, restrict=False,
                               float_w=True),
    "hub_cluster": lambda: _single(_hub_graph(), refine=False, restrict=False, **HUB),
    "hub_refine": lambda: _single(_hub_graph(), refine=True, restrict=False, k=4, B=2,
                                  **HUB),
    "hub_float_w": lambda: _single(_hub_graph(), refine=False, restrict=True,
                                   float_w=True, **HUB),
}

#: the cases with a node of more arcs in its chunk than the kernel's warp
#: path takes (256): hubs, which the kernel cuts into pieces for blocks
HUB_CASES = ("hub_cluster", "hub_refine", "hub_float_w")
