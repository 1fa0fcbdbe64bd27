"""Size-constrained label propagation (SCLaP), the paper's core algorithm.

Two modes (paper §III-A), as in ``repro.core.label_propagation``:

* ``cluster`` — coarsening.  Labels live in ``[0, n)``, the size bound is
  ``U = max(max_v c(v), L_max / f)`` (soft), traversal by increasing degree.
* ``refine`` — local search.  Labels live in ``[0, k)``, ``U = L_max``, and
  nodes of an overloaded block must leave it; random traversal.

:func:`lp_sweep_batched` is the chunked-sequential sweep: a Python loop
walks the chunks of a pack in order and moves the nodes of one chunk
synchronously, for a batch of ``B`` label rows at once (row ``b`` visits
the chunks in the order its own seed draws; the batched GA refines its
whole population this way).  :func:`lp_sweep` is its one-row case.  On the
card each step is the hand-written kernel of :mod:`repro_torch.kernels.lp_step`;
its plain version, :func:`lp_sweep_plain`, makes each step a chain of torch
ops.  Each row makes exactly the reference's move decisions; in the plain
version:

* the per-chunk (node, label) run reduction sorts the fused key
  ``slot * A + cand`` with a *stable* sort (``torch.sort`` is unstable by
  default, ``jnp.argsort`` is stable, and run order fixes the float sum
  order);
* tie-break jitter and the influx gate are stateless uint32 hashes of
  integer coordinates.  Torch on the CPU has no uint32 right shift, so the
  murmur mixer runs in int64 with every product reduced mod 2^32;
* the reference's ``mode="drop"`` scatters become row-wise scatter adds
  whose out-of-range indices are masked explicitly (torch raises on them),
  and its scatter max/min are ``scatter_reduce(..., include_self=True)``.

The numpy host code (:func:`make_order`, :func:`sclap_numpy`,
:func:`sweep_refine_numpy` and the ``hash_*_np`` family) is a copy of the
reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..graph.csr import GraphNP
from ..graph.packing import ChunkPack, pack_chunks
from ..kernels.lp_step import ChunkStep
from ..obs import span as _obs_span

__all__ = [
    "LPResult",
    "lp_cluster",
    "lp_refine",
    "lp_sweep",
    "lp_sweep_batched",
    "lp_sweep_plain",
    "make_order",
    "sclap_numpy",
    "hash_mix",
    "hash_jitter",
    "hash_u32_scalar",
    "hash_base_u32",
    "hash_mix_np",
    "hash_jitter_np",
    "hash_unit_np",
    "hash_u32_np",
    "sweep_refine_numpy",
]

_NEG = -1e30
_M32 = 0xFFFFFFFF
_MIX = 0xC2B2AE35


@dataclass
class LPResult:
    labels: np.ndarray   # (n,) final labels
    moves: int           # total number of node moves
    iters: int


def make_order(g, mode: str, seed: int) -> np.ndarray:
    """Traversal order: 'degree' (coarsening) or 'random' (refinement)."""
    rng = np.random.default_rng(seed)
    if mode == "degree":
        # increasing degree, random within equal degrees (paper §III-A)
        return np.argsort(g.degrees() + rng.random(g.n), kind="stable").astype(np.int64)
    return rng.permutation(g.n).astype(np.int64)


# --------------------------------------------------------------------------
# uint32 hash family on int64 tensors
# --------------------------------------------------------------------------


def _mulmod32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for ``h`` in [0, 2^32): split ``c`` in 16-bit
    halves so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def hash_mix(h: Union[int, torch.Tensor], x: Union[int, torch.Tensor]):
    """One round of the murmur-style mixer; ``x`` is cast like a uint32
    (negative int32 values wrap).  On tensors the result is an int64 tensor
    holding uint32 values; on two python ints, a python int."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.int64)
    h = _mulmod32(h ^ (x & _M32), _MIX)
    return h ^ (h >> 15)


def hash_jitter(base: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stateless tie-break jitter in [0, 0.49) (float32) from integer
    coordinates — independent of array shapes, so bucket padding cannot
    perturb a tie-break."""
    h = hash_mix(hash_mix(base, a), b)
    return (h & 0xFFFFFF).to(torch.float32) / float(1 << 24) * 0.49


# --------------------------------------------------------------------------
# the chunked sweep
# --------------------------------------------------------------------------


def _add_rows(target: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """In-place ``target[b, idx[b, i]] += val[b, i]`` dropping out-of-range
    indices (the reference's ``.at[].add(mode="drop")``; a dropped entry
    adds 0 at 0)."""
    ok = (idx >= 0) & (idx < target.shape[-1])
    return target.scatter_add_(-1, torch.where(ok, idx, 0), torch.where(ok, val, 0.0))


def _chunk_perm(seed: int, C: int, num_chunks: int) -> np.ndarray:
    """Pseudo-random visit order over the live chunks, padded chunks last —
    the reference's device-side permutation, computed on the host."""
    hc = hash_mix_np(
        hash_base_u32(seed, 0, 0x7F4A7C15), np.arange(C, dtype=np.int32)
    ).astype(np.float32)
    hc = hc + np.where(
        np.arange(C) >= num_chunks, np.float32(1e10), np.float32(0.0)
    )
    return np.argsort(hc, kind="stable")


def _sweep_plan(seeds, num_chunks, B: int, C: int, iters: int, refine_mode: bool,
                permute_chunks: bool, dev):
    """Each row's chunk order and hash bases: ``(perm, base_jit,
    base_gate)``, ``perm`` the (B, steps) numpy visit order (steps: the most
    live chunks of a row; padded chunks last) and the bases (iters, B,
    steps) int64 tensors on ``dev``, the row's per-iteration base plus the
    chunk id, as the reference adds them (``base_gate`` None outside refine
    mode)."""
    seeds = [int(s) & _M32 for s in seeds]
    nchunks = ([int(c) for c in num_chunks] if isinstance(num_chunks, (list, tuple))
               else [int(num_chunks)] * B)
    if permute_chunks:
        perm = np.stack([_chunk_perm(s, C, nc) for s, nc in zip(seeds, nchunks)])
    else:
        perm = np.broadcast_to(np.arange(C), (B, C))
    perm = np.array(perm[:, :max(nchunks)])

    def bases(extra):
        b = np.array([[hash_base_u32(s, it, extra) for s in seeds]
                      for it in range(iters)], dtype=np.int64)
        return torch.from_numpy((b[:, :, None] + perm[None]) & _M32).to(dev)

    return perm, bases(0x51ED2701), bases(0x2545F491) if refine_mode else None


def lp_sweep_batched(
    nodes: torch.Tensor,          # (C, N) int64, padded with n; or (B, C, N)
    node_valid: torch.Tensor,     # (C, N) bool; or (B, C, N)
    edge_dst: torch.Tensor,       # (C, E) int64, padded with n; or (B, C, E)
    edge_w: torch.Tensor,         # (C, E) float32; or (B, C, E)
    edge_src_slot: torch.Tensor,  # (C, E) int64; or (B, C, E)
    edge_valid: torch.Tensor,     # (C, E) bool; or (B, C, E)
    labels: torch.Tensor,         # (B, A) integer arena rows, A >= n + 1
    weights: torch.Tensor,        # (B, W) float32; slots >= num_labels hold +inf
    nw_ext: torch.Tensor,         # (A,) float32 node weights, 0 beyond n; or (B, A)
    restrict: torch.Tensor,       # (A,) int32, or a (1,) dummy
    U,                            # float, or one per row
    seeds: Sequence[int],         # one per row: drives that row's hashes
    num_labels: int,              # T: n in cluster mode, k in refine mode
    num_chunks,                   # live chunks (<= C); an int, or one per row
    *,
    iters: int,
    refine_mode: bool,
    use_restrict: bool,
    permute_chunks: bool,
):
    """``iters`` sweeps over the live chunks for each of ``B`` label rows;
    returns ``(labels, weights, moves)`` with ``moves`` per row (new
    tensors — the inputs are not modified).  At step ``c`` row ``b`` moves
    the nodes of chunk ``perm_b[c]``; one step serves the whole batch.

    Rows share the pack, the node weights, ``U`` and the chunk count (the
    batched GA), or — when the pack tensors carry a leading row axis — each
    row has its own pack, node weights, ``U`` and chunk count (the
    ``SessionGroup`` lanes: independent graphs of one shape bucket).  A row
    with fewer live chunks than the longest visits its padded chunks in the
    remaining steps, which move nothing, as under the reference's ``vmap``
    of a loop with a per-lane trip count.

    On CUDA tensors each step is the hand-written kernel
    (:class:`~repro_torch.kernels.lp_step.ChunkStep`: three launches for all
    rows, no host synchronize); other tensors take the kernel's plain
    version, :func:`lp_sweep_plain`."""
    if not labels.is_cuda:
        return lp_sweep_plain(
            nodes, node_valid, edge_dst, edge_w, edge_src_slot, edge_valid, labels, weights,
            nw_ext, restrict, U, seeds, num_labels, num_chunks, iters=iters,
            refine_mode=refine_mode, use_restrict=use_restrict, permute_chunks=permute_chunks,
        )
    dev = labels.device
    B = labels.shape[0]
    perm, base_jit, base_gate = _sweep_plan(seeds, num_chunks, B, nodes.shape[-2], iters,
                                            refine_mode, permute_chunks, dev)
    step = ChunkStep(
        (nodes, node_valid, edge_dst, edge_w, edge_src_slot, edge_valid),
        labels, weights, nw_ext, restrict,
        torch.from_numpy(np.broadcast_to(np.asarray(U, np.float32), (B,)).copy()).to(dev),
        torch.from_numpy(perm).to(dev), base_jit,
        base_jit if base_gate is None else base_gate, int(num_labels),
        refine_mode=refine_mode, use_restrict=use_restrict,
    )
    for it in range(iters):
        for c in range(perm.shape[1]):
            with _obs_span("lp.step"):
                step(it, c)
    return step.result()


def lp_sweep_plain(
    nodes: torch.Tensor,          # (C, N) int64, padded with n; or (B, C, N)
    node_valid: torch.Tensor,     # (C, N) bool; or (B, C, N)
    edge_dst: torch.Tensor,       # (C, E) int64, padded with n; or (B, C, E)
    edge_w: torch.Tensor,         # (C, E) float32; or (B, C, E)
    edge_src_slot: torch.Tensor,  # (C, E) int64; or (B, C, E)
    edge_valid: torch.Tensor,     # (C, E) bool; or (B, C, E)
    labels: torch.Tensor,         # (B, A) integer arena rows, A >= n + 1
    weights: torch.Tensor,        # (B, W) float32; slots >= num_labels hold +inf
    nw_ext: torch.Tensor,         # (A,) float32 node weights, 0 beyond n; or (B, A)
    restrict: torch.Tensor,       # (A,) int32, or a (1,) dummy
    U,                            # float, or one per row
    seeds: Sequence[int],         # one per row: drives that row's hashes
    num_labels: int,              # T: n in cluster mode, k in refine mode
    num_chunks,                   # live chunks (<= C); an int, or one per row
    *,
    iters: int,
    refine_mode: bool,
    use_restrict: bool,
    permute_chunks: bool,
):
    """The plain version of :func:`lp_sweep_batched`, on any device: each
    step a chain of torch ops for all rows (the CPU's path; the card tests
    hold the kernel to it bit for bit).  Row ``b`` makes exactly the
    reference's move decisions (see the module docstring)."""
    dev = labels.device
    B, A = labels.shape
    C, N = nodes.shape[-2:]
    lanes = nodes.dim() == 3
    T = int(num_labels)
    perm, base_jit, base_gate = _sweep_plan(seeds, num_chunks, B, C, iters, refine_mode,
                                            permute_chunks, dev)
    steps = perm.shape[1]
    if isinstance(U, (list, tuple)):
        U = torch.tensor(np.asarray(U, np.float32), device=dev)[:, None]
    else:
        U = torch.tensor(float(np.float32(U)), dtype=torch.float32, device=dev)
    nw_rows = nw_ext.expand(B, -1)
    labels = labels.clone()
    weights = weights.clone()
    moves = torch.zeros(B, dtype=torch.int64, device=dev)
    # rows that visit one chunk of one shared pack per step read views of
    # it; otherwise each row gathers its own chunk
    shared = not lanes and bool((perm == perm[:1]).all())
    perm_t = None if shared else torch.from_numpy(perm).to(dev)
    row = torch.arange(B, device=dev)
    for it in range(iters):
        for c in range(steps):
            with _obs_span("lp.step"):
                if shared:
                    cc = int(perm[0, c])
                    nd, ndv, dst, ew, slot, ok = (
                        t[cc].expand(B, -1) for t in
                        (nodes, node_valid, edge_dst, edge_w, edge_src_slot, edge_valid)
                    )
                else:
                    cc = perm_t[:, c]
                    nd, ndv, dst, ew, slot, ok = (
                        (t[row, cc] if lanes else t[cc]) for t in
                        (nodes, node_valid, edge_dst, edge_w, edge_src_slot, edge_valid)
                    )
                if use_restrict:
                    ok = ok & (restrict[dst] == restrict[nd.gather(1, slot)])
                cand = torch.where(ok, labels.gather(1, dst).to(torch.int64), T)
                wv = torch.where(ok, ew, 0.0)

                # ---- sort-based (node, label) run reduction: slots are grouped
                # in the pack, so the fused key orders runs like lexsort
                key, perm_e = torch.sort(slot * A + cand, dim=-1, stable=True)
                s_w = wv.gather(1, perm_e)
                new_run = torch.ones_like(key, dtype=torch.bool)
                new_run[:, 1:] = key[:, 1:] != key[:, :-1]
                run_id = torch.cumsum(new_run, 1) - 1
                E = key.shape[1]
                run_w = torch.zeros((B, E), dtype=torch.float32, device=dev).scatter_add_(
                    1, run_id, s_w
                )
                run_slot = torch.full((B, E), N, dtype=torch.int64, device=dev).scatter_(
                    1, run_id, key // A
                )
                run_lbl = torch.full((B, E), T, dtype=torch.int64, device=dev).scatter_(
                    1, run_id, key % A
                )

                # ---- eligibility + scoring
                own = labels.gather(1, nd).to(torch.int64)
                rs = torch.clamp(run_slot, max=N - 1)
                own_r = own.gather(1, rs)
                node_w_r = nw_rows.gather(1, nd.gather(1, rs))
                cand_w = weights.gather(1, torch.clamp(run_lbl, max=T))
                fits = cand_w + node_w_r <= U
                if refine_mode:
                    own_w = weights.gather(1, torch.clamp(own, max=T))
                    overloaded = own_w.gather(1, rs) > U
                    eligible = torch.where(
                        overloaded,
                        fits & (run_lbl != own_r),                      # must leave
                        (run_w > 0) & (fits | (run_lbl == own_r)),
                    )
                else:
                    eligible = (run_w > 0) & (fits | (run_lbl == own_r))
                eligible &= run_slot < N
                jitter = hash_jitter(base_jit[it, :, c, None], run_slot, run_lbl)
                score = torch.where(eligible, run_w + jitter, _NEG)

                # ---- per-node argmax over runs, min-label tie-break
                seg = torch.clamp(run_slot, max=N)   # runs of padded slots -> N
                best = torch.full((B, N + 1), _NEG, dtype=torch.float32, device=dev)
                best = best.scatter_reduce(1, seg, score, "amax", include_self=True)
                is_best = (score >= best.gather(1, seg)) & (score > _NEG / 2)
                win = torch.full((B, N + 1), T, dtype=torch.int64, device=dev)
                win = win.scatter_reduce(
                    1, seg, torch.where(is_best, run_lbl, T), "amin", include_self=True
                )[:, :N]
                new_lbl = torch.where(ndv & (win < T), win, own)

                moved = ndv & (new_lbl != own)
                nwv = nw_rows.gather(1, nd)
                if refine_mode:
                    # Influx gating: every node of a chunk sees the same stale
                    # block weights, so cap each block's net inflow at its
                    # headroom in expectation: accept an incoming mover with
                    # probability clip((U - w + outflow) / inflow, 0, 1).
                    mv_w = torch.where(moved, nwv, 0.0)
                    zero_w = torch.zeros_like(weights)
                    inflow = _add_rows(zero_w.clone(), torch.where(moved, new_lbl, T), mv_w)
                    outflow = _add_rows(zero_w, torch.where(moved, own, T), mv_w)
                    head = U - weights + outflow
                    p_in = torch.clamp(head / torch.clamp(inflow, min=1e-9), 0.0, 1.0)
                    gate_u = hash_jitter(base_gate[it, :, c, None], nd, new_lbl) / 0.49
                    moved &= gate_u < p_in.gather(1, torch.clamp(new_lbl, max=T))
                    new_lbl = torch.where(moved, new_lbl, own)
                labels.scatter_(1, nd, torch.where(ndv, new_lbl, own).to(labels.dtype))
                _add_rows(weights, torch.where(moved, own, T), torch.where(moved, -nwv, 0.0))
                _add_rows(weights, torch.where(moved, new_lbl, T), torch.where(moved, nwv, 0.0))
                # keep the sentinel weight slot at +inf (the adds above target it
                # with value 0 for unmoved nodes)
                weights[:, T] = float("inf")
                moves += moved.sum(dim=1)
    return labels, weights, moves




def lp_sweep(
    nodes: torch.Tensor,
    node_valid: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_w: torch.Tensor,
    edge_src_slot: torch.Tensor,
    edge_valid: torch.Tensor,
    labels: torch.Tensor,         # (A,) int32 arena, A >= n + 1
    weights: torch.Tensor,        # (W,) float32; slots >= num_labels hold +inf
    nw_ext: torch.Tensor,
    restrict: torch.Tensor,
    U: float,
    seed: int,
    num_labels: int,
    num_chunks: int,
    *,
    iters: int,
    refine_mode: bool,
    use_restrict: bool,
    permute_chunks: bool,
):
    """One label row of :func:`lp_sweep_batched`; returns ``(labels,
    weights, moves)`` for that row."""
    labels, weights, moves = lp_sweep_batched(
        nodes, node_valid, edge_dst, edge_w, edge_src_slot, edge_valid,
        labels[None], weights[None], nw_ext, restrict, U, [seed], num_labels,
        num_chunks, iters=iters, refine_mode=refine_mode,
        use_restrict=use_restrict, permute_chunks=permute_chunks,
    )
    return labels[0], weights[0], moves[0]


# --------------------------------------------------------------------------
# host wrappers
# --------------------------------------------------------------------------


def _ext(arr: np.ndarray, fill) -> np.ndarray:
    return np.concatenate([arr, np.array([fill], dtype=arr.dtype)])


def _pack_tensors(pack: ChunkPack, dev: torch.device):
    def up(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dt)

    return (
        up(pack.nodes, torch.int64), up(pack.node_valid, torch.bool),
        up(pack.edge_dst, torch.int64), up(pack.edge_w, torch.float32),
        up(pack.edge_src_slot, torch.int64), up(pack.edge_valid, torch.bool),
    )


def lp_cluster(
    g: GraphNP,
    U: float,
    iters: int = 3,
    seed: int = 0,
    restrict: Optional[np.ndarray] = None,
    pack: Optional[ChunkPack] = None,
    max_nodes: int = 4096,
    max_edges: int = 65536,
    order: str = "degree",
    device=None,
) -> LPResult:
    """Size-constrained LP *clustering* (coarsening phase) on exact shapes."""
    dev = resolve_device(device)
    n = g.n
    if pack is None:
        pack = pack_chunks(
            g, make_order(g, order, seed), max_nodes=max_nodes, max_edges=max_edges
        )
    labels0 = np.arange(n + 1, dtype=np.int32)
    weights0 = _ext(g.nw.astype(np.float32), np.float32(np.inf))
    nw_ext = _ext(g.nw.astype(np.float32), np.float32(0.0))
    if restrict is not None:
        r = _ext(restrict.astype(np.int32), np.int32(-1))
    else:
        r = np.zeros(1, np.int32)  # dummy
    labels, _, moves = lp_sweep(
        *_pack_tensors(pack, dev),
        torch.from_numpy(labels0).to(dev),
        torch.from_numpy(weights0).to(dev),
        torch.from_numpy(nw_ext).to(dev),
        torch.from_numpy(r).to(dev),
        U, seed & 0x7FFFFFFF, n, pack.num_chunks,
        iters=iters, refine_mode=False,
        use_restrict=restrict is not None, permute_chunks=False,
    )
    return LPResult(labels=labels[:n].cpu().numpy(), moves=int(moves), iters=iters)


def lp_refine(
    g: GraphNP,
    labels_in: np.ndarray,
    k: int,
    U: float,
    iters: int = 6,
    seed: int = 0,
    pack: Optional[ChunkPack] = None,
    max_nodes: int = 4096,
    max_edges: int = 65536,
    order: str = "random",
    device=None,
) -> LPResult:
    """Size-constrained LP as *local search* (uncoarsening phase)."""
    dev = resolve_device(device)
    n = g.n
    if pack is None:
        pack = pack_chunks(
            g, make_order(g, order, seed), max_nodes=max_nodes, max_edges=max_edges
        )
    labels0 = _ext(labels_in.astype(np.int32), np.int32(k))
    bw = np.bincount(labels_in, weights=g.nw, minlength=k)[:k].astype(np.float32)
    weights0 = _ext(bw, np.float32(np.inf))
    nw_ext = _ext(g.nw.astype(np.float32), np.float32(0.0))
    labels, _, moves = lp_sweep(
        *_pack_tensors(pack, dev),
        torch.from_numpy(labels0).to(dev),
        torch.from_numpy(weights0).to(dev),
        torch.from_numpy(nw_ext).to(dev),
        torch.zeros(1, dtype=torch.int32, device=dev),
        U, seed & 0x7FFFFFFF, k, pack.num_chunks,
        iters=iters, refine_mode=True, use_restrict=False, permute_chunks=False,
    )
    return LPResult(labels=labels[:n].cpu().numpy(), moves=int(moves), iters=iters)


# --------------------------------------------------------------------------
# numpy mirrors of the hash family (bit-exact): scalar mixing in python
# ints masked to 32 bits, array mixing on uint32 ndarrays (which wrap)
# --------------------------------------------------------------------------


def hash_u32_scalar(h: int, x: int) -> int:
    """Scalar mixer round (python ints, wrap-around 32-bit)."""
    h = ((h ^ (x & _M32)) * _MIX) & _M32
    return h ^ (h >> 15)


def hash_base_u32(seed: int, it: int, extra: int) -> int:
    """Per-(seed, iteration, stream) hash base; a python int in [0, 2^32)."""
    s = (
        (seed & _M32) * 0x9E3779B1
        + (it & _M32) * 0x85EBCA77
        + (extra & _M32) * 0x27D4EB2F
    ) & _M32
    return hash_u32_scalar(0x165667B1, s)


def hash_mix_np(h, x):
    """Array mixer round: h is a python int or uint32 array."""
    xa = np.asarray(x)
    if isinstance(h, (int, np.integer)) and xa.ndim == 0:
        return np.uint32(hash_u32_scalar(int(h) & _M32, int(xa)))
    if isinstance(h, (int, np.integer)):
        h = np.uint32(h & _M32)
    h = (h ^ xa.astype(np.uint32)) * np.uint32(_MIX)
    return h ^ (h >> np.uint32(15))


def hash_jitter_np(base, a, b) -> np.ndarray:
    """float32 jitter in [0, 0.49) (numpy twin of :func:`hash_jitter`)."""
    h = hash_mix_np(hash_mix_np(base, a), b)
    return (
        (h & np.uint32(0xFFFFFF)).astype(np.float32)
        / np.float32(1 << 24)
        * np.float32(0.49)
    )


def hash_unit_np(base, a, b) -> np.ndarray:
    """Uniform-ish float32 in [0, 1) from integer coordinates."""
    h = hash_mix_np(hash_mix_np(base, a), b)
    return (h & np.uint32(0xFFFFFF)).astype(np.float32) / np.float32(1 << 24)


def hash_u32_np(base, a, b) -> np.ndarray:
    """Raw uint32 stream from integer coordinates."""
    return hash_mix_np(hash_mix_np(base, a), b)


def sweep_refine_numpy(
    nodes: np.ndarray,          # (C, N) int32 pack layout (padded, sentinel n)
    node_valid: np.ndarray,     # (C, N) bool
    edge_dst: np.ndarray,       # (C, E) int32
    edge_w: np.ndarray,         # (C, E) float32
    edge_src_slot: np.ndarray,  # (C, E) int32
    edge_valid: np.ndarray,     # (C, E) bool
    labels: np.ndarray,         # (A,) int32, A >= n + 1; k beyond n
    weights: np.ndarray,        # (W,) float32 block weights; +inf at slots >= k
    nw_ext: np.ndarray,         # (A,) float32 node weights, 0 beyond n
    U: float,
    seed: int,
    num_labels: int,            # k
    num_chunks: int,
    iters: int,
) -> tuple:
    """Bit-exact numpy mirror of ``lp_sweep(refine_mode=True,
    use_restrict=False, permute_chunks=True)`` for integral weights (float32
    sums are then exact in any order).  Returns ``(labels, weights)``."""
    C, N = nodes.shape
    labels = labels.astype(np.int32).copy()
    weights = weights.astype(np.float32).copy()
    U = np.float32(U)
    k = int(num_labels)
    NEG = np.float32(_NEG)
    perm = _chunk_perm(seed, C, num_chunks)
    for it in range(iters):
        base1 = hash_base_u32(seed, it, 0x51ED2701)
        base2 = hash_base_u32(seed, it, 0x2545F491)
        for ci in range(num_chunks):
            cc = int(perm[ci])
            nd = nodes[cc]
            ndv = node_valid[cc]
            ev = edge_valid[cc]
            dst = edge_dst[cc][ev]
            w0 = edge_w[cc][ev].astype(np.float32)
            slot = edge_src_slot[cc][ev]
            cand = labels[dst].astype(np.int64)
            key = slot.astype(np.int64) * np.int64(k + 1) + cand
            uniq, inv = np.unique(key, return_inverse=True)
            run_w = np.zeros(uniq.shape[0], np.float32)
            np.add.at(run_w, inv, w0)
            run_slot = (uniq // (k + 1)).astype(np.int32)
            run_lbl = (uniq % (k + 1)).astype(np.int32)
            own = labels[nd]                       # (N,) label k at sentinels
            own_r = own[run_slot]
            node_w_r = nw_ext[nd[run_slot]]
            cand_w = weights[np.minimum(run_lbl, k)]
            fits = cand_w + node_w_r <= U
            overloaded = weights[np.minimum(own_r, k)] > U
            eligible = np.where(
                overloaded,
                fits & (run_lbl != own_r),
                (run_w > 0) & (fits | (run_lbl == own_r)),
            )
            base_c = (base1 + cc) & _M32
            jitter = hash_jitter_np(base_c, run_slot, run_lbl)
            score = np.where(eligible, run_w + jitter, NEG)
            best = np.full(N + 1, NEG, np.float32)
            np.maximum.at(best, run_slot, score)
            is_best = (score >= best[run_slot]) & (score > NEG / 2)
            win = np.full(N + 1, k, np.int32)
            np.minimum.at(
                win, run_slot, np.where(is_best, run_lbl, np.int32(k))
            )
            win = win[:N]
            new_lbl = np.where(ndv & (win < k), win, own).astype(np.int32)
            moved = ndv & (new_lbl != own)
            nwv = nw_ext[nd]
            mv_w = np.where(moved, nwv, np.float32(0.0)).astype(np.float32)
            inflow = np.zeros(weights.shape[0], np.float32)
            outflow = np.zeros(weights.shape[0], np.float32)
            np.add.at(inflow, np.where(moved, new_lbl, k), mv_w)
            np.add.at(outflow, np.where(moved, own, k), mv_w)
            head = (U - weights + outflow).astype(np.float32)
            with np.errstate(invalid="ignore", over="ignore"):
                p_in = np.clip(
                    head / np.maximum(inflow, np.float32(1e-9)),
                    np.float32(0.0),
                    np.float32(1.0),
                )
            gate_u = hash_jitter_np(
                (base2 + cc) & _M32, nd, new_lbl
            ) / np.float32(0.49)
            moved &= gate_u < p_in[np.minimum(new_lbl, k)]
            new_lbl = np.where(moved, new_lbl, own).astype(np.int32)
            labels[nd[ndv]] = new_lbl[ndv]
            np.add.at(
                weights, np.where(moved, own, k),
                np.where(moved, -nwv, np.float32(0.0)).astype(np.float32),
            )
            np.add.at(
                weights, np.where(moved, new_lbl, k),
                np.where(moved, nwv, np.float32(0.0)).astype(np.float32),
            )
            weights[k] = np.inf
    return labels, weights


# --------------------------------------------------------------------------
# numpy reference: the paper's exact sequential semantics (the small
# coarse levels and the coarsest-level evolutionary algorithm)
# --------------------------------------------------------------------------


def sclap_numpy(
    g: GraphNP,
    labels: np.ndarray,
    U: float,
    iters: int,
    seed: int = 0,
    refine_mode: bool = False,
    num_labels: Optional[int] = None,
    restrict: Optional[np.ndarray] = None,
    order: Optional[str] = None,
) -> LPResult:
    """Asynchronous sequential SCLaP — one node at a time, moves instantly
    visible (the paper's original sequential algorithm)."""
    rng = np.random.default_rng(seed)
    labels = labels.astype(np.int64).copy()
    T = num_labels if num_labels is not None else g.n
    weights = np.zeros(T, dtype=np.float64)
    np.add.at(weights, labels, g.nw)
    if order is None:
        order = "random" if refine_mode else "degree"
    total_moves = 0
    for it in range(iters):
        perm = make_order(g, order, seed + 17 * it)
        for v in perm:
            lo, hi = g.indptr[v], g.indptr[v + 1]
            if hi == lo:
                continue
            nbr = g.indices[lo:hi]
            wts = g.ew[lo:hi].astype(np.float64)
            lbl = labels[nbr]
            if restrict is not None:
                m = restrict[nbr] == restrict[v]
                nbr, wts, lbl = nbr[m], wts[m], lbl[m]
                if nbr.size == 0:
                    continue
            cand, inv = np.unique(lbl, return_inverse=True)
            conn = np.zeros(cand.shape[0])
            np.add.at(conn, inv, wts)
            own = labels[v]
            nw_v = g.nw[v]
            fits = weights[cand] + nw_v <= U
            if refine_mode and weights[own] > U:
                elig = fits & (cand != own)
            else:
                elig = (conn > 0) & (fits | (cand == own))
            if not elig.any():
                continue
            conn = conn + rng.random(conn.shape[0]) * 0.49
            conn[~elig] = -np.inf
            tgt = cand[int(np.argmax(conn))]
            if tgt != own:
                weights[own] -= nw_v
                weights[tgt] += nw_v
                labels[v] = tgt
                total_moves += 1
    return LPResult(labels=labels.astype(np.int32), moves=total_moves, iters=iters)
