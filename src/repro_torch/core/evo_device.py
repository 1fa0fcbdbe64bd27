"""Batched island evolutionary search (KaFFPaE, §II-C/IV-E) on the device.

The torch twin of ``repro.core.evo_device``: the whole population is a
``(S, A)`` label batch and every step works on all rows at once —

* **batched greedy-growing seeds** — hash-scored degree-biased seed draw,
  degree/diameter-proportional synchronous frontier rounds
  (``evolutionary.grow_rounds_bound``; a row stops when it is fully
  assigned or a round assigns nothing), round-robin leftovers;
* **batched refinement** — :func:`~.label_propagation.lp_sweep_batched`
  over the engine's cached chunk pack (one pack for the whole population),
  then synchronous gain (FM-lite) and balance-repair rounds;
* **overlay-cell combine** — ``(P1(v), P2(v))`` cell ids from a sort/rank
  relabel, cell-granular block moves instead of a per-individual
  contraction;
* **device-side elitism, selection and gossip** — integer fitness keys
  (feasibility first, then cut; exact because the engine gates this path on
  integral weights) and stateless hash draws for every decision.

Shapes follow the reference: a pow2 population bucket ``Sb`` (seed phase)
or ``Ib`` (children), the node arena ``Ab = pow2(n + 1)`` and the block
bucket ``Kb = pow2(k + 1)``, so rows and padding line up with the numpy
oracle ``evolutionary.evolve_batched_numpy``, which the batch matches bit
for bit.  Where the reference scatters with ``mode="drop"``, the port
appends a dropped row or slot; uint32 hashes run on int64 masked to 32
bits.  The only host syncs are one per greedy-growing round (has every row
stopped?).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .evolutionary import (
    CELL_ROUNDS,
    COMBINE_PROB,
    GAIN_ROUNDS,
    INFEAS_PENALTY,
    MUTATE_FRAC,
    REPAIR_ROUNDS,
    TAG_CELL,
    TAG_CELL_GATE,
    TAG_GAIN,
    TAG_GAIN_GATE,
    TAG_GROW,
    TAG_MUT_FLIP,
    TAG_MUT_LBL,
    TAG_OP,
    TAG_P1,
    TAG_P2,
    TAG_REPAIR,
    TAG_SEEDKEY,
    TAG_SWEEP,
)
from .label_propagation import hash_base_u32, hash_jitter, hash_mix, lp_sweep_batched
from .metrics import block_weights_dense, cut_from_arcs

__all__ = ["EvoGraph", "evo_seed_step", "evo_generation_step_sharded"]

_NEG = -1e30
_HAS = float(np.float32(_NEG / 2))      # "has an eligible block" threshold
_IMAX = 2**31 - 1
_IMIN = -(2**31)
_COMBINE_P = float(np.float32(COMBINE_PROB))


@dataclass
class EvoGraph:
    """Everything one evolution run reads, resident on one device."""

    pack: Tuple[torch.Tensor, ...]  # (nodes, node_valid, edge_dst, edge_w,
                                    #  edge_src_slot, edge_valid), bucket-padded
    num_chunks: int
    src: torch.Tensor               # (M,) int64 arc sources (pad: node 0, w 0)
    dst: torch.Tensor               # (M,) int64
    ew: torch.Tensor                # (M,) float32
    nw: torch.Tensor                # (Ab,) float32, 0 beyond n
    deg_f: torch.Tensor             # (Ab,) float32 degrees, 0 beyond n
    n: int
    k: int
    Kb: int
    Lmax: float                     # float32-exact
    seed: int                       # masked to 31 bits
    refine_iters: int

    def __post_init__(self):
        dev = self.nw.device
        self.iota = torch.arange(self.nw.shape[0], dtype=torch.int64, device=dev)
        self.kio = torch.arange(self.Kb, dtype=torch.int64, device=dev)
        self.live = self.iota < self.n

    def to(self, device) -> "EvoGraph":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(
            self, pack=tuple(t.to(device) for t in self.pack),
            src=self.src.to(device), dst=self.dst.to(device), ew=self.ew.to(device),
            nw=self.nw.to(device), deg_f=self.deg_f.to(device),
        )


def _hash_u32(base, a, b):
    """Raw uint32 stream (twin of ``hash_u32_np``)."""
    return hash_mix(hash_mix(base, a), b)


def _hash_unit(base, a, b):
    """Uniform-ish float32 in [0, 1) (twin of ``hash_unit_np``)."""
    return (_hash_u32(base, a, b) & 0xFFFFFF).to(torch.float32) / float(1 << 24)


# --------------------------------------------------------------------------
# building blocks on (B, Ab) label rows; each mirrors its numpy-oracle twin
# --------------------------------------------------------------------------


def _bw_dev(G: EvoGraph, lab):
    """(raw, +inf-padded) block weights, ``(B, Kb)`` each."""
    bw = block_weights_dense(lab, G.nw, G.Kb)
    return bw, torch.where(G.kio < G.k, bw, float("inf"))


def _evaluate(G: EvoGraph, lab):
    """Fitness keys ``(B,)``: cut, plus INFEAS_PENALTY if infeasible."""
    cut = cut_from_arcs(lab, G.src, G.dst, G.ew)
    bw, _ = _bw_dev(G, lab)
    bwmax = torch.where(G.kio < G.k, bw, -float("inf")).max(dim=-1).values
    feas = bwmax <= float(np.float32(G.Lmax) + np.float32(1e-6))
    return cut.to(torch.int64) + torch.where(feas, 0, INFEAS_PENALTY)


def _conn(G: EvoGraph, src, tgt, w):
    """``(B, Ab, Kb)`` connection weights: ``conn[b, src, tgt[b]] += w``."""
    B, Ab = tgt.shape[0], G.nw.shape[0]
    conn = torch.zeros((B, Ab * G.Kb), dtype=torch.float32, device=tgt.device)
    conn.scatter_add_(1, src * G.Kb + tgt, w.expand(tgt.shape))
    return conn.view(B, Ab, G.Kb)


def _jitter(G: EvoGraph, base):
    """``(B, Ab, Kb)`` tie-break jitter from per-row bases ``(B,)``."""
    return hash_jitter(base[:, None, None], G.iota[None, :, None], G.kio[None, None, :])


def _pick(conn, elig, jit):
    """Best eligible block per node (first on ties) and whether one exists."""
    score = torch.where(elig, conn + jit, _NEG)
    b = torch.argmax(score, dim=-1)
    has = score.gather(-1, b[..., None])[..., 0] > _HAS
    return b, has


def _grow_round(G: EvoGraph, r: int, lab, s_idx):
    tgt = lab[:, G.dst]
    mask = tgt >= 0
    conn = _conn(G, G.src, torch.where(mask, tgt, 0), torch.where(mask, G.ew, 0.0))
    asg = lab >= 0
    bw = block_weights_dense(torch.where(asg, lab, 0), torch.where(asg, G.nw, 0.0), G.Kb)
    bwx = torch.where(G.kio < G.k, bw, float("inf"))
    base_r = _hash_u32(hash_base_u32(G.seed, r, TAG_GROW), s_idx, 0)
    fits = bwx[:, None, :] + G.nw[None, :, None] <= G.Lmax
    b, has = _pick(conn, (conn > 0) & fits, _jitter(G, base_r))
    unas = (lab < 0) & G.live
    return torch.where(unas & has, b, lab)


def _greedy(G: EvoGraph, s_idx, rounds: int):
    """Batched greedy growing, row ``b`` seeded by individual ``s_idx[b]``
    (oracle: ``_greedy_grow_np``).  A row stops at the round budget, when
    it is fully assigned, or when a round assigns nothing (a stalled
    frontier never recovers); stopped rows are carried unchanged while the
    others go on, as under the reference's ``vmap`` of a while loop."""
    B = s_idx.shape[0]
    iota, live = G.iota, G.live
    unit = _hash_unit(hash_base_u32(G.seed, 0, TAG_SEEDKEY), iota[None, :], s_idx[:, None])
    skey = torch.where(live, unit * (G.deg_f + 1.0), -float("inf"))
    order = torch.sort(-skey, dim=1, stable=True).indices
    rank = torch.empty_like(order).scatter_(1, order, iota.expand(B, -1))
    lab = torch.where((rank < G.k) & live, rank, -1)
    active = torch.ones(B, dtype=torch.bool, device=lab.device)
    prev = None
    for r in range(rounds):
        cnt = ((lab < 0) & live).sum(dim=1)
        active &= cnt > 0
        if prev is not None:
            active &= cnt < prev
        if not bool(active.any()):
            break
        lab = torch.where(active[:, None], _grow_round(G, r, lab, s_idx), lab)
        prev = cnt
    unas = (lab < 0) & live
    pos = torch.cumsum(unas, dim=1) - 1
    lab = torch.where(unas, pos % G.k, lab)
    return torch.where(live, lab, G.k)


def _gain_round(G: EvoGraph, lab, base_score, base_gate):
    """Synchronous best-gain round (oracle: ``fm.gain_round_np``)."""
    conn = _conn(G, G.src, lab[:, G.dst], G.ew)
    own = conn.gather(2, torch.clamp(lab, max=G.Kb - 1)[..., None])[..., 0]
    _, bwx = _bw_dev(G, lab)
    fits = bwx[:, None, :] + G.nw[None, :, None] <= G.Lmax
    elig = fits & (G.kio != lab[..., None]) & (conn > own[..., None])
    b, has = _pick(conn, elig, _jitter(G, base_score))
    u = _hash_unit(base_gate[:, None], G.iota[None, :], 0)
    return torch.where(has & (u < 0.5) & G.live, b, lab)


def _repair_rounds(G: EvoGraph, lab, ctxs, phase: int):
    """REPAIR_ROUNDS synchronous feasibility-repair rounds (oracle:
    ``_repair_rounds_np``): overloaded blocks shed their excess, in
    expectation, into the lightest block."""
    base = hash_base_u32(G.seed, phase, TAG_REPAIR)
    for r in range(REPAIR_ROUNDS):
        _, bwx = _bw_dev(G, lab)
        tgt = torch.argmin(bwx, dim=1)[:, None]
        excess = torch.clamp((bwx - G.Lmax) / torch.clamp(bwx, min=1.0), 0.0, 1.0)
        u = _hash_unit(_hash_u32(base, ctxs, r)[:, None], G.iota[None, :], 0)
        own = torch.clamp(lab, max=G.k)
        movable = (
            G.live
            & (bwx > G.Lmax).gather(1, own)
            & (lab != tgt)
            & (bwx.gather(1, tgt) + G.nw <= G.Lmax)
        )
        gate = u < 1.5 * excess.gather(1, own)
        lab = torch.where(movable & gate, tgt, lab)
    return lab


def _mutate_init(G: EvoGraph, lab, i_ctx, gen: int):
    """Boundary perturbation (oracle: ``_mutate_init_np``): a hash-chosen
    eighth of the boundary nodes take hash-drawn labels."""
    diff = (lab[:, G.src] != lab[:, G.dst]).to(torch.int32)
    bnd = torch.zeros(lab.shape, dtype=torch.int32, device=lab.device)
    bnd = bnd.scatter_add_(1, G.src.expand(diff.shape), diff) > 0
    flip_base = _hash_u32(hash_base_u32(G.seed, gen + 1, TAG_MUT_FLIP), i_ctx, 0)
    lbl_base = _hash_u32(hash_base_u32(G.seed, gen + 1, TAG_MUT_LBL), i_ctx, 0)
    u = _hash_unit(flip_base[:, None], G.iota[None, :], 0)
    newl = _hash_u32(lbl_base[:, None], G.iota[None, :], 0) % G.k
    flip = bnd & (u < MUTATE_FRAC) & G.live
    return torch.where(flip, newl, lab)


def _combine_init(G: EvoGraph, lab1, lab2, lab_better, i_ctx, gen: int):
    """Overlay-cell combine (oracle: ``_combine_init_np``): cells are the
    contiguous ranks of ``(P1(v), P2(v))``, the child starts from the better
    parent, then CELL_ROUNDS synchronous cell-granular block moves."""
    B, Ab = lab1.shape
    live, kio = G.live, G.kio
    ov = torch.where(live, lab1 * G.k + lab2, _IMAX)
    sl = torch.sort(ov, dim=1).values
    newrun = torch.empty_like(sl, dtype=torch.bool)
    newrun[:, :1] = sl[:, :1] < _IMAX
    newrun[:, 1:] = (sl[:, 1:] != sl[:, :-1]) & (sl[:, 1:] < _IMAX)
    rank = torch.cumsum(newrun, dim=1) - 1
    posn = torch.clamp(torch.searchsorted(sl, ov), max=Ab - 1)
    cf = torch.where(live, rank.gather(1, posn), Ab - 1)   # sentinel cell for pads
    blk_raw = torch.full((B, Ab), -1, dtype=torch.int64, device=lab1.device)
    blk_raw = blk_raw.scatter_reduce(
        1, cf, torch.where(live, lab_better, -1), "amax", include_self=True
    )
    blk = torch.where(blk_raw >= 0, blk_raw, G.k)
    cw = torch.zeros((B, Ab), dtype=torch.float32, device=lab1.device)
    cw = cw.scatter_add_(1, cf, G.nw.expand(B, -1))
    cu = cf[:, G.src]
    cv = cf[:, G.dst]
    w_cross = torch.where(cu != cv, G.ew, 0.0)
    for r in range(CELL_ROUNDS):
        bwx = torch.where(kio < G.k, block_weights_dense(blk, cw, G.Kb), float("inf"))
        conn = _conn(G, cu, blk.gather(1, cv), w_cross)
        own = conn.gather(2, torch.clamp(blk, max=G.Kb - 1)[..., None])[..., 0]
        jbase = _hash_u32(hash_base_u32(G.seed, gen + 1, TAG_CELL), i_ctx, r)
        fits = bwx[:, None, :] + cw[..., None] <= G.Lmax
        elig = fits & (kio != blk[..., None]) & (conn > own[..., None])
        b, has = _pick(conn, elig, _jitter(G, jbase))
        gbase = _hash_u32(hash_base_u32(G.seed, gen + 1, TAG_CELL_GATE), i_ctx, r)
        u = _hash_unit(gbase[:, None], G.iota[None, :], 0)
        blk = torch.where(has & (u < 0.5), b, blk)
    return torch.where(live, blk.gather(1, cf), G.k)


def _refine_batch(G: EvoGraph, labs, ctx0: int, phase: int):
    """Batched chunk sweep + gain rounds + repair rounds (oracle:
    ``_refine_np``).  Row ``b``'s hash context is ``ctx0 + b`` (the flat
    individual in the seed phase, the island in generations); ``phase`` is
    0 for seeding and ``gen + 1`` in generations."""
    B = labs.shape[0]
    ctxs = torch.arange(ctx0, ctx0 + B, dtype=torch.int64, device=labs.device)
    sweep_base = hash_base_u32(G.seed, phase, TAG_SWEEP)
    seeds = [_hash_u32(sweep_base, c, 0) & 0x7FFFFFFF for c in range(ctx0, ctx0 + B)]
    _, ws = _bw_dev(G, labs)
    labs, _, _ = lp_sweep_batched(
        *G.pack, labs, ws, G.nw, torch.zeros(1, dtype=torch.int32, device=labs.device),
        G.Lmax, seeds, G.k, G.num_chunks,
        iters=G.refine_iters, refine_mode=True, use_restrict=False,
        permute_chunks=True,
    )
    for r in range(GAIN_ROUNDS):
        base_s = _hash_u32(hash_base_u32(G.seed, phase, TAG_GAIN), ctxs, r)
        base_g = _hash_u32(hash_base_u32(G.seed, phase, TAG_GAIN_GATE), ctxs, r)
        labs = _gain_round(G, labs, base_s, base_g)
    return _repair_rounds(G, labs, ctxs, phase)


def _worst_slots(keys, I: int, P: int):
    """Per-island replacement victim: max key, first member (oracle:
    ``_worst_member_np``).  Returns the member index per island id."""
    Sb = keys.shape[0]
    iota_s = torch.arange(Sb, dtype=torch.int64, device=keys.device)
    isl = iota_s // P
    valid = iota_s < I * P
    seg = torch.where(valid, isl, Sb)                       # slot Sb is dropped
    wk = torch.full((Sb + 1,), _IMIN, dtype=torch.int64, device=keys.device)
    wk = wk.scatter_reduce(0, seg, keys, "amax", include_self=True)
    is_worst = valid & (keys == wk[isl])
    wmem = torch.full((Sb + 1,), _IMAX, dtype=torch.int64, device=keys.device)
    wmem = wmem.scatter_reduce(
        0, seg, torch.where(is_worst, iota_s - isl * P, _IMAX), "amin",
        include_self=True,
    )
    return wmem[:Sb]


def _set_rows(x, tgt, rows):
    """``x[tgt] = rows`` where ``tgt == len(x)`` drops the row."""
    ext = torch.cat([x, x[:1]])
    ext[tgt] = rows
    return ext[:-1]


def _replace_worst(labs, keys, cand_labs, cand_keys, I: int, P: int, Ib: int, strict: bool):
    """Island ``i`` (``< I``) puts candidate ``i`` in place of its worst
    member if the candidate's key is ``<`` (``strict``) or ``<=`` the
    victim's."""
    Sb = keys.shape[0]
    i_io = torch.arange(Ib, dtype=torch.int64, device=keys.device)
    wmem = _worst_slots(keys, I, P)
    wflat = torch.clamp(i_io * P + wmem[torch.clamp(i_io, max=Sb - 1)], max=Sb - 1)
    better = cand_keys < keys[wflat] if strict else cand_keys <= keys[wflat]
    tgt = torch.where((i_io < I) & better, wflat, Sb)
    return _set_rows(labs, tgt, cand_labs), _set_rows(keys, tgt, cand_keys)


def best_row(labs, keys, S: int):
    """Index of the best of the first ``S`` rows (min key, first row)."""
    Sb = keys.shape[0]
    iota_s = torch.arange(Sb, dtype=torch.int64, device=keys.device)
    valid = iota_s < S
    bkey = torch.where(valid, keys, _IMAX).min()
    bidx = torch.where(valid & (keys == bkey), iota_s, _IMAX).min()
    return torch.clamp(bidx, max=Sb - 1), bkey


# --------------------------------------------------------------------------
# phase entry points
# --------------------------------------------------------------------------


def evo_seed_step(G: EvoGraph, seed_labels, seed_mask, I: int, P: int, grow_rounds: int):
    """Build and evaluate the initial population: batched greedy growing
    for every row, batched refinement, then the rows of ``seed_mask`` taken
    verbatim from ``seed_labels`` (the V-cycle's projected solution).
    Returns ``(labs (Sb, Ab), keys (Sb,))``; rows ``>= I * P`` are padding
    with key ``2^31 - 1``."""
    Sb = seed_labels.shape[0]
    iota_s = torch.arange(Sb, dtype=torch.int64, device=seed_labels.device)
    grown = _greedy(G, iota_s, grow_rounds)
    refined = _refine_batch(G, grown, 0, 0)
    labs = torch.where(seed_mask[:, None], seed_labels, refined)
    keys = torch.where(iota_s < I * P, _evaluate(G, labs), _IMAX)
    return labs, keys


def _generation_local(G: EvoGraph, labs, keys, gen: int, island_offset: int,
                      I: int, P: int, Ib: int):
    """A generation up to its gossip: selection, combine or mutate, batched
    refinement, elitism and replacement of each island's worst.  Islands
    hash on their global id ``island_offset + i``."""
    Sb = labs.shape[0]
    i_io = torch.arange(Ib, dtype=torch.int64, device=labs.device)
    i_ctx = i_io + island_offset

    # ---- selection (stateless hash draws)
    u_op = _hash_unit(hash_base_u32(G.seed, gen + 1, TAG_OP), i_ctx, 0)
    r1 = _hash_u32(hash_base_u32(G.seed, gen + 1, TAG_P1), i_ctx, 0) % P
    off = 1 + _hash_u32(hash_base_u32(G.seed, gen + 1, TAG_P2), i_ctx, 0) % max(P - 1, 1)
    r2 = (r1 + off) % P
    do_combine = (u_op < _COMBINE_P) & (P >= 2)
    p1 = torch.clamp(i_io * P + r1, max=Sb - 1)
    p2 = torch.clamp(i_io * P + r2, max=Sb - 1)
    better = torch.where(keys[p1] <= keys[p2], p1, p2)
    base_flat = torch.where(do_combine, better, p1)
    lab_base = labs[base_flat]
    comb = _combine_init(G, labs[p1], labs[p2], lab_base, i_ctx, gen)
    mut = _mutate_init(G, lab_base, i_ctx, gen)
    init = torch.where(do_combine[:, None], comb, mut)
    children = _refine_batch(G, init, island_offset, gen + 1)
    ckeys = _evaluate(G, children)

    # ---- elitism: an offspring is never worse than its baseline
    bkeys = keys[base_flat]
    keep = ckeys <= bkeys
    children = torch.where(keep[:, None], children, lab_base)
    ckeys = torch.where(keep, ckeys, bkeys)

    # ---- synchronous replacement of each island's worst
    return _replace_worst(labs, keys, children, ckeys, I, P, Ib, strict=False)


def _gossip(labs, keys, blab, bkey, I: int, P: int, Ib: int):
    """The global best ``(blab, bkey)`` replaces each island's worst if it
    is strictly better."""
    return _replace_worst(labs, keys, blab.expand(Ib, -1), bkey.expand(Ib),
                          I, P, Ib, strict=True)


def evo_generation_step_sharded(Gs, labs, keys, gen: int, I_loc: int, P: int,
                                Ib_loc: int):
    """One generation over ``D`` island shards (the reference's
    ``evo_generation_step`` at ``D = 1``, its ``make_generation_sharded``
    above).  Shard ``d`` holds islands ``[d * I_loc, (d + 1) * I_loc)`` as
    ``(Sb_loc, Ab)`` rows on its own device with its own
    :class:`EvoGraph` ``Gs[d]``; the gossip takes the lowest key over the
    shards' bests, the lowest ``d`` winning ties (the reference's
    ``all_gather``).  Every ``D`` that divides the islands gives the same
    labels."""
    D = len(labs)
    out = [_generation_local(Gs[d], labs[d], keys[d], gen, d * I_loc, I_loc, P, Ib_loc)
           for d in range(D)]
    best = [best_row(lb, kb, I_loc * P) for lb, kb in out]
    new_labs, new_keys = [], []
    for d, (lb, kb) in enumerate(out):
        dev = lb.device
        bkeys = torch.stack([bk.to(dev) for _, bk in best])          # (D,)
        win = torch.where(bkeys == bkeys.min(),
                          torch.arange(D, device=dev), D).min()
        blabs = torch.stack([o[0][bi].to(dev) for o, (bi, _) in zip(out, best)])
        lb, kb = _gossip(lb, kb, blabs[win], bkeys[win], I_loc, P, Ib_loc)
        new_labs.append(lb)
        new_keys.append(kb)
    return new_labs, new_keys
