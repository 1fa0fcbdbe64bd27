"""Device-resident LP engine: pack caching, shape bucketing, sweep dispatch.

:class:`LPEngine` owns the device state of one ``partition()`` run (the
torch twin of ``repro.core.engine.LPEngine``):

* **Shape bucketing** — chunk geometry is frozen from the finest graph and
  every level's chunk pack is padded to shared buckets ``(C, N, E)``;
  label/weight arrays live in a power-of-two *arena* ``A >= n_finest + 1``.
  Torch runs eagerly, so the buckets no longer save compilations, but the
  padding is kept: it is what makes every move decision identical to the
  reference's.
* **Pack caching** — chunk packs, ELL packs and per-graph arena tensors are
  cached per ``(graph, order mode)`` and uploaded once; the finest graph's
  packs serve every V-cycle.  Coarse levels drop theirs after one use.
* **Device-resident refinement** — ``refine``/``refine_dense`` take and
  return arena-sized label tensors; projection, cut and block weights run
  on the device, so uncoarsening never round-trips labels through numpy.
* **Dense path** — ``refine_dense`` iterates the synchronous dense round,
  whose block scores come from the hand-written ``lp_score_rows`` kernel.
* **Device-resident coarsening** — ``contract`` builds the quotient graph on
  the device (:func:`~repro_torch.core.contraction.contract_device`); the
  coarse :class:`~repro_torch.graph.csr.GraphDev` feeds the next level's
  pack gather directly, and only four scalars cross to the host per level.

Every tensor lives on ``device`` (CUDA unless the caller asks for the
CPU).  Engine state is per run; it is not thread-safe.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..graph.csr import GraphDev, GraphNP, arc_bucket, pow2
from ..graph.packing import (
    chunk_geometry,
    ell_pack,
    gather_ell_device,
    gather_pack_device,
    layout_nodes,
    pack_chunks,
    pad_pack,
    plan_chunks,
    plan_ell_rows,
)
from ..kernels.lp_score.ops import dense_round_device
from ..obs import RegistryBackedStats
from ..obs import span as _obs_span
from .contraction import CoarseMap, contract_device, packed_key_wbits
from .label_propagation import lp_sweep, make_order
from .metrics import cut_from_arcs

__all__ = ["LPEngine", "EngineStats"]

AnyGraph = Union[GraphNP, GraphDev]


@dataclass
class _DevicePack:
    """A chunk pack padded to bucket shape, uploaded (or gathered) once."""

    graph: AnyGraph         # strong ref: pins id(graph) for cache identity
    nodes: torch.Tensor
    node_valid: torch.Tensor
    edge_dst: torch.Tensor
    edge_w: torch.Tensor
    edge_src_slot: torch.Tensor
    edge_valid: torch.Tensor
    num_chunks: int         # live chunks (<= padded C)
    shape: Tuple[int, int, int]


@dataclass
class _Arena:
    """Per-graph device tensors shared by every sweep over that graph."""

    graph: AnyGraph
    nw_arena: torch.Tensor  # (A,) f32 — node weights, 0 beyond n
    cluster_w: torch.Tensor  # (A,) f32 — per-node weights, +inf beyond n
    src: torch.Tensor       # (>= m,) int64 — arc sources (padding carries w 0)
    dst: torch.Tensor       # (>= m,) int64
    ew: torch.Tensor        # (>= m,) f32


@dataclass
class _DeviceEll:
    graph: AnyGraph
    dst: torch.Tensor       # (Rb, W) int64 — rows padded to a pow2 bucket
    w: torch.Tensor         # (Rb, W) f32
    row_node: torch.Tensor  # (Rb,) int64, sentinel n
    nb: int                 # node bucket: pow2(n + 1) <= arena size


class EngineStats(RegistryBackedStats):
    """Counters surfaced through ``PartitionReport.engine_stats``."""

    _COUNTER_FIELDS = (
        "sweep_calls",
        "pack_builds",
        "pack_hits",
        "dense_rounds",
        "contract_calls",
        "gather_builds",        # device pack gathers (GraphDev levels)
        "h2d_bytes",            # host->device uploads the engine issued
        "d2h_bytes",            # device->host downloads (scalars + lazy
                                # materializations of GraphDev/CoarseMap)
    )
    _SET_FIELDS = (
        "buckets",              # distinct (C, N, E, A, W) sweep shapes
        "contract_buckets",     # distinct (Nb, Mb, wbits)
    )

    @property
    def bucket_count(self) -> int:
        return len(self.buckets)

    @property
    def contract_bucket_count(self) -> int:
        return len(self.contract_buckets)


def _upload(a: np.ndarray, dev: torch.device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)


class LPEngine:
    """Owns packing, caching, and sweep dispatch for one multilevel run."""

    def __init__(
        self,
        g0: AnyGraph,
        *,
        target_chunks: int = 64,
        seed: int = 0,
        pack_block: int = 8,
        device=None,
    ):
        self.device = resolve_device(device)
        n0, m0 = g0.n, g0.m
        # Small packing mini-blocks keep the max block-degree-sum (which
        # forces the per-chunk edge capacity) low on coarse power-law levels.
        self.pack_block = int(pack_block)
        # Chunk geometry frozen from the finest level; the shared edge
        # bucket E_floor is learned from the first pack built (the finest,
        # hottest level) and only ever raised.
        n_req, e_req = chunk_geometry(n0, m0, target_chunks)
        self.N = pow2(n_req)
        self._e_request = e_req
        self.E_floor = 0
        self._g0_id = id(g0)
        self._g0 = g0
        # label/weight arena, floored at the GraphDev node bucket's minimum
        self.A = pow2(max(n0 + 1, 8))
        self.C_bucket = 8                   # grows to the finest pack's C
        self.seed = int(seed)
        self.stats = EngineStats()
        self._packs: Dict[Tuple[int, str], _DevicePack] = {}
        self._arenas: Dict[int, _Arena] = {}
        self._ells: Dict[int, _DeviceEll] = {}
        self._cin: Dict[int, tuple] = {}    # padded contraction inputs (GraphNP)
        self._iota_cache: Optional[torch.Tensor] = None
        self._exact_weights: Optional[bool] = None  # lazily scanned from g0

    @property
    def _iota(self) -> torch.Tensor:
        if self._iota_cache is None:
            self._iota_cache = torch.arange(self.A, dtype=torch.int64, device=self.device)
        return self._iota_cache

    # ------------------------------------------------------------------ caches

    def _arena(self, g: AnyGraph) -> _Arena:
        hit = self._arenas.get(id(g))
        if hit is not None and hit.graph is g:
            return hit
        n = g.n
        if isinstance(g, GraphDev):
            # tensors are already resident and inert beyond (n, m): extend
            # to the arena on the device
            nw_arena = torch.cat(
                [g.nw, g.nw.new_zeros(self.A - g.nw.shape[0])]
            )
            cw = torch.where(self._iota < n, nw_arena, float("inf"))
            ar = _Arena(
                graph=g, nw_arena=nw_arena, cluster_w=cw,
                src=g.src, dst=g.indices, ew=g.ew,
            )
        else:
            nw = np.zeros(self.A, np.float32)
            nw[:n] = g.nw
            cw = np.full(self.A, np.inf, np.float32)
            cw[:n] = g.nw
            ar = _Arena(
                graph=g,
                nw_arena=_upload(nw, self.device),
                cluster_w=_upload(cw, self.device),
                src=_upload(g.arc_sources(), self.device, torch.int64),
                dst=_upload(g.indices, self.device, torch.int64),
                ew=_upload(g.ew, self.device, torch.float32),
            )
            self.stats.h2d_bytes += self.A * 8 + g.m * 12
        self._arenas[id(g)] = ar
        return ar

    def _pack(self, g: AnyGraph, mode: str) -> _DevicePack:
        key = (id(g), mode)
        hit = self._packs.get(key)
        if hit is not None and hit.graph is g:
            self.stats.pack_hits += 1
            return hit
        self.stats.pack_builds += 1
        if isinstance(g, GraphDev):
            dp = self._pack_dev(g, mode)
        else:
            with _obs_span(
                "vcycle.pack", cat="vcycle", mode=mode, n=int(g.n), host=True
            ) as sp:
                dp = self._pack_host_build(g, mode)
                sp.sync_on(dp.edge_valid)
        self._packs[key] = dp
        return dp

    def _bucket_edges(self, C: int, E: int) -> int:
        """Raise the sticky chunk and edge buckets for a level's pack.  E
        snaps to 512-arc multiples, not powers of two: a pack just past the
        bucket (one hub-heavy block) would otherwise pay a ~2x sort-width
        tax on every chunk."""
        self.C_bucket = max(self.C_bucket, pow2(C))
        self.E_floor = max(self.E_floor, -(-E // 512) * 512)
        return self.E_floor

    def _pack_host_build(self, g: GraphNP, mode: str) -> _DevicePack:
        order = make_order(g, mode, self.seed)
        pack = pack_chunks(
            g, order, max_nodes=self.N,
            max_edges=max(self._e_request, self.E_floor),
            block=self.pack_block,
        )
        C = pack.nodes.shape[0]
        Eb = self._bucket_edges(C, pack.edge_dst.shape[1])
        padded = pad_pack(pack, self.C_bucket, self.N, Eb)
        dev = self.device
        dp = _DevicePack(
            graph=g,
            nodes=_upload(padded.nodes, dev, torch.int64),
            node_valid=_upload(padded.node_valid, dev),
            edge_dst=_upload(padded.edge_dst, dev, torch.int64),
            edge_w=_upload(padded.edge_w, dev),
            edge_src_slot=_upload(padded.edge_src_slot, dev, torch.int64),
            edge_valid=_upload(padded.edge_valid, dev),
            num_chunks=C,
            shape=(self.C_bucket, self.N, Eb),
        )
        self.stats.h2d_bytes += sum(
            int(t.numel() * t.element_size()) for t in
            (dp.nodes, dp.node_valid, dp.edge_dst, dp.edge_w,
             dp.edge_src_slot, dp.edge_valid)
        )
        return dp

    def _pack_dev(self, g: GraphDev, mode: str) -> _DevicePack:
        """Pack a device-resident coarse graph without materializing it:
        the O(n) chunk plan on the host, the O(m) edge fill gathered on the
        device from the resident CSR."""
        self.stats.gather_builds += 1
        order = make_order(g, mode, self.seed)
        deg = g.degrees().astype(np.int64)[order]
        node_chunk, C, N, E = plan_chunks(
            deg, g.n, max_nodes=self.N,
            max_edges=max(self._e_request, self.E_floor),
            block=self.pack_block,
        )
        Eb = self._bucket_edges(C, E)
        nodes, node_valid = layout_nodes(order, node_chunk, C, N, g.n)
        # Tight pow2 LIVE-chunk prefix: the sweep only visits the live
        # chunks, so coarse levels get their own pow2 chunk bucket instead
        # of the finest level's (dead chunks would multiply the gather).
        Cg = pow2(C)
        nodes = np.pad(nodes, ((0, Cg - C), (0, self.N - N)), constant_values=g.n)
        node_valid = np.pad(node_valid, ((0, Cg - C), (0, self.N - N)))
        nodes_d = _upload(nodes, self.device, torch.int64)
        nv_d = _upload(node_valid, self.device)
        self.stats.h2d_bytes += nodes_d.numel() * 8 + node_valid.nbytes
        with _obs_span(
            "vcycle.pack", cat="vcycle", chunks=int(C), edge_bucket=int(Eb)
        ) as sp:
            edge_dst, edge_w, edge_slot, edge_valid = gather_pack_device(
                nodes_d, nv_d, g.indptr, g.indices, g.ew, g.n, E=Eb
            )
            sp.sync_on(edge_valid)
        return _DevicePack(
            graph=g, nodes=nodes_d, node_valid=nv_d, edge_dst=edge_dst,
            edge_w=edge_w, edge_src_slot=edge_slot, edge_valid=edge_valid,
            num_chunks=C, shape=(Cg, self.N, Eb),
        )

    def _ell(self, g: AnyGraph) -> _DeviceEll:
        hit = self._ells.get(id(g))
        if hit is not None and hit.graph is g:
            self.stats.pack_hits += 1
            return hit
        self.stats.pack_builds += 1
        dev = self.device
        # Pow2 row bucket + pow2(n + 1) node bucket; padded rows are
        # sentinel-owned and weight-0, so they contribute nothing.
        with _obs_span("vcycle.pack", cat="vcycle", mode="ell", n=int(g.n)) as sp:
            if isinstance(g, GraphDev) and g.m > 0:
                # device ELL gather: O(n) row plan from the cached host
                # indptr, O(m) dst/w fill from the resident CSR
                row_node, row_first, row_end = plan_ell_rows(g._indptr_np(), g.n)
                R = row_node.shape[0]
                Rb = pow2(R)
                row_node = np.pad(row_node, (0, Rb - R), constant_values=g.n)
                row_first = np.pad(row_first, (0, Rb - R))
                row_end = np.pad(row_end, (0, Rb - R))
                rn_d = _upload(row_node, dev, torch.int64)
                self.stats.h2d_bytes += Rb * 24
                self.stats.gather_builds += 1
                dst_d, w_d = gather_ell_device(
                    _upload(row_first, dev, torch.int64),
                    _upload(row_end, dev, torch.int64),
                    g.indices, g.ew, g.n,
                )
            else:
                gh = g.to_host() if isinstance(g, GraphDev) else g
                ell = ell_pack(gh)
                R = ell.rows
                Rb = pow2(R)
                dst_d = _upload(
                    np.pad(ell.dst, ((0, Rb - R), (0, 0)), constant_values=g.n),
                    dev, torch.int64,
                )
                w_d = _upload(np.pad(ell.w, ((0, Rb - R), (0, 0))), dev)
                rn_d = _upload(
                    np.pad(ell.row_node, (0, Rb - R), constant_values=g.n),
                    dev, torch.int64,
                )
                self.stats.h2d_bytes += dst_d.numel() * 12 + Rb * 8
            sp.sync_on(dst_d)
        de = _DeviceEll(graph=g, dst=dst_d, w=w_d, row_node=rn_d, nb=pow2(g.n + 1))
        self._ells[id(g)] = de
        return de

    def _drop_single_use(self, g: AnyGraph, mode: str) -> None:
        """Release a coarse level's pack right after its one use: only the
        finest graph's packs are re-hit (coarse graphs are rebuilt every
        V-cycle).  Arenas stay until the cycle-end ``evict``."""
        if id(g) != self._g0_id:
            self._packs.pop((id(g), mode), None)

    def evict(self, keep: Tuple[AnyGraph, ...] = ()) -> None:
        """Drop cached packs/arenas/ELLs of all graphs not in ``keep``."""
        keep_ids = {id(g) for g in keep}
        self._packs = {k: v for k, v in self._packs.items() if k[0] in keep_ids}
        self._arenas = {k: v for k, v in self._arenas.items() if k in keep_ids}
        self._ells = {k: v for k, v in self._ells.items() if k in keep_ids}
        self._cin = {k: v for k, v in self._cin.items() if k in keep_ids}

    # ------------------------------------------------------------------ sweeps

    def _sweep(self, dp, labels, weights, nw_arena, restrict, U, seed, num_labels,
               *, iters, refine_mode, use_restrict, permute_chunks):
        self.stats.sweep_calls += 1
        self.stats.buckets.add(dp.shape + (labels.shape[0], weights.shape[0]))
        return lp_sweep(
            dp.nodes, dp.node_valid, dp.edge_dst, dp.edge_w, dp.edge_src_slot,
            dp.edge_valid,
            labels, weights, nw_arena, restrict,
            U, seed & 0x7FFFFFFF, num_labels, dp.num_chunks,
            iters=iters, refine_mode=refine_mode,
            use_restrict=use_restrict, permute_chunks=permute_chunks,
        )

    def cluster(
        self,
        g: AnyGraph,
        U: float,
        iters: int,
        seed: int,
        restrict: Optional[Union[np.ndarray, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """SCLaP clustering for coarsening; returns DEVICE labels (length n).
        Degree traversal order; a tensor ``restrict`` must already be
        arena-sized (``project_restrict`` output)."""
        dp = self._pack(g, "degree")
        ar = self._arena(g)
        if restrict is None:
            r_dev = torch.zeros(1, dtype=torch.int32, device=self.device)
        elif isinstance(restrict, torch.Tensor):
            r_dev = restrict
        else:
            r = np.full(self.A, -1, np.int32)
            r[: g.n] = restrict
            r_dev = _upload(r, self.device)
            self.stats.h2d_bytes += r.nbytes
        with _obs_span(
            "vcycle.sweep", cat="vcycle", mode="cluster", n=int(g.n),
            iters=int(iters),
        ) as sp:
            labels, _, _ = self._sweep(
                dp, self._iota.to(torch.int32), ar.cluster_w, ar.nw_arena, r_dev,
                U, seed, g.n,
                iters=iters, refine_mode=False,
                use_restrict=restrict is not None, permute_chunks=False,
            )
            sp.sync_on(labels)
        self._drop_single_use(g, "degree")
        return labels[: g.n]

    def refine(
        self,
        g: AnyGraph,
        labels: Union[np.ndarray, torch.Tensor],
        k: int,
        U: float,
        iters: int,
        seed: int,
    ) -> torch.Tensor:
        """Chunked-sequential SCLaP local search; arena labels in/out."""
        dp = self._pack(g, "random")
        ar = self._arena(g)
        lab = self.to_arena(labels, g.n, fill=k)
        # (k + 1)-sized block weights keep the sweep's weight updates and
        # influx gating O(k) per chunk
        w0 = torch.zeros(k + 1, dtype=torch.float32, device=self.device).index_add_(
            0, torch.clamp(lab, max=k).to(torch.int64), ar.nw_arena
        )
        w0[k] = float("inf")
        with _obs_span(
            "vcycle.sweep", cat="vcycle", mode="refine", n=int(g.n),
            iters=int(iters),
        ) as sp:
            lab_out, _, _ = self._sweep(
                dp, lab, w0, ar.nw_arena,
                torch.zeros(1, dtype=torch.int32, device=self.device), U, seed, k,
                iters=iters, refine_mode=True,
                use_restrict=False, permute_chunks=True,
            )
            sp.sync_on(lab_out)
        self._drop_single_use(g, "random")
        return lab_out

    def refine_dense(
        self,
        g: AnyGraph,
        labels: Union[np.ndarray, torch.Tensor],
        k: int,
        U: float,
        iters: int,
        seed: int,
        move_fraction: float = 0.5,
    ) -> torch.Tensor:
        """Synchronous dense refinement: ``iters`` kernel-scored rounds on a
        cached (bucket-padded) ELL pack, labels device-resident throughout."""
        de = self._ell(g)
        ar = self._arena(g)
        # bucketed node axis: arena labels/weights sliced to the pow2 node
        # bucket (slots >= n carry label k / weight 0 — inert)
        lab = self.to_arena(labels, g.n, fill=k)[: de.nb]
        nw_nb = ar.nw_arena[: de.nb]
        with _obs_span(
            "vcycle.sweep", cat="vcycle", mode="dense", n=int(g.n),
            iters=int(iters),
        ) as sp:
            for r in range(iters):
                lab = dense_round_device(
                    de.dst, de.w, de.row_node, lab, nw_nb, U,
                    (seed + 0x9E37 * r) & 0x7FFFFFFF, move_fraction, g.n, k=k,
                )
                self.stats.dense_rounds += 1
            sp.sync_on(lab)
        if id(g) != self._g0_id:
            self._ells.pop(id(g), None)
        return self.to_arena(lab, g.n, fill=k)

    def _weights_exact(self) -> bool:
        """Integral node/edge weights with f32-exact sums (scanned once from
        the finest graph; contraction only sums, so coarse levels inherit
        it) — the precondition for order-independent float scatter sums."""
        if self._exact_weights is None:
            g = self._g0
            if isinstance(g, GraphDev):
                self._exact_weights = bool(
                    (g.m == 0 or g.ew_integral)
                    and bool(torch.all(g.nw == torch.round(g.nw)))
                    and float(g.ew.sum()) < 2**24
                    and float(g.nw.sum()) < 2**24
                )
            else:
                self._exact_weights = bool(
                    (g.m == 0 or np.all(g.ew == np.round(g.ew)))
                    and np.all(g.nw == np.round(g.nw))
                    and float(g.ew.sum()) < 2**24
                    and float(g.nw.sum()) < 2**24
                )
        return self._exact_weights

    # ------------------------------------------------------------ contraction

    def _contract_inputs(self, g: AnyGraph, Nb: int, Mb: int):
        """(src, dst, ew, nw, ew_integral, ew_max) for the (Nb, Mb) bucket.
        GraphDev handles are born in their bucket and pass through; a
        GraphNP pads from the cached arena tensors once per graph."""
        if isinstance(g, GraphDev):
            return g.src, g.indices, g.ew, g.nw, g.ew_integral, g.ew_max
        hit = self._cin.get(id(g))
        if hit is not None and hit[0] is g:
            return hit[1:]
        ar = self._arena(g)
        pm = Mb - g.m
        src = torch.cat([ar.src, ar.src.new_zeros(pm)])
        dst = torch.cat([ar.dst, ar.dst.new_zeros(pm)])
        ew = torch.cat([ar.ew, ar.ew.new_zeros(pm)])
        nw = ar.nw_arena[:Nb]
        integral = bool(np.all(g.ew == np.round(g.ew))) if g.m else True
        ew_max = float(g.ew.max()) if g.m else 0.0
        self._cin[id(g)] = (g, src, dst, ew, nw, integral, ew_max)
        return src, dst, ew, nw, integral, ew_max

    def contract(
        self, g: AnyGraph, labels: Union[np.ndarray, torch.Tensor]
    ) -> Tuple[GraphDev, CoarseMap]:
        """Device-resident contraction of cluster ids in ``[0, n)``.  Returns
        the coarse :class:`GraphDev` (in its own buckets) and the
        fine->coarse :class:`CoarseMap`; only ``(n_c, m_c, max nw_c, max
        ew_c)`` are synced to the host."""
        n, m = g.n, g.m
        Nb = pow2(max(n, 8))
        Mb = arc_bucket(m)
        src, dst, ew, nw, integral, ew_max = self._contract_inputs(g, Nb, Mb)
        wbits = packed_key_wbits(Nb, Mb, ew_max, integral)
        if isinstance(labels, torch.Tensor):
            lab = labels.to(torch.int64)
        else:
            lab = _upload(np.asarray(labels[:n]), self.device, torch.int64)
            self.stats.h2d_bytes += n * 4
        if lab.shape[0] != Nb:
            lab = torch.cat([lab[:n], lab.new_zeros(Nb - n)])
        self.stats.contract_calls += 1
        self.stats.contract_buckets.add((Nb, Mb, wbits))
        with _obs_span("vcycle.contract", cat="vcycle", n=int(n), m=int(m)):
            (C, n_c, nw_c, indptr_c, src_c, dst_c, ew_c, m_c, nwmax,
             ewmax) = contract_device(src, dst, ew, nw, lab, n, m, wbits=wbits)
            # the only host sync of the level: all four scalars at once
            scal = torch.stack(
                [n_c.double(), m_c.double(), nwmax.double(), ewmax.double()]
            ).cpu().tolist()
        n_c, m_c, nwmax, ewmax = int(scal[0]), int(scal[1]), scal[2], scal[3]
        self.stats.d2h_bytes += 32
        Ncb = pow2(max(n_c, 8))
        Mcb = arc_bucket(m_c)
        coarse = GraphDev(
            indptr=indptr_c[: Ncb + 1].clone(),
            indices=dst_c[:Mcb].clone(),
            ew=ew_c[:Mcb].clone(),
            nw=nw_c[:Ncb].clone(),
            src=src_c[:Mcb].clone(),
            n=n_c, m=m_c, nw_max=nwmax,
            ew_max=ewmax, ew_integral=integral,
            on_materialize=self._note_d2h,
        )
        cmap = CoarseMap(dev=C, n_fine=n, n_coarse=n_c, on_materialize=self._note_d2h)
        return coarse, cmap

    def project_restrict(self, C: CoarseMap, restrict: torch.Tensor) -> torch.Tensor:
        """Push a V-cycle restriction one level down: ``r_c[C[v]] = r[v]``
        (consistent — clusters never straddle cells).  Returns an
        arena-sized int32 tensor, -1 beyond the coarse n."""
        Nb = C.dev.shape[0]
        idx = torch.where(self._iota[:Nb] < C.n_fine, C.dev, self.A)
        out = torch.full((self.A + 1,), -1, dtype=torch.int32, device=self.device)
        out[idx] = restrict[:Nb].to(torch.int32)     # slot A is dropped
        return out[: self.A]

    def _note_d2h(self, nbytes: int) -> None:
        self.stats.d2h_bytes += int(nbytes)

    # --------------------------------------------------------- device helpers

    def to_arena(
        self, labels: Union[np.ndarray, torch.Tensor], n: int, fill: int
    ) -> torch.Tensor:
        """Lift labels of length >= n into an (A,) int32 arena tensor."""
        if isinstance(labels, torch.Tensor):
            lab = labels.to(torch.int32)
            if lab.shape[0] == self.A:
                return lab
            return torch.cat([lab[:n], lab.new_full((self.A - n,), fill)])
        out = np.full(self.A, fill, np.int32)
        out[:n] = np.asarray(labels[:n], dtype=np.int32)
        return _upload(out, self.device)

    def project(
        self,
        coarse_labels: Union[np.ndarray, torch.Tensor],
        C: Union[np.ndarray, CoarseMap],
        fill: int,
    ) -> torch.Tensor:
        """Project coarse labels through a contraction map C (fine -> coarse)
        on the device; returns arena-sized fine labels."""
        if isinstance(coarse_labels, torch.Tensor):
            base = coarse_labels.to(torch.int32)
        else:
            base = _upload(np.asarray(coarse_labels, dtype=np.int32), self.device)
            self.stats.h2d_bytes += coarse_labels.shape[0] * 4
        if isinstance(C, CoarseMap):
            Nb = C.dev.shape[0]
            fine = torch.where(self._iota[:Nb] < C.n_fine, base[C.dev], fill)
            return torch.cat([fine, fine.new_full((self.A - Nb,), fill)])
        n_f = C.shape[0]
        fine = base[_upload(C, self.device, torch.int64)]
        self.stats.h2d_bytes += n_f * 4
        return torch.cat([fine, fine.new_full((self.A - n_f,), fill)])

    def cut(self, g: AnyGraph, labels: torch.Tensor) -> float:
        """Edge cut of arena labels, evaluated on the device (one sync)."""
        ar = self._arena(g)
        return float(cut_from_arcs(labels, ar.src, ar.dst, ar.ew))

    def block_weights(self, g: AnyGraph, labels: torch.Tensor, k: int) -> np.ndarray:
        ar = self._arena(g)
        bw = torch.zeros(k + 1, dtype=torch.float32, device=self.device).index_add_(
            0, torch.clamp(labels, max=k).to(torch.int64), ar.nw_arena
        )
        return bw[:k].cpu().numpy()

    def to_host(self, labels: torch.Tensor, n: int) -> np.ndarray:
        return labels[:n].cpu().numpy()

    # ---------------------------------------------------------------- metrics

    def stats_dict(self) -> dict:
        return dict(
            sweep_calls=self.stats.sweep_calls,
            bucket_count=self.stats.bucket_count,
            pack_builds=self.stats.pack_builds,
            pack_hits=self.stats.pack_hits,
            dense_rounds=self.stats.dense_rounds,
            contract_calls=self.stats.contract_calls,
            contract_bucket_count=self.stats.contract_bucket_count,
            gather_builds=self.stats.gather_builds,
            h2d_bytes=self.stats.h2d_bytes,
            d2h_bytes=self.stats.d2h_bytes,
            arena=self.A,
            chunk_bucket=(self.C_bucket, self.N, self.E_floor),
        )
