"""Device-resident LP engine: pack caching, shape bucketing, sweep dispatch.

:class:`LPEngine` owns the device state of one ``partition()`` run (the
torch twin of ``repro.core.engine.LPEngine``):

* **Shape bucketing** — chunk geometry is frozen from the finest graph and
  every level's chunk pack is padded to shared buckets ``(C, N, E)``;
  label/weight arrays live in a power-of-two *arena* ``A >= n_finest + 1``.
  Torch runs eagerly, so the buckets no longer save compilations, but the
  padding is kept: it is what makes every move decision identical to the
  reference's.
* **One device form** — every graph the engine sees is a
  :class:`~repro_torch.graph.csr.GraphDev`: a caller's ``GraphNP`` is
  lifted once by ``to_device_csr`` (born in its contraction bucket, its
  host arrays kept as the handle's mirror) and cached until ``evict``.
* **Pack caching** — chunk packs, ELL packs and per-graph arena tensors are
  cached per ``(graph, order mode)`` and built once; the finest graph's
  packs serve every V-cycle.  Coarse levels drop theirs after one use.
* **Device pack gathers** — every pack, the finest graph's included, is
  planned in O(n) on the host and its O(m) edge arrays gathered on the
  device from the graph's resident CSR, its only O(m) upload.
* **Device-resident refinement** — ``refine``/``refine_dense`` take and
  return arena-sized label tensors; projection, cut and block weights run
  on the device, so uncoarsening never round-trips labels through numpy.
* **Dense path** — ``refine_dense`` iterates the synchronous dense round,
  whose block scores come from the hand-written ``lp_score_rows`` kernel.
* **Device-resident coarsening** — ``contract`` builds the quotient graph on
  the device (:func:`~repro_torch.core.contraction.contract_device`); the
  coarse :class:`~repro_torch.graph.csr.GraphDev` feeds the next level's
  pack gather directly, and only four scalars cross to the host per level.
* **Batched evolution** — ``evolve_device`` runs the island GA of
  :mod:`~repro_torch.core.evo_device` on the coarsest graph's cached pack
  and arc tensors (a resident GraphDev is never materialized), gated by
  ``can_evolve_device``, its islands optionally split into shards over a
  device list; ``evolve_oracle`` runs its numpy oracle on the same inputs.
* **Device finish** — ``repair_balance`` runs the V-cycle's final balance
  repair against the finest graph's resident arena (a torch-ops prelude,
  then the hand-written ``repair_balance_walk`` kernel), gated by
  ``can_finish_device``.
* **Incremental repair** — ``repair`` (the dynamic subsystem's hot path)
  stages one lane (``repair_lane``) for
  :func:`repro_torch.dynamic.repair.repair_lanes`, the region repair a
  ``SessionGroup`` runs over many lanes.

Every tensor lives on ``device`` (CUDA unless the caller asks for the
CPU).  Engine state is per run; it is not thread-safe.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..graph.csr import GraphDev, GraphNP, arc_bucket, pow2, to_device_csr
from ..graph.packing import (
    chunk_geometry,
    gather_ell_device,
    gather_pack_device,
    layout_nodes,
    plan_chunks,
    plan_ell_rows,
)
from ..kernels.balance import repair_balance_device
from ..kernels.lp_score.ops import dense_round_device
from ..launch.mesh import pe_devices
from ..obs import MetricsRegistry, RegistryBackedStats
from ..obs import span as _obs_span
from ..obs.memory import account as _mem_account
from ..obs.watchdog import note_new
from .contraction import CoarseMap, contract_device, packed_key_wbits
from .evo_device import (
    EvoGraph,
    best_row,
    evo_generation_step_sharded,
    evo_seed_step,
)
from .evolutionary import EvoInputs, evolve_batched_numpy, grow_rounds_bound
from .label_propagation import lp_sweep, make_order
from .metrics import cut_from_arcs

__all__ = ["LPEngine", "EngineStats"]

AnyGraph = Union[GraphNP, GraphDev]


@dataclass
class _DevicePack:
    """A chunk pack padded to bucket shape, gathered once."""

    graph: GraphDev         # strong ref: pins id(graph) for cache identity
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

    graph: GraphDev
    nw_arena: torch.Tensor  # (A,) f32 — node weights, 0 beyond n
    cluster_w: torch.Tensor  # (A,) f32 — per-node weights, +inf beyond n


@dataclass
class _DeviceEll:
    graph: GraphDev
    dst: torch.Tensor       # (Rb, W) int64 — rows padded to a pow2 bucket
    w: torch.Tensor         # (Rb, W) f32
    row_node: torch.Tensor  # (Rb,) int64, sentinel n
    nb: int                 # node bucket: pow2(n + 1) <= arena size


class EngineStats(RegistryBackedStats):
    """Counters surfaced through ``PartitionReport.engine_stats`` (and,
    through the session's registry, ``PartitionSession.stats()``)."""

    _COUNTER_FIELDS = (
        "sweep_calls",
        "pack_builds",
        "pack_hits",
        "dense_rounds",
        "contract_calls",
        "evo_calls",            # batched GA steps (seed + generations)
        "gather_builds",        # device pack gathers (every pack build)
        "repair_calls",         # incremental repairs (dynamic subsystem)
        "audit_calls",          # invariant-audit dispatches (resilience)
        "h2d_bytes",            # host->device uploads the engine issued
        "d2h_bytes",            # device->host downloads (scalars + lazy
                                # materializations of GraphDev/CoarseMap)
        "finish_device",        # V-cycle finishes repaired and cut on the device
        "finish_moved",         # nodes the finish's balance repair moved
    )
    _SET_FIELDS = (
        "buckets",              # distinct (C, N, E, A, W) sweep shapes
        "contract_buckets",     # distinct (Nb, Mb, wbits)
        "evo_buckets",          # distinct GA step shapes (the reference's keys)
        "repair_buckets",       # distinct repair shapes (the reference's keys)
        "audit_buckets",        # distinct audit shapes (the reference's keys)
    )

    @property
    def bucket_count(self) -> int:
        return len(self.buckets)

    @property
    def contract_bucket_count(self) -> int:
        return len(self.contract_buckets)

    @property
    def evo_bucket_count(self) -> int:
        return len(self.evo_buckets)

    @property
    def repair_bucket_count(self) -> int:
        return len(self.repair_buckets)

    @property
    def audit_bucket_count(self) -> int:
        return len(self.audit_buckets)

    def note_audit_key(self, key) -> None:
        """Record one audit dispatch shape (the resilience auditor's)."""
        note_new(self.audit_buckets, "engine.audit", key)


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
        registry: Optional[MetricsRegistry] = None,
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
        self.stats = EngineStats(registry)
        self._packs: Dict[Tuple[int, str], _DevicePack] = {}
        self._arenas: Dict[int, _Arena] = {}
        self._ells: Dict[int, _DeviceEll] = {}
        self._degs: Dict[int, tuple] = {}   # (graph, (Ab,) f32 degrees) for the GA
        # id(host graph) -> (host graph, its device form): the caller's GraphNPs
        self._lifts: Dict[int, Tuple[GraphNP, GraphDev]] = {}
        self._repair_E = 0                  # sticky region-pack edge bucket
        self._iota_cache: Optional[torch.Tensor] = None
        # shape keys noted to the watchdog (the reference's compile keys)
        self._sweep_keys = set()
        self._gather_keys = set()
        self._dense_keys = set()
        self._exact_weights: Optional[bool] = None  # lazily scanned from g0

    @property
    def _iota(self) -> torch.Tensor:
        if self._iota_cache is None:
            self._iota_cache = torch.arange(self.A, dtype=torch.int64, device=self.device)
            _mem_account("label_arenas", self._iota_cache)
        return self._iota_cache

    @staticmethod
    def will_fit(n: int, m: int, k: int, cfg=None, *, budget_bytes=None,
                 workload: str = "partition", safety: float = 1.25,
                 device=None) -> dict:
        """Pre-upload capacity check: closed-form footprint of partitioning
        (or serving) an (n, m, k) graph against the memory of ``device``
        (CUDA unless named) — call before uploading anything (see
        :func:`repro_torch.obs.memory.will_fit`)."""
        from ..obs.memory import will_fit as _wf

        return _wf(n, m, k, cfg, budget_bytes=budget_bytes,
                   workload=workload, safety=safety, device=device)

    # ------------------------------------------------------------------ caches

    def _dev(self, g: AnyGraph) -> GraphDev:
        """The one device form of a graph: a GraphDev passes through; a
        GraphNP is uploaded once by :func:`to_device_csr` (which keeps it as
        the handle's host mirror, so it never downloads) and cached, its
        strong reference pinning the id, until :meth:`evict`."""
        if isinstance(g, GraphDev):
            return g
        hit = self._lifts.get(id(g))
        if hit is None:
            gd = to_device_csr(g, self.device)
            self.stats.h2d_bytes += sum(
                t.numel() * t.element_size()
                for t in (gd.indptr, gd.indices, gd.ew, gd.nw, gd.src))
            if g is self._g0:
                self._g0_id = id(gd)
            hit = self._lifts[id(g)] = (g, gd)
        return hit[1]

    def _host_form(self, g: GraphDev) -> bool:
        """Whether the caller handed ``g`` in host form: such a graph packs
        into the shared chunk bucket, and the reference names its exact
        shapes (not its buckets) where it notes gather and repair keys."""
        return any(gd is g for _, gd in self._lifts.values())

    def _arena(self, g: AnyGraph) -> _Arena:
        g = self._dev(g)
        hit = self._arenas.get(id(g))
        if hit is not None and hit.graph is g:
            return hit
        # node weights are already resident and 0 beyond n: extend to the
        # arena on the device
        nw_arena = torch.cat([g.nw, g.nw.new_zeros(self.A - g.nw.shape[0])])
        cw = torch.where(self._iota < g.n, nw_arena, float("inf"))
        ar = _Arena(graph=g, nw_arena=nw_arena, cluster_w=cw)
        _mem_account("label_arenas", ar.nw_arena, ar.cluster_w)
        self._arenas[id(g)] = ar
        return ar

    def _pack(self, g: AnyGraph, mode: str) -> _DevicePack:
        g = self._dev(g)
        key = (id(g), mode)
        hit = self._packs.get(key)
        if hit is not None and hit.graph is g:
            self.stats.pack_hits += 1
            return hit
        self.stats.pack_builds += 1
        dp = self._pack_gather(g, mode)
        _mem_account("chunk_packs", dp.nodes, dp.node_valid, dp.edge_dst,
                     dp.edge_w, dp.edge_src_slot, dp.edge_valid)
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

    def _pack_gather(self, g: GraphDev, mode: str) -> _DevicePack:
        """Pack a graph without building its edge arrays on the host: the
        O(n) chunk plan on the host, the O(m) edge fill gathered on the
        device from the resident CSR."""
        self.stats.gather_builds += 1
        host_form = self._host_form(g)
        with _obs_span("pack.plan", cat="pack", n=int(g.n)):
            order = make_order(g, mode, self.seed)
            deg = g.degrees().astype(np.int64)[order]
            node_chunk, C, N, E = plan_chunks(
                deg, g.n, max_nodes=self.N,
                max_edges=max(self._e_request, self.E_floor),
                block=self.pack_block,
            )
            Eb = self._bucket_edges(C, E)
            nodes, node_valid = layout_nodes(order, node_chunk, C, N, g.n)
            # Coarse levels take a tight pow2 LIVE-chunk prefix: the sweep
            # only visits the live chunks, so the finest level's dead chunks
            # would multiply their gather.  The finest graph (a caller's host
            # graph) keeps the shared chunk bucket.
            Cb = self.C_bucket if host_form else pow2(C)
            nodes = np.pad(nodes, ((0, Cb - C), (0, self.N - N)), constant_values=g.n)
            node_valid = np.pad(node_valid, ((0, Cb - C), (0, self.N - N)))
        with _obs_span("pack.upload", cat="pack"):
            nodes_d = _upload(nodes, self.device, torch.int64)
            nv_d = _upload(node_valid, self.device)
        self.stats.h2d_bytes += nodes_d.numel() * 8 + node_valid.nbytes
        if not host_form:     # the reference gathers device levels only
            note_new(self._gather_keys, "engine.gather",
                     (nodes.shape, g.indptr.shape[0], g.indices.shape[0], Eb))
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
            num_chunks=C, shape=(Cb, self.N, Eb),
        )

    def _ell(self, g: AnyGraph) -> _DeviceEll:
        g = self._dev(g)
        hit = self._ells.get(id(g))
        if hit is not None and hit.graph is g:
            self.stats.pack_hits += 1
            return hit
        self.stats.pack_builds += 1
        self.stats.gather_builds += 1
        dev = self.device
        # Pow2 row bucket + pow2(n + 1) node bucket; padded rows are
        # sentinel-owned and weight-0, so they contribute nothing.
        with _obs_span("vcycle.pack", cat="vcycle", mode="ell", n=int(g.n)) as sp:
            # O(n) row plan from the host row pointers, O(m) dst/w fill
            # gathered from the resident CSR
            with _obs_span("pack.plan", cat="pack", n=int(g.n)):
                row_node, row_first, row_end = plan_ell_rows(g._indptr_np(), g.n)
                R = row_node.shape[0]
                Rb = pow2(R)
                row_node = np.pad(row_node, (0, Rb - R), constant_values=g.n)
                row_first = np.pad(row_first, (0, Rb - R))
                row_end = np.pad(row_end, (0, Rb - R))
            with _obs_span("pack.upload", cat="pack"):
                rn_d = _upload(row_node, dev, torch.int64)
                first_d = _upload(row_first, dev, torch.int64)
                end_d = _upload(row_end, dev, torch.int64)
            self.stats.h2d_bytes += Rb * 24
            if not self._host_form(g) and g.m > 0:  # the reference's gather keys
                note_new(self._gather_keys, "engine.gather",
                         ("ell", Rb, g.indices.shape[0]))
            dst_d, w_d = gather_ell_device(first_d, end_d, g.indices, g.ew, g.n)
            sp.sync_on(dst_d)
        de = _DeviceEll(graph=g, dst=dst_d, w=w_d, row_node=rn_d, nb=pow2(g.n + 1))
        _mem_account("chunk_packs", de.dst, de.w, de.row_node)
        self._ells[id(g)] = de
        return de

    def _drop_single_use(self, g: GraphDev, mode: str) -> None:
        """Release a coarse level's pack right after its one use: only the
        finest graph's packs are re-hit (coarse graphs are rebuilt every
        V-cycle).  Arenas stay until the cycle-end ``evict``."""
        if id(g) != self._g0_id:
            self._packs.pop((id(g), mode), None)

    def evict(self, keep: Tuple[AnyGraph, ...] = ()) -> None:
        """Drop cached lifts/packs/arenas/ELLs of all graphs not in ``keep``."""
        held = {id(g) for g in keep}
        self._lifts = {k: v for k, v in self._lifts.items() if k in held}
        keep_ids = held | {id(gd) for _, gd in self._lifts.values()}
        self._packs = {k: v for k, v in self._packs.items() if k[0] in keep_ids}
        self._arenas = {k: v for k, v in self._arenas.items() if k in keep_ids}
        self._ells = {k: v for k, v in self._ells.items() if k in keep_ids}
        self._degs = {k: v for k, v in self._degs.items() if k in keep_ids}

    def carry_from(self, old: "LPEngine") -> None:
        """Adopt a predecessor engine's stats object, watchdog key sets and
        sticky repair edge bucket (the dynamic session's node-growth
        rebuild), so counters and bucket sets stay cumulative across the
        swap."""
        self.stats = old.stats
        self._sweep_keys = old._sweep_keys
        self._gather_keys = old._gather_keys
        self._dense_keys = old._dense_keys
        self._repair_E = max(self._repair_E, old._repair_E)

    # ------------------------------------------------------------------ sweeps

    def _count_sweep(self, bucket: tuple, *statics) -> None:
        """Count one sweep and note its (bucket, statics) key."""
        self.stats.sweep_calls += 1
        self.stats.buckets.add(bucket)
        note_new(self._sweep_keys, "engine.sweep", bucket + statics)

    def _sweep(self, dp, labels, weights, nw_arena, restrict, U, seed, num_labels,
               *, iters, refine_mode, use_restrict, permute_chunks):
        self._count_sweep(dp.shape + (labels.shape[0], weights.shape[0]),
                          restrict.shape[0], iters, refine_mode, use_restrict,
                          permute_chunks)
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
        g = self._dev(g)
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
        g = self._dev(g)
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
        g = self._dev(g)
        de = self._ell(g)
        ar = self._arena(g)
        # bucketed node axis: arena labels/weights sliced to the pow2 node
        # bucket (slots >= n carry label k / weight 0 — inert)
        lab = self.to_arena(labels, g.n, fill=k)[: de.nb]
        nw_nb = ar.nw_arena[: de.nb]
        note_new(self._dense_keys, "engine.dense", (tuple(de.dst.shape), de.nb, k))
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
        it) — the precondition for order-independent float scatter sums.
        The sums are float64, so the decision takes no reduction order."""
        if self._exact_weights is None:
            g = self._dev(self._g0)
            self._exact_weights = bool(
                (g.m == 0 or g.ew_integral)
                and bool(torch.all(g.nw == torch.round(g.nw)))
                and float(g.ew.sum(dtype=torch.float64)) < 2**24
                and float(g.nw.sum(dtype=torch.float64)) < 2**24
            )
        return self._exact_weights

    # ---------------------------------------------------------------- finish

    def can_finish_device(self) -> bool:
        """Whether :meth:`repair_balance` gives the host repair's labels:
        exact weights (its per-node internal connections are float32
        sums)."""
        return self._weights_exact()

    def repair_balance(self, g: AnyGraph, labels: Union[np.ndarray, torch.Tensor],
                       k: int, L: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """The V-cycle's final balance repair on the device, against ``g``'s
        resident arena: :func:`~repro_torch.core.initial_partition.
        repair_balance`'s labels (under :meth:`can_finish_device`), as new
        arena labels, and the number of nodes moved as a device scalar."""
        g = self._dev(g)
        ar = self._arena(g)
        lab = self.to_arena(labels, g.n, fill=k)
        self.stats.finish_device += 1
        return repair_balance_device(lab, g.src, g.indices, g.ew, ar.nw_arena,
                                     g.n, k, L)

    # ---------------------------------------------------------------- repair

    def _note_repair(self, stage: str, T: int, *dims) -> None:
        """:func:`~repro_torch.dynamic.repair.repair_lanes`' note hook: each
        program's shape (a group's flat dims) under the reference's
        ``engine.repair`` keys; the region sweep also counts as a sweep."""
        if stage == "score":        # the solo guard is no program of its own
            return
        if stage == "gather":
            dims = (dims[:2],) + dims[2:]
        elif stage == "sweep":
            dims = (dims[:3],) + dims[3:]
        note_new(self.stats.repair_buckets, "engine.repair",
                 ("frontier" if stage == "expand" else stage,) + dims)
        if stage == "sweep":
            self._count_sweep(dims[0] + dims[1:3], 1, dims[3], True, False, True)

    def repair_lane(self, g: AnyGraph, labels: Union[np.ndarray, torch.Tensor],
                    touched: np.ndarray, k: int, U: float, seed: int,
                    hop_degree_cap: Optional[int],
                    adjacency: Optional[Tuple[torch.Tensor, ...]]):
        """Stage one region repair of ``g`` as a
        :class:`~repro_torch.dynamic.repair.RepairLane`: its arena labels
        and node weights, its resident arcs (or ``adjacency``'s), the
        touched ids in ``[0, n)`` and the hop degree cap (``None`` or <= 0
        disables it).  See :meth:`repair` for the arguments."""
        from ..dynamic.repair import RepairLane   # dynamic builds on core

        g = self._dev(g)
        ar = self._arena(g)
        n, m = g.n, g.m
        if adjacency is not None:
            ip, src, dst, ew = adjacency[:4]
        elif self._host_form(g):
            # the reference repairs a host graph on its exact (n + 1, m)
            # arrays, and its shape keys name them: views, inert to cut
            ip, src, dst, ew = g.indptr[: n + 1], g.src[:m], g.indices[:m], g.ew[:m]
        else:
            ip, src, dst, ew = g.indptr, g.src, g.indices, g.ew
        t_ids = np.unique(np.asarray(touched, dtype=np.int64))
        return RepairLane(
            labels=self.to_arena(labels, n, fill=k), nw=ar.nw_arena,
            indptr=ip, src=src, dst=dst, ew=ew, n=n, U=U, seed=seed,
            cap=(0x7FFFFFFF if hop_degree_cap is None or hop_degree_cap <= 0
                 else int(hop_degree_cap)),
            touched=t_ids[(t_ids >= 0) & (t_ids < n)],
            pack=(self.N, self._e_request, self.pack_block),
        )

    def repair(
        self,
        g: AnyGraph,
        labels: Union[np.ndarray, torch.Tensor],
        touched: np.ndarray,
        k: int,
        U: float,
        *,
        hops: int = 2,
        iters: int = 6,
        gain_rounds: int = 2,
        balance_rounds: int = 3,
        seed: int = 0,
        hop_degree_cap: Optional[int] = None,
        adjacency: Optional[Tuple[torch.Tensor, ...]] = None,
    ) -> Tuple[torch.Tensor, int, float, np.ndarray]:
        """Incremental size-constrained repair after a graph mutation: the
        one-lane case of :func:`~repro_torch.dynamic.repair.repair_lanes`
        (region expansion, region pack, sweep, gain and balance rounds, the
        cut/feasibility guard) on ``g``'s resident arrays.

        ``hop_degree_cap``: hops past the first only expand through nodes of
        degree <= cap (``None`` or <= 0 disables it).  ``adjacency``
        substitutes device ``(indptr, src, dst, ew)`` tensors — a store
        view of base CSR + uncompacted overlay — for ``g``'s own arcs in
        every arc consumer; ``g`` still gives the node set, node weights and
        cache identity.  Every consumer is insensitive to within-row arc
        order and inert padding, so repairing on a view equals compacting
        first.

        Returns ``(arena labels, region size, cut, block weights)`` for the
        labels it returns; labels outside the region are those of the
        input, and a rejected repair returns the input tensor itself.  The
        region always holds the touched ids, so only an update that touches
        no node skips the repair.
        """
        from ..dynamic.repair import repair_lanes   # dynamic builds on core

        self.stats.repair_calls += 1
        lane = self.repair_lane(g, labels, touched, k, U, seed, hop_degree_cap,
                                adjacency)
        if lane.touched.size == 0:
            cut = float(cut_from_arcs(lane.labels, lane.src, lane.dst, lane.ew))
            return lane.labels, 0, cut, self.block_weights(g, lane.labels, k)
        rep = repair_lanes([lane], k, hops=hops, iters=iters,
                           gain_rounds=gain_rounds, balance_rounds=balance_rounds,
                           E=self._repair_E, note=self._note_repair)
        self._repair_E = rep.E                    # sticky, like E_floor
        self.stats.h2d_bytes += rep.h2d
        self.stats.d2h_bytes += rep.d2h
        return rep.labels[0], rep.sizes[0], rep.cuts[0], rep.bws[0]

    # ---------------------------------------------------------- evolutionary

    def _deg_f(self, g: GraphDev, Ab: int) -> torch.Tensor:
        """(Ab,) float32 degrees (0 beyond n), uploaded once per graph."""
        hit = self._degs.get(id(g))
        if hit is not None and hit[0] is g and hit[1].shape[0] == Ab:
            return hit[1]
        deg = np.zeros(Ab, np.float32)
        deg[: g.n] = g.degrees()
        t = _upload(deg, self.device)
        self.stats.h2d_bytes += deg.nbytes
        _mem_account("evo_population", t)
        self._degs[id(g)] = (g, t)
        return t

    def can_evolve_device(self, g: AnyGraph, k: int, islands: int, pop: int) -> bool:
        """The reference's gate for the batched GA: exact weights, overlay
        keys that fit int32, and (Sb, Ab, Kb) score tensors of at most
        2^28 bytes."""
        n = g.n
        if n < 1 or k < 1 or k * (k + 1) >= 2**31:
            return False
        if pow2(max(islands * pop, 1)) * pow2(n + 1) * pow2(k + 1) * 4 > 2**28:
            return False
        return self._weights_exact()

    def _evo_arrays(self, g: AnyGraph):
        """(pack, arena, Ab) of one evolution run: the cached "random" pack
        (shared with refine sweeps), so the graph uploads once per run."""
        g = self._dev(g)
        return self._pack(g, "random"), self._arena(g), pow2(g.n + 1)

    def evolve_device(self, g: AnyGraph, cfg, shard: bool = False,
                      devices=None) -> torch.Tensor:
        """Batched island GA; returns the best partition of ``g`` as an (n,)
        int32 tensor on the engine's device, bit-identical to
        :meth:`evolve_oracle` under the same config on integral weights.

        ``shard=True`` splits the islands over the mesh ``devices``
        (:func:`~repro_torch.launch.pe_devices`: every CUDA device unless
        given), one shard per entry, when there are generations, more than
        one entry and ``islands % D == 0`` (the reference's rule); else the
        one shard is the whole batch on the engine's device.  The result
        is the same either way."""
        g = self._dev(g)
        n, k = g.n, cfg.k
        I, P, G = cfg.islands, cfg.pop_per_island, cfg.generations
        Kb, Sb = pow2(k + 1), pow2(I * P)
        dp, ar, Ab = self._evo_arrays(g)
        EG = EvoGraph(
            pack=(dp.nodes, dp.node_valid, dp.edge_dst, dp.edge_w,
                  dp.edge_src_slot, dp.edge_valid),
            num_chunks=dp.num_chunks, src=g.src, dst=g.indices, ew=g.ew,
            nw=ar.nw_arena[:Ab], deg_f=self._deg_f(g, Ab), n=n, k=k, Kb=Kb,
            Lmax=float(np.float32(cfg.Lmax)), seed=int(cfg.seed) & 0x7FFFFFFF,
            refine_iters=cfg.refine_iters,
        )
        seed_lab = np.full((Sb, Ab), k, np.int32)
        seed_mask = np.zeros(Sb, bool)
        if cfg.seed_individuals:
            for isl in range(I):
                seed_lab[isl * P, :n] = np.asarray(
                    cfg.seed_individuals[isl % len(cfg.seed_individuals)][:n],
                    dtype=np.int32,
                )
                seed_mask[isl * P] = True
        self.stats.h2d_bytes += seed_lab.nbytes + seed_mask.nbytes
        self.stats.evo_calls += 1
        note_new(self.stats.evo_buckets, "engine.evo",
                 ("evo_seed", dp.shape, Sb, Ab, Kb, cfg.refine_iters))
        labs, keys = evo_seed_step(
            EG, _upload(seed_lab, self.device, torch.int64),
            _upload(seed_mask, self.device), I, P, grow_rounds_bound(n, k, g.m),
        )
        _mem_account("evo_population", labs, keys)
        mesh = pe_devices(devices) if shard and G > 0 else ()
        if len(mesh) < 2 or I % len(mesh):
            mesh = (self.device,)
        labs, keys = self._generations(EG, cfg, labs, keys, mesh)
        bidx, _ = best_row(labs, keys, I * P)
        return labs[bidx][:n].to(torch.int32)

    def _generations(self, EG: EvoGraph, cfg, labs, keys, mesh):
        """The generation loop over ``D = len(mesh)`` island shards: shard
        ``d`` takes islands ``[d * I_loc, (d + 1) * I_loc)`` as
        ``(pow2(I_loc * P), Ab)`` rows on ``mesh[d]`` (padding rows: label
        k, key 2^31 - 1), and the result is flattened back to the
        unsharded ``(Sb, Ab)`` layout for the best-row selection.  With
        ``D = 1`` that layout is the shard's own, so nothing is copied."""
        I, P, G = cfg.islands, cfg.pop_per_island, cfg.generations
        D = len(mesh)
        I_loc = I // D
        S_loc, Sb_loc, Ib_loc = I_loc * P, pow2(I_loc * P), pow2(I_loc)
        Sb, Ab = labs.shape
        Gs = [EG.to(dev) for dev in mesh]   # no copy on the engine's device
        # the reference's keys: its unsharded and shard_map steps differ
        pshape = (*EG.pack[0].shape, EG.pack[2].shape[1])
        gkey = (("evo_gen", pshape, Sb, Ab, Ib_loc, EG.Kb, cfg.refine_iters)
                if D == 1 else
                ("evo_gen_sharded", pshape, D, Sb_loc, Ab, Ib_loc, EG.Kb,
                 cfg.refine_iters))
        if D == 1:
            lab_sh, key_sh = [labs], [keys]
        else:
            lab_sh, key_sh = [], []
            for d, dev in enumerate(mesh):
                rows = slice(d * S_loc, (d + 1) * S_loc)
                lb = torch.full((Sb_loc, Ab), EG.k, dtype=labs.dtype, device=dev)
                kb = torch.full((Sb_loc,), 2**31 - 1, dtype=keys.dtype, device=dev)
                lb[:S_loc] = labs[rows].to(dev)
                kb[:S_loc] = keys[rows].to(dev)
                lab_sh.append(lb)
                key_sh.append(kb)
            _mem_account("evo_population", *lab_sh, *key_sh)
        for gen in range(G):
            self.stats.evo_calls += 1
            note_new(self.stats.evo_buckets, "engine.evo", gkey)
            lab_sh, key_sh = evo_generation_step_sharded(
                Gs, lab_sh, key_sh, gen, I_loc, P, Ib_loc)
            _mem_account("evo_population", *lab_sh, *key_sh)
        if D == 1:
            return lab_sh[0], key_sh[0]
        lab_out = torch.full((Sb, Ab), EG.k, dtype=labs.dtype, device=self.device)
        key_out = torch.full((Sb,), 2**31 - 1, dtype=keys.dtype, device=self.device)
        for d in range(D):
            lab_out[d * S_loc:(d + 1) * S_loc] = lab_sh[d][:S_loc].to(self.device)
            key_out[d * S_loc:(d + 1) * S_loc] = key_sh[d][:S_loc].to(self.device)
        return lab_out, key_out

    def evolve_oracle(self, g: AnyGraph, cfg, trace=None) -> np.ndarray:
        """The sequential numpy oracle on the same pack and arc tensors the
        batched GA reads (the parity reference)."""
        g = self._dev(g)
        dp, ar, Ab = self._evo_arrays(g)
        deg = np.zeros(Ab, np.int32)
        deg[: g.n] = g.degrees()

        def host(t):
            return t.cpu().numpy()

        inp = EvoInputs(
            nodes=host(dp.nodes), node_valid=host(dp.node_valid),
            edge_dst=host(dp.edge_dst), edge_w=host(dp.edge_w),
            edge_src_slot=host(dp.edge_src_slot), edge_valid=host(dp.edge_valid),
            num_chunks=dp.num_chunks,
            src=host(g.src), dst=host(g.indices), ew=host(g.ew),
            nw=host(ar.nw_arena[:Ab]), deg=deg, n=g.n,
        )
        return evolve_batched_numpy(inp, cfg, trace=trace)

    # ------------------------------------------------------------ contraction

    def contract(
        self, g: AnyGraph, labels: Union[np.ndarray, torch.Tensor]
    ) -> Tuple[GraphDev, CoarseMap]:
        """Device-resident contraction of cluster ids in ``[0, n)``.  Returns
        the coarse :class:`GraphDev` (in its own buckets) and the
        fine->coarse :class:`CoarseMap`; only ``(n_c, m_c, max nw_c, max
        ew_c)`` are synced to the host.  The graph's device form is born in
        its ``(Nb, Mb)`` bucket, so its arrays are the program's inputs."""
        g = self._dev(g)
        n, m = g.n, g.m
        Nb = pow2(max(n, 8))
        Mb = arc_bucket(m)
        integral = g.ew_integral
        wbits = packed_key_wbits(Nb, Mb, g.ew_max, integral)
        if isinstance(labels, torch.Tensor):
            lab = labels.to(torch.int64)
        else:
            lab = _upload(np.asarray(labels[:n]), self.device, torch.int64)
            self.stats.h2d_bytes += n * 4
        if lab.shape[0] != Nb:
            lab = torch.cat([lab[:n], lab.new_zeros(Nb - n)])
        self.stats.contract_calls += 1
        note_new(self.stats.contract_buckets, "engine.contract", (Nb, Mb, wbits))
        with _obs_span("vcycle.contract", cat="vcycle", n=int(n), m=int(m)):
            (C, n_c, nw_c, indptr_c, src_c, dst_c, ew_c, m_c, nwmax,
             ewmax) = contract_device(g.src, g.indices, g.ew, g.nw, lab, n, m,
                                      wbits=wbits)
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
        _mem_account("base_csr", C)
        return coarse, cmap

    def project_restrict(self, C: CoarseMap, restrict: torch.Tensor) -> torch.Tensor:
        """Push a V-cycle restriction one level down: ``r_c[C[v]] = r[v]``
        (consistent — clusters never straddle cells).  Returns an
        arena-sized int32 tensor, -1 beyond the coarse n."""
        Nb = C.dev.shape[0]
        idx = torch.where(self._iota[:Nb] < C.n_fine, C.dev, self.A)
        out = torch.full((self.A + 1,), -1, dtype=torch.int32, device=self.device)
        out[idx] = restrict[:Nb].to(torch.int32)     # slot A is dropped
        _mem_account("label_arenas", out)
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
            lab = torch.cat([lab[:n], lab.new_full((self.A - n,), fill)])
        else:
            out = np.full(self.A, fill, np.int32)
            out[:n] = np.asarray(labels[:n], dtype=np.int32)
            lab = _upload(out, self.device)
        _mem_account("label_arenas", lab)
        return lab

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
            out = torch.cat([fine, fine.new_full((self.A - Nb,), fill)])
        else:
            n_f = C.shape[0]
            fine = base[_upload(C, self.device, torch.int64)]
            self.stats.h2d_bytes += n_f * 4
            out = torch.cat([fine, fine.new_full((self.A - n_f,), fill)])
        _mem_account("label_arenas", out)
        return out

    def cut(self, g: AnyGraph, labels: torch.Tensor) -> float:
        """Edge cut of arena labels, evaluated on the device (one sync)."""
        g = self._dev(g)
        return float(cut_from_arcs(labels, g.src, g.indices, g.ew))

    def block_weights(self, g: AnyGraph, labels: torch.Tensor, k: int) -> np.ndarray:
        ar = self._arena(g)
        bw = torch.zeros(k + 1, dtype=torch.float32, device=self.device).index_add_(
            0, torch.clamp(labels, max=k).to(torch.int64), ar.nw_arena
        )
        return bw[:k].cpu().numpy()

    def to_host(self, labels: torch.Tensor, n: int) -> np.ndarray:
        return labels[:n].cpu().numpy()

    # ---------------------------------------------------------------- metrics

    @property
    def compile_count(self) -> int:
        """Distinct sweep shapes dispatched (the reference's ``_lp_sweep``
        compile keys: bucket and statics).  Eager torch compiles nothing
        per shape; the count is the number of launch geometries the sweep
        has used, and equals the reference's ``sweep_compiles``."""
        return len(self._sweep_keys)

    @staticmethod
    def jit_cache_size() -> Optional[int]:
        """``None``: the port keeps no jit cache (the reference returns
        ``None`` too when its cache size is unavailable)."""
        return None

    def stats_dict(self) -> dict:
        return dict(
            sweep_calls=self.stats.sweep_calls,
            bucket_count=self.stats.bucket_count,
            pack_builds=self.stats.pack_builds,
            pack_hits=self.stats.pack_hits,
            dense_rounds=self.stats.dense_rounds,
            contract_calls=self.stats.contract_calls,
            evo_calls=self.stats.evo_calls,
            evo_bucket_count=self.stats.evo_bucket_count,
            contract_bucket_count=self.stats.contract_bucket_count,
            gather_builds=self.stats.gather_builds,
            repair_calls=self.stats.repair_calls,
            repair_bucket_count=self.stats.repair_bucket_count,
            audit_calls=self.stats.audit_calls,
            audit_bucket_count=self.stats.audit_bucket_count,
            h2d_bytes=self.stats.h2d_bytes,
            d2h_bytes=self.stats.d2h_bytes,
            finish_device=self.stats.finish_device,
            finish_moved=self.stats.finish_moved,
            arena=self.A,
            chunk_bucket=(self.C_bucket, self.N, self.E_floor),
        )
