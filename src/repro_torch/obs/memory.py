"""Device-memory accounting and capacity planning.

Two halves of one question: *how many bytes does each stage hold live on
the device, and will graph G fit?*

**Accounting.**  :class:`DeviceMemoryAccountant` attributes live device
buffers to named *families* (:data:`MEMORY_FAMILIES`): the base CSR
levels, the LP engine's chunk and ELL packs, the dynamic store's overlay
uploads and views, label arenas, the GA population batch, deployed block
shards and snapshot captures.  Allocation sites call :func:`account` with
the tensors they just made resident.

Torch tensors, unlike JAX arrays, alias: slices, ``view``s and ``[:n]``
results share one storage, and ``t.nbytes`` is the view's size, not the
buffer's.  So the accountant counts *storages*: it keys each buffer on its
``untyped_storage()`` object (torch keeps one Python object per live
storage, so the key is stable for the buffer's life), counts
``untyped_storage().nbytes()``, and hangs the ``weakref.finalize`` on the
storage.  Two views of one buffer count once, and a buffer is released
when its last tensor or view goes, not when the registered view does.
The family totals track liveness, not allocation volume.  Reading a
storage's size never synchronizes the card.

Snapshot captures call :func:`pin` instead: pins are counted per family
but kept out of the additive total, because a snapshot holds references to
buffers another family already owns.

Accounting is **off by default** (:func:`set_accounting`): a disabled
:func:`account` is one global load and one bool test.  When enabled, the
accountant feeds per-family byte gauges (``mem.<family>_bytes``) in a
:class:`~repro_torch.obs.registry.MetricsRegistry`, peak watermarks (global
and per span close, :meth:`DeviceMemoryAccountant.note_span`), and a
``"ph": "C"`` counter track in the tracer's Chrome trace.

**Capacity planning.**  :func:`estimate_footprint` is the closed form of
the port's allocations: every persistent buffer is sized by the bucket
policies (``pow2`` node and label axes, ``arc_bucket`` arc axes), the
frozen chunk geometry, the ELL width and the dtypes the port allocates
(int64 indices, float32 weights, bool masks), so the footprint of
partitioning or serving an (n, m, k) graph is known before anything is
uploaded.  :func:`will_fit` compares it with the card's memory.

``KNOWN_ALLOC_SITES`` is the manifest of the AST static check
(:mod:`repro_torch.obs.static_check`): every syntactic device allocation
in :data:`ALLOC_CHECK_MODULES` maps to a family or an ``exempt:`` reason.
"""

from __future__ import annotations

import threading
import weakref
from collections import deque
from typing import Dict, Optional

from .registry import MetricsRegistry

__all__ = [
    "MEMORY_FAMILIES",
    "KNOWN_ALLOC_SITES",
    "ALLOC_CHECK_MODULES",
    "FOOTPRINT_TOLERANCE",
    "DeviceMemoryAccountant",
    "accountant",
    "set_accounting",
    "account",
    "pin",
    "estimate_footprint",
    "will_fit",
]


#: Buffer families every persistent device allocation maps to.
MEMORY_FAMILIES = (
    "base_csr",        # GraphDev levels, engine arc tensors, contraction inputs
    "chunk_packs",     # chunk packs, ELL packs, repair region packs
    "overlay_chunks",  # dynamic store COO overlay uploads + view materializations
    "label_arenas",    # arena-sized label/weight tensors (labels, restrict, cw)
    "evo_population",  # batched-GA population + degree tensor
    "block_shards",    # deployed BlockShard tensors (block CSR + ghost halo)
    "snapshot_refs",   # resilience snapshots (references; pinned, not additive)
)

#: Relative error :func:`estimate_footprint` is held to against the
#: measured peak of each family (families under 1 % of the measured total
#: are not held), and of the total.
FOOTPRINT_TOLERANCE = 0.15


def _storage(t):
    """(key, storage, nbytes) of a tensor's buffer, or None for anything
    that is not a tensor with bytes."""
    us = getattr(t, "untyped_storage", None)
    if us is None:
        return None
    s = us()
    nb = s.nbytes()
    if nb == 0:
        return None
    return id(s), s, nb


class DeviceMemoryAccountant:
    """Attributes live device buffers to :data:`MEMORY_FAMILIES`.

    ``register`` is idempotent per buffer (a second registration of the
    same storage, through any view, is free) and thread-safe; release is
    automatic when the storage dies.  All byte totals are live bytes; the
    peak watermarks (global and per span) are the capacity numbers.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.enabled = False
        self.registry = registry
        self._lock = threading.Lock()
        self._live: Dict[int, tuple] = {}     # storage key -> (family, nbytes)
        self._pins: Dict[int, tuple] = {}
        self.bytes_by_family: Dict[str, int] = {f: 0 for f in MEMORY_FAMILIES}
        self.pinned_by_family: Dict[str, int] = {f: 0 for f in MEMORY_FAMILIES}
        self.peak_by_family: Dict[str, int] = {f: 0 for f in MEMORY_FAMILIES}
        self.total = 0
        self.peak_total = 0
        #: enabled register()/pin() invocations
        self.calls = 0
        #: bounded span-close watermark log
        self.span_marks = deque(maxlen=4096)

    # ------------------------------------------------------------- register

    def _attach(self, table: Dict[int, tuple], family: str, tensors,
                release, additive: bool) -> None:
        for t in tensors:
            ent = _storage(t)
            if ent is None:
                continue
            key, s, nb = ent
            with self._lock:
                if key in table:
                    continue
                table[key] = (family, nb)
                if additive:
                    self.bytes_by_family[family] += nb
                    self.total += nb
                    if self.bytes_by_family[family] > self.peak_by_family[family]:
                        self.peak_by_family[family] = self.bytes_by_family[family]
                    if self.total > self.peak_total:
                        self.peak_total = self.total
                else:
                    self.pinned_by_family[family] += nb
            weakref.finalize(s, release, key)
            self._publish(family)

    def register(self, family: str, *tensors) -> None:
        """Attribute the storages of ``tensors`` to ``family``."""
        if not self.enabled:
            return
        if family not in self.bytes_by_family:
            raise KeyError(f"unknown memory family {family!r}")
        self.calls += 1
        self._attach(self._live, family, tensors, self._release, True)

    def pin(self, family: str, *tensors) -> None:
        """Like :meth:`register`, but non-additive: a family (snapshots)
        holds references to buffers another family owns, so pins are
        tracked per family and kept out of ``total``."""
        if not self.enabled:
            return
        if family not in self.pinned_by_family:
            raise KeyError(f"unknown memory family {family!r}")
        self.calls += 1
        self._attach(self._pins, family, tensors, self._release_pin, False)

    def _release(self, key: int) -> None:
        with self._lock:
            ent = self._live.pop(key, None)
            if ent is None:
                return
            family, nb = ent
            self.bytes_by_family[family] -= nb
            self.total -= nb
        self._publish(family)

    def _release_pin(self, key: int) -> None:
        with self._lock:
            ent = self._pins.pop(key, None)
            if ent is None:
                return
            family, nb = ent
            self.pinned_by_family[family] -= nb
        self._publish(family)

    def _publish(self, family: str) -> None:
        reg = self.registry
        if reg is not None:
            reg.gauge(
                f"mem.{family}_bytes",
                self.bytes_by_family[family] + self.pinned_by_family[family],
            )
            reg.gauge("mem.total_bytes", self.total)

    # ------------------------------------------------------------ queries

    def note_span(self, name: str, args: Optional[dict] = None) -> None:
        """Span-close watermark hook (called by ``Tracer._record``): the
        live footprint this span closed at, keyed by span name."""
        if not self.enabled:
            return
        rec = dict(
            name=name,
            total=self.total,
            by_family={f: b for f, b in self.bytes_by_family.items() if b},
        )
        if args:
            for key in ("n", "level", "step", "mode", "region"):
                if key in args:
                    rec[key] = args[key]
        self.span_marks.append(rec)

    def counter_event(self, ts: float, pid: int) -> dict:
        """Chrome-trace counter ("ph": "C") sample of the family bytes."""
        return dict(
            name="device_memory", cat="mem", ph="C", ts=ts, pid=pid, tid=0,
            args={f: self.bytes_by_family[f] for f in MEMORY_FAMILIES},
        )

    def snapshot(self) -> dict:
        with self._lock:
            return dict(
                enabled=self.enabled,
                total=self.total,
                peak_total=self.peak_total,
                by_family=dict(self.bytes_by_family),
                pinned_by_family=dict(self.pinned_by_family),
                peak_by_family=dict(self.peak_by_family),
                buffers=len(self._live),
            )

    # ----------------------------------------------------------- lifecycle

    def reset_peaks(self) -> None:
        with self._lock:
            self.peak_by_family = dict(self.bytes_by_family)
            self.peak_total = self.total
            self.span_marks.clear()

    def reset(self) -> None:
        """Forget every attribution (pending finalizers become no-ops)."""
        with self._lock:
            self._live.clear()
            self._pins.clear()
            self.bytes_by_family = {f: 0 for f in MEMORY_FAMILIES}
            self.pinned_by_family = {f: 0 for f in MEMORY_FAMILIES}
            self.peak_by_family = {f: 0 for f in MEMORY_FAMILIES}
            self.total = 0
            self.peak_total = 0
            self.calls = 0
            self.span_marks.clear()


_acct = DeviceMemoryAccountant()


def accountant() -> DeviceMemoryAccountant:
    """The process-global accountant (mirrors ``watchdog()``)."""
    return _acct


def set_accounting(
    enabled: bool, registry: Optional[MetricsRegistry] = None
) -> bool:
    """Enable/disable device-memory accounting; returns the previous state.

    ``registry``, when given, receives ``mem.<family>_bytes`` gauges on
    every attribution change."""
    prev = _acct.enabled
    if registry is not None:
        _acct.registry = registry
    _acct.enabled = bool(enabled)
    return prev


def account(family: str, *tensors) -> None:
    """Allocation-site entry point: attribute ``tensors`` to ``family``.

    Disabled fast path: one global load and one bool test."""
    a = _acct
    if not a.enabled:
        return
    a.register(family, *tensors)


def pin(family: str, *tensors) -> None:
    """Reference-capture entry point (snapshots): non-additive."""
    a = _acct
    if not a.enabled:
        return
    a.pin(family, *tensors)


# --------------------------------------------------------------------------
# capacity planning: the closed form of the port's allocations
# --------------------------------------------------------------------------


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _arc_bucket(m: int) -> int:
    if m <= 16384:
        return _pow2(max(m, 8))
    return -(-m // 16384) * 16384


def _csr_bytes(n: int, m: int) -> int:
    """One GraphDev level: int64 indptr on Nb + 1 rows, f32 nw on Nb,
    int64 indices and src and f32 ew on the arc bucket."""
    Nb = _pow2(max(n, 8))
    return 8 * (Nb + 1) + 4 * Nb + 20 * _arc_bucket(m)


#: Share of the arcs that the degree-ordered chunk planner closes on the
#: edge cap (hub chunks); the rest of the chunks close on the node cap.
#: Measured on rmat(12..19, 16) and barabasi_albert(2^12..2^16, 6).
_HUB_SHARE = 2.0 / 3.0
#: Shrink of one unrestricted clustering + contraction level (nodes, arcs),
#: and of the first restricted level of V-cycle 2 (rmat(14..17, 16), k=16).
_SHRINK_N, _SHRINK_M = 0.065, 0.4
_RESTRICT_N, _RESTRICT_M = 0.7, 0.22
#: The restricted level's heavy coarse nodes raise the sticky edge bucket.
_E_RAISE = 1.25
_ELL_W, _ELL_TILE = 128, 256


def _pack_geometry(n: int, m: int, target_chunks: int) -> tuple:
    """(C, N, E) of the finest degree-ordered chunk pack: the frozen
    geometry ``chunk_geometry`` asks for (N snapped to pow2, E to 512-arc
    rungs) and the planner's chunk count, hub chunks closed on the edge cap
    plus tail chunks closed on the node cap."""
    tc = max(target_chunks, 2)
    N = _pow2(max(256, -(-n // tc)))
    E_req = max(4096, -(-m // (tc // 2)))
    E = -(-E_req // 512) * 512
    C = _pow2(-(-n // N) + int(_HUB_SHARE * m / E_req + 0.5))
    return C, N, E


def _pack_bytes(C: int, N: int, E: int) -> int:
    """One chunk pack: nodes (C, N) int64 + node_valid bool, edge_dst and
    edge_src_slot (C, E) int64, edge_w f32, edge_valid bool."""
    return C * N * 9 + C * E * 21


def _ell_bytes(n: int, m: int) -> int:
    """One ELL pack: dst (Rb, W) int64, w f32, row_node (Rb,) int64; a node
    owns ceil(deg / W) rows, so hubs add about the hub share of m / W."""
    R = -(-int(n + _HUB_SHARE * m / _ELL_W) // _ELL_TILE) * _ELL_TILE
    return _pow2(R) * (12 * _ELL_W + 8)


def estimate_footprint(
    n: int,
    m: int,
    k: int,
    cfg=None,
    *,
    workload: str = "partition",
    overlay_cap: int = 1 << 16,
    islands: int = 2,
    pop_per_island: int = 2,
) -> dict:
    """Closed-form expected peak device footprint of an (n, m, k) graph.

    Derived from the port's own allocations: pow2 node and label axes,
    ``arc_bucket`` arc axes, the engine's frozen chunk geometry, the ELL
    width of the dense path, and the dtypes the port allocates (int64
    indices, f32 weights, bool masks).  On the structure of the pipeline:

    * ``workload="partition"`` models ``partition()``: the finest level's
      one device CSR (``to_device_csr``: bucket-padded arcs, row pointers
      and node weights), the first coarse level, the finest level's
      degree pack and (``refine_engine="dense"``) its ELL pack, cached for
      the whole run, plus the largest transient pack beside them: the GA's
      pack of the coarsest level of V-cycle 1 (padded to the finest
      level's chunk bucket when that level is a host graph) or V-cycle 2's
      first restricted level (``_RESTRICT_N``, ``_RESTRICT_M``);
    * ``workload="dynamic"`` models the serving peak of a
      ``PartitionSession``: the store's base CSR, the in-flight merge
      outputs and the new base, the overlay upload and view, the
      engine's arc tensors and region packs.

    ``cfg`` may be a ``PartitionerConfig`` or ``SessionConfig``;
    ``target_chunks``, ``coarsest_factor``, ``refine_engine``,
    ``dense_min_n``, ``numpy_below``, ``vcycles``, ``islands``,
    ``pop_per_island``, ``overlay_cap`` and ``compact_fraction`` are read
    off it when present.

    Returns per-family byte estimates plus ``"total"`` (the sum of the
    per-family peaks, the planning bound), ``"levels"`` and
    ``"coarsest_target"``.  Held to :data:`FOOTPRINT_TOLERANCE` against the
    measured family peaks (``tests/test_torch_obs.py`` on the CPU, phase 9
    of ``chip_smoke.py`` on the card)."""
    target_chunks = getattr(cfg, "target_chunks", 64)   # cfg None: defaults
    cf = getattr(cfg, "coarsest_factor", 0)
    islands = getattr(cfg, "islands", islands)
    pop_per_island = getattr(cfg, "pop_per_island", pop_per_island)
    overlay_cap = getattr(cfg, "overlay_cap", overlay_cap)
    compact_fraction = getattr(cfg, "compact_fraction", 0.0)
    dense = getattr(cfg, "refine_engine", "chunked") == "dense"
    dense_min_n = getattr(cfg, "dense_min_n", 4096)
    numpy_below = getattr(cfg, "numpy_below", 4096)
    vcycles = getattr(cfg, "vcycles", 2)
    coarsest = cf * k if cf and cf > 0 else max(k, min(10000 * k, n // 8))

    fam = {f: 0 for f in MEMORY_FAMILIES}
    A = _pow2(max(n + 1, 8))
    Nb = _pow2(max(n, 8))
    Mb = _arc_bucket(m)
    C, N, E = _pack_geometry(n, m, target_chunks)
    tc = max(target_chunks, 2)
    E_req = max(4096, -(-m // (tc // 2)))
    levels = 0

    if workload == "partition":
        # V-cycle 1's coarsening chain: device levels above numpy_below,
        # host levels below; the coarsest level is a GraphDev only when a
        # device contraction lands on it
        nl, ml, dev_level = n, m, True
        while nl > coarsest and levels < 64:
            dev_level = nl >= numpy_below
            nl, ml = max(int(nl * _SHRINK_N), k), int(ml * _SHRINK_M)
            levels += 1
        nc = max(int(coarsest), k)
        if n < numpy_below:
            # every level runs on the host: the engine holds the GA's
            # coarsest level (its device CSR, arena weights and pack) and
            # the finest level's device CSR, which its weight scan reads
            fam["base_csr"] = _csr_bytes(nl, ml) + _csr_bytes(n, m)
            fam["chunk_packs"] = _pack_bytes(
                _pow2(max(-(-nl // N), int(1.05 * ml / E_req) + 1)), N, E)
            fam["label_arenas"] = 8 * A
        else:
            # --- base_csr: the finest level's device CSR (the arcs its pack
            # gathers, contraction and finish read), its CoarseMap, and the
            # first coarse level
            fam["base_csr"] = _csr_bytes(n, m)
            if levels:
                fam["base_csr"] += 8 * Nb + _csr_bytes(int(n * _SHRINK_N),
                                                       int(m * _SHRINK_M))
            # --- chunk_packs: the finest degree pack and either its ELL
            # pack (dense) or its random pack (a host pack pads to the
            # finest chunk bucket), cached for the run, and the largest
            # transient pack beside them
            P0 = _pack_bytes(C, N, E)
            fam["chunk_packs"] = P0 + (
                _ell_bytes(n, m) if dense and n >= dense_min_n else P0)
            extra = 0
            if levels:
                if dev_level:
                    Cc = _pow2(-(-nl // N) + int(_HUB_SHARE * ml / E + 0.5))
                    extra = _pack_bytes(Cc, N, E)
                else:
                    extra = P0    # a host level's pack pads to the finest bucket
            if vcycles > 1 and levels:
                n1, m1 = int(n * _RESTRICT_N), int(m * _RESTRICT_M)
                if n1 >= numpy_below:
                    E1 = -(-int(E * _E_RAISE) // 512) * 512
                    C1 = _pow2(-(-n1 // N) + int(_HUB_SHARE * m1 / E1 + 0.5))
                    extra = max(extra, _pack_bytes(C1, N, E1))
                nc = max(nc, n1)          # V-cycle 2's GA runs there
            fam["chunk_packs"] += extra
            # --- label_arenas: iota (int64), the finest arena's weights
            # (two f32) and three int32 label tensors; a device coarse level
            # adds its arena weights and one more label tensor
            fam["label_arenas"] = 28 * A
            if levels and n * _SHRINK_N >= numpy_below:
                fam["label_arenas"] += 12 * A
        # --- evo_population: (pow2(I * P), pow2(nc + 1)) int64 labels and
        # keys + f32 degrees
        Sb = _pow2(max(islands * pop_per_island, 1))
        Ab = _pow2(max(nc + 1, 8))
        fam["evo_population"] = Sb * Ab * 8 + Sb * 8 + Ab * 4

    elif workload == "dynamic":
        # a compaction holds the old base (itself the outputs of the last
        # merge, over Mb + Rb arc slots) and the in-flight merge outputs;
        # one batch's overlay upload is taken at the reference's
        # overlay_cap / 64 arcs
        Ru = _pow2(max(overlay_cap // 64, 8))
        if compact_fraction > 0.0:
            # view serving: the overlay accrues to the threshold, and the
            # materialized view spans base + overlay arcs
            Ru = _pow2(max(min(overlay_cap, int(compact_fraction * m)), 8))
            fam["overlay_chunks"] = 8 * (Nb + 1) + 20 * (Mb + Ru)
        fam["overlay_chunks"] += 20 * Ru
        fam["base_csr"] = 2 * (20 * (Mb + Ru) + 8 * (Nb + 1)) + 4 * Nb
        # iota (int64), arena weights (f32, two), labels (int32)
        fam["label_arenas"] = 20 * A
        # repair region pack: on power-law graphs the 2-hop region covers
        # most nodes, so it packs like the whole graph in random order, with
        # at least one chunk more than either cap alone needs
        Er = max(512, E_req // 512 * 512)
        Cr = _pow2(max(-(-n // N), int(1.05 * m / E_req) + 1) + 1)
        fam["chunk_packs"] = _pack_bytes(Cr, N, Er)
    else:
        raise ValueError(f"unknown workload {workload!r}")

    fam["total"] = sum(v for f, v in fam.items() if f != "total")
    fam["levels"] = levels if workload == "partition" else 0
    fam["coarsest_target"] = coarsest
    return fam


def will_fit(
    n: int,
    m: int,
    k: int,
    cfg=None,
    *,
    budget_bytes: Optional[int] = None,
    workload: str = "partition",
    safety: float = 1.25,
    device=None,
) -> dict:
    """Pre-upload capacity check: does (n, m, k) fit the device?

    ``budget_bytes`` defaults to the total memory of ``device`` (CUDA
    unless named; ``torch.cuda.mem_get_info``).  On the CPU there is no
    limit: the check reports the estimate with ``fits=None`` unless a
    budget is given.  ``safety`` multiplies the estimate (the caching
    allocator's rounding and the programs' temporaries)."""
    import torch

    est = estimate_footprint(n, m, k, cfg, workload=workload)
    if budget_bytes is None:
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; pass device='cpu' or a "
                    "budget_bytes"
                )
            budget_bytes = int(torch.cuda.mem_get_info(dev)[1])
    need = int(est["total"] * safety)
    return dict(
        estimate=est,
        required_bytes=need,
        budget_bytes=budget_bytes,
        fits=None if budget_bytes is None else bool(need <= budget_bytes),
    )


# --------------------------------------------------------------------------
# static-check manifest: device-allocation sites -> buffer family
# --------------------------------------------------------------------------

#: Modules (relative to ``src/repro_torch``) whose device-allocation sites
#: the AST static check requires to be in :data:`KNOWN_ALLOC_SITES`.
ALLOC_CHECK_MODULES = (
    "graph/csr.py",
    "graph/packing.py",
    "core/engine.py",
    "dynamic/store.py",
    "deploy/extract.py",
    "resilience/snapshot.py",
)

#: ``"<relpath>::<site>" -> family`` (or ``"exempt:<reason>"``), kept in
#: lock-step with the ``account()`` calls at the allocation chokepoints.
KNOWN_ALLOC_SITES: Dict[str, str] = {
    # graph/csr.py: GraphDev.__init__ is the base-CSR chokepoint every
    # level flows through (upload, contraction output, store merge/vacuum)
    "graph/csr.py::to_device_csr": "base_csr",
    # core/engine.py
    "core/engine.py::_upload": "exempt:the host-to-device helper; each "
    "caller is a site of its own",
    "core/engine.py::_arena": "label_arenas",
    "core/engine.py::_deg_f": "evo_population",
    "core/engine.py::_ell": "chunk_packs",
    "core/engine.py::_generations": "evo_population",
    "core/engine.py::_iota": "label_arenas",
    "core/engine.py::_pack_gather": "chunk_packs",
    "core/engine.py::contract": "base_csr",
    "core/engine.py::evolve_device": "evo_population",
    "core/engine.py::project": "label_arenas",
    "core/engine.py::project_restrict": "label_arenas",
    "core/engine.py::to_arena": "label_arenas",
    "core/engine.py::block_weights": "exempt:O(k) reduction scratch",
    "core/engine.py::cluster": "exempt:O(1) restrict placeholder and the "
    "int32 iota the sweep consumes",
    "core/engine.py::refine": "exempt:O(k) block-weight scratch",
    # dynamic/store.py
    "dynamic/store.py::_upload_overlay": "overlay_chunks",
    "dynamic/store.py::_dispatch_merge": "base_csr",
    "dynamic/store.py::_finalize_pending": "base_csr",
    "dynamic/store.py::vacuum": "base_csr",
    "dynamic/store.py::remove_nodes": "exempt:O(removed) validation upload",
    "dynamic/store.py::_runs": "exempt:temporaries of the merge and view "
    "programs",
    "dynamic/store.py::_scatter_set": "exempt:temporaries of the merge and "
    "view programs",
    "dynamic/store.py::_sum_runs": "exempt:temporaries of the merge program",
    # deploy/extract.py
    "deploy/extract.py::_labels_nb": "label_arenas",
}
