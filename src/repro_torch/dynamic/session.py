"""Batched update-serving session (dynamic subsystem, layer 3) — the torch
twin of ``repro.dynamic.session``.

:class:`PartitionSession` keeps a graph and its k-way partition resident
on one device; batched :class:`~repro_torch.dynamic.store.GraphUpdate`
requests stream in, each is absorbed by the store, repaired locally by
:meth:`~repro_torch.core.engine.LPEngine.repair` and scored.  The full
multilevel ``partition()`` runs only at session start and when the quality
guard trips:

* **feasibility** — ``max_b c(V_b) <= L_max`` with ``L_max`` recomputed
  from the current total node weight every batch;
* **cut drift** — the running cut against the cut of the last full
  partition, scaled by edge-weight growth; past ``escalate_cut_ratio``
  times that reference, a fresh V-cycle seeded with the served labels
  runs on the resident graph.

A batch whose net arc deltas are empty leaves the label tensor untouched
(the same object).  Every other path is deterministic in (initial graph,
config, update stream): repair seeds derive from the step counter.

No code here writes into a tensor the session or its store holds, or that
a snapshot may hold: labels are only ever rebound to new tensors.  The
reference's memory accounting and compile counters are not ported.
:meth:`PartitionSession.from_restored` rebuilds a session from a
checkpoint without the initial V-cycle.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.engine import LPEngine
from ..core.metrics import lmax
from ..core.multilevel import PartitionerConfig, partition
from ..device import resolve_device
from ..graph.csr import GraphNP
from ..obs import MetricsRegistry
from ..obs import span as _obs_span
from ..obs.memory import account as _mem_account
from .store import DynamicGraphStore, GraphUpdate

__all__ = ["PartitionSession", "SessionConfig", "UpdateResult"]


@dataclass
class SessionConfig:
    k: int = 2
    eps: float = 0.03
    # repair shape: h-hop region radius, LP sweep iterations, gain/balance
    # round counts (fm.py-spec synchronous rounds, region-masked)
    hops: int = 2
    repair_iters: int = 6
    gain_rounds: int = 2
    balance_rounds: int = 3
    # hub-bounded frontier expansion (repair locality on power-law graphs):
    # hops past the first only expand through nodes of degree <= cap, so a
    # 2-hop region no longer engulfs the graph at hubs.  None = auto
    # (8x the current average degree, floored at 64 — meshes and other
    # bounded-degree graphs are never capped), 0 = disabled, > 0 explicit.
    hop_degree_cap: Optional[int] = None
    # escalate to a full V-cycle when the running cut exceeds this ratio of
    # the (edge-weight-scaled) cut of the last full partition
    escalate_cut_ratio: float = 1.6
    overlay_cap: int = 1 << 16
    # compaction-threshold policy: 0.0 = compact before every
    # repair (the historical behavior); > 0 = repair directly on the
    # base CSR + overlay *view* while the overlay holds fewer than this
    # fraction of the base arcs, compacting only past the threshold.
    # Labels are bit-identical either way — the knob trades the merge
    # sort's latency against the view's O(m) elementwise rebuild.
    compact_fraction: float = 0.0
    # when a threshold compaction is due, dispatch it asynchronously and
    # keep serving from the view: batch t's merge runs on the card while
    # the host goes on (no sync until the swap), which lands at the next
    # update
    defer_compaction: bool = False
    target_chunks: int = 64
    seed: int = 0
    # serving SLO: per-update latency objective + error budget.  The flight
    # recorder (a ring of the last ``flight_recorder_len`` update latencies)
    # feeds the ``slo_budget_remaining`` burn-rate gauge: 1.0 = no recent
    # update breached ``slo_target_seconds``, 0.0 = the window has consumed
    # ``slo_error_budget`` (fraction of updates allowed over target) or more
    slo_target_seconds: float = 0.25
    slo_error_budget: float = 0.1
    flight_recorder_len: int = 128
    # full-pipeline config for session start + escalations; defaults to the
    # paper's fast preset at this (k, eps)
    partition_cfg: Optional[PartitionerConfig] = None

    @classmethod
    def throughput(cls, **kw) -> "SessionConfig":
        """Preset for sustained update streams (the reference benchmark's
        throughput rows): overlay-aware repair with deferred compaction and
        a shorter refinement sweep (2 iterations instead of 6; the
        escalation guard still backstops quality)."""
        kw.setdefault("repair_iters", 2)
        kw.setdefault("compact_fraction", 0.25)
        kw.setdefault("defer_compaction", True)
        return cls(**kw)

    def make_partition_cfg(self, seed: int) -> PartitionerConfig:
        if self.partition_cfg is not None:
            cfg = self.partition_cfg
            if cfg.k != self.k:
                raise ValueError("partition_cfg.k must match SessionConfig.k")
            cfg.seed = seed
            return cfg
        return PartitionerConfig(
            k=self.k, eps=self.eps, preset="fast", seed=seed,
            target_chunks=self.target_chunks,
        )


@dataclass
class UpdateResult:
    """One trajectory point of the serving loop."""

    step: int
    n: int
    m: int                      # arcs (2x undirected edges)
    cut: float
    imbalance: float
    feasible: bool
    region_size: int = 0
    escalated: bool = False
    noop: bool = False
    stale: bool = False         # degraded mode: escalation wanted but
                                # suppressed — serving last repaired labels
    used_view: bool = False     # repaired on the base + overlay view
                                # (compaction skipped this step)
    compact_deferred: bool = False  # threshold compaction dispatched async
    seconds: float = 0.0
    h2d_bytes: int = 0          # engine-accounted transfer deltas of the step
    d2h_bytes: int = 0
    t_mono: float = 0.0         # monotonic clock at step END (ordering /
                                # latency joins across restarts use deltas)
    span_ms: Dict[str, float] = field(default_factory=dict)
                                # per-phase wall-ms breakdown (validate /
                                # store / compact / repair / score / ...)


def _reg_counter(name: str):
    """Session counter stored in the stack's :class:`MetricsRegistry` —
    the attribute surface (``sess.escalations += 1``) is unchanged, but
    reset/snapshot/export all go through the one registry path."""

    def _get(self):
        return self.metrics.get(name)

    def _set(self, value):
        self.metrics.set_counter(name, value)

    return property(_get, _set, doc=f"registry-backed counter {name!r}")




class PartitionSession:
    """Device-resident graph + partition absorbing a stream of updates.
    Runs on ``device`` (CUDA unless the caller names another): the store,
    the engine and every ``partition()`` of the session live there."""

    escalations = _reg_counter("escalations")
    engine_rebuilds = _reg_counter("engine_rebuilds")
    escalate_h2d_saved = _reg_counter("escalate_h2d_saved")
    suppressed_escalations = _reg_counter("suppressed_escalations")
    updates_applied = _reg_counter("updates_applied")
    view_hits = _reg_counter("view_hits")

    def __init__(self, g: GraphNP, cfg: SessionConfig, *, device=None):
        t0 = time.time()
        device = resolve_device(device)
        rep = partition(g, cfg.make_partition_cfg(cfg.seed), device=device)
        self._build(g, cfg, device, rep.labels, step=0, cut_ref=float(rep.cut),
                    ew_ref=max(float(g.ew.sum()) / 2.0, 1e-9))
        cut, imb, feas = self._score(self.store.base)
        self.trajectory: List[UpdateResult] = [UpdateResult(
            step=0, n=g.n, m=g.m, cut=cut, imbalance=imb, feasible=feas,
            escalated=True, seconds=time.time() - t0,
        )]

    @classmethod
    def from_restored(
        cls,
        g: GraphNP,
        cfg: SessionConfig,
        *,
        labels: np.ndarray,
        step: int,
        cut_ref: float,
        ew_ref: float,
        trajectory: Optional[List[UpdateResult]] = None,
        suppress_escalation: bool = False,
        device=None,
    ) -> "PartitionSession":
        """Rebuild a session from durably-captured state WITHOUT running the
        initial ``partition()`` V-cycle — the disaster-recovery constructor
        (:mod:`repro_torch.resilience.durable`).  ``g`` is the checkpointed
        base graph; ``labels``/``step``/``cut_ref``/``ew_ref`` restore the
        exact serving state, so replaying the same post-checkpoint update
        stream reproduces the pre-crash labels bit for bit (every repair
        seed derives from the restored step counter).  Engine and store are
        built by the same :meth:`_build` as :meth:`__init__`, on ``device``
        (CUDA unless the caller names another)."""
        self = cls.__new__(cls)
        self._build(g, cfg, resolve_device(device), labels, step=step,
                    cut_ref=cut_ref, ew_ref=ew_ref)
        self.suppress_escalation = bool(suppress_escalation)
        if trajectory:
            self.trajectory = list(trajectory)
        else:
            cut, imb, feas = self._score(self.store.base)
            self.trajectory = [UpdateResult(
                step=self._step, n=g.n, m=g.m, cut=cut, imbalance=imb,
                feasible=feas,
            )]
        return self

    def _build(self, g: GraphNP, cfg: SessionConfig, device: torch.device,
               labels, *, step: int, cut_ref: float, ew_ref: float) -> None:
        """Engine, store, labels and counters of a session on ``device``
        serving ``labels`` of ``g`` at ``step``: the one build of both
        constructors."""
        self.device = device
        self.cfg = cfg
        self.k = cfg.k
        # one registry per serving stack: engine + store + session counters
        self.metrics = MetricsRegistry("session")
        self.engine = LPEngine(
            g, target_chunks=cfg.target_chunks, seed=cfg.seed,
            registry=self.metrics, device=device,
        )
        self.store = DynamicGraphStore(
            g, overlay_cap=cfg.overlay_cap,
            on_h2d=self._note_h2d, on_d2h=self._note_d2h,
            registry=self.metrics, device=device,
        )
        self._base_id = id(self.store.base)
        self.labels = self.engine.to_arena(np.asarray(labels, np.int32), g.n, fill=self.k)
        self.escalations = 0
        self.engine_rebuilds = 0
        self.escalate_h2d_saved = 0
        self.suppressed_escalations = 0
        self.updates_applied = 0
        self.view_hits = 0
        # degraded mode: quality-guard escalations are skipped and the step
        # is flagged ``stale`` instead
        self.suppress_escalation = False
        # flight recorder: (t_mono, seconds) of the most recent updates
        self.flight = deque(maxlen=max(1, cfg.flight_recorder_len))
        self._step = int(step)
        self._cut_ref = float(cut_ref)
        self._ew_ref = float(ew_ref)

    # --------------------------------------------------------------- internal

    def _note_h2d(self, nbytes: int) -> None:
        self.engine.stats.h2d_bytes += int(nbytes)

    def _note_d2h(self, nbytes: int) -> None:
        self.engine.stats.d2h_bytes += int(nbytes)

    def _lmax(self) -> float:
        return lmax(self.store.total_node_weight, self.k, self.cfg.eps)

    def _hop_cap(self) -> Optional[int]:
        """Effective frontier degree cap: auto scales with the current
        average degree so bounded-degree (mesh) graphs never bind."""
        c = self.cfg.hop_degree_cap
        if c is None:
            return max(64, int(8 * self.store.m / max(self.store.n, 1)))
        return None if c == 0 else int(c)

    def _record_latency(self, res: UpdateResult) -> None:
        """Push one update latency through the flight recorder and refresh
        the ``slo_budget_remaining`` gauge: the unburned fraction of the
        window's error budget (up to ``slo_error_budget * W`` of the last
        ``W`` updates may exceed ``slo_target_seconds`` before it hits 0)."""
        self.metrics.observe("update_seconds", res.seconds)
        self.flight.append((res.t_mono, res.seconds))
        target = self.cfg.slo_target_seconds
        bad = sum(1 for _, s in self.flight if s > target)
        allowed = max(self.cfg.slo_error_budget * len(self.flight), 1e-9)
        remaining = max(0.0, 1.0 - bad / allowed)
        self.metrics.gauge("slo_budget_remaining", remaining)

    def _score(self, g) -> tuple:
        """(cut, imbalance, feasible) of the resident labels on the device."""
        cut = self.engine.cut(g, self.labels)
        bw = self.engine.block_weights(g, self.labels, self.k)
        self.engine.stats.d2h_bytes += 4 + bw.nbytes
        W = max(self.store.total_node_weight, 1e-9)
        imb = float(bw.max() * self.k / W - 1.0)
        feas = bool(bw.max() <= self._lmax() + 1e-6)
        return float(cut), imb, feas

    def _assign_new_nodes(self, g, first_new: int) -> None:
        """Greedy bin-pack freshly added nodes into the lightest blocks
        before repair.  Builds a new label tensor: the old one may be held
        by a snapshot."""
        ids = np.arange(first_new, self.store.n, dtype=np.int64)
        if ids.size == 0:
            return
        bw = self.engine.block_weights(g, self.labels, self.k).astype(np.float64)
        nw = self.store.node_weights()
        asg = np.empty(ids.size, np.int32)
        for i, v in enumerate(ids):
            b = int(np.argmin(bw))
            asg[i] = b
            bw[b] += nw[v]
        lab = self.labels.clone()
        lab[torch.from_numpy(ids).to(self.device)] = torch.from_numpy(asg).to(self.device)
        self.labels = lab
        _mem_account("label_arenas", self.labels)
        self.engine.stats.h2d_bytes += ids.size * 12

    def _step_seed(self) -> int:
        """The repair (and escalation) seed of the current step."""
        return (self.cfg.seed * 0x9E3779B1 + self._step) & 0x7FFFFFFF

    def _rebase(self, g) -> None:
        """Follow the store's graph ``g`` after an update's compaction:
        drop device caches keyed on an older base handle, and rebuild the
        engine when nodes outgrew its label arena (pow2 headroom above the
        initial n).  Labels carry over; fresh slots arrive unassigned
        (label k) for ``_assign_new_nodes`` to place."""
        if id(g) != self._base_id:
            self.engine.evict(keep=(g,))
            self._base_id = id(g)
        if self.store.n < self.engine.A:
            return
        gh = self.store.csr_host()
        old_engine = self.engine
        old = self.labels.cpu().numpy()
        self.engine = LPEngine(
            gh, target_chunks=self.cfg.target_chunks, seed=self.cfg.seed,
            device=self.device,
        )
        # cumulative counters and bucket sets survive the swap
        self.engine.carry_from(old_engine)
        lab = np.full(gh.n, self.k, np.int32)
        keep = min(old.shape[0], gh.n)
        lab[:keep] = old[:keep]
        self.labels = self.engine.to_arena(lab, gh.n, fill=self.k)
        self.engine_rebuilds += 1

    def _escalate(self, seed: int) -> None:
        """Full multilevel re-partition of the RESIDENT device graph (the
        quality guard's fallback), seeded with the current labels
        (``PartitionerConfig.initial_labels``) so it refines the served
        solution; resets the cut reference.  ``partition()`` takes the
        :class:`GraphDev` handle directly."""
        gd = self.store.graph()
        cfg = self.cfg.make_partition_cfg(seed)
        lab = self.labels_np()
        cfg.initial_labels = lab if np.all(lab < self.k) else None
        try:
            rep = partition(gd, cfg, device=self.device)
        finally:
            cfg.initial_labels = None   # never pin O(n) labels on the cfg
        # the host path would have re-uploaded the bucketed CSR (src,
        # indices, ew) plus node weights to build the V-cycle's engine
        self.escalate_h2d_saved += (
            gd.indices.shape[0] * 12 + gd.nw.shape[0] * 4
        )
        self.labels = self.engine.to_arena(rep.labels, gd.n, fill=self.k)
        self._cut_ref = float(rep.cut)
        self._ew_ref = max(float(gd.ew.sum()) / 2.0, 1e-9)
        self.escalations += 1

    # ----------------------------------------------------------------- public

    @property
    def n(self) -> int:
        return self.store.n

    @property
    def cut(self) -> float:
        return self.trajectory[-1].cut

    @property
    def imbalance(self) -> float:
        return self.trajectory[-1].imbalance

    def labels_np(self) -> np.ndarray:
        """A host copy of the labels of the live nodes."""
        return self.engine.to_host(self.labels, self.store.n).copy()

    def update(self, upd: GraphUpdate) -> UpdateResult:
        """Absorb one batched update: validate -> store -> compact -> region
        repair -> quality guard.  Returns (and appends) the new trajectory
        point.  Validation runs before ANY session state moves (including
        the step counter that seeds repair), so a rejected batch leaves the
        session and store as they were."""
        with _obs_span(
            "session.update", cat="session", step=self._step + 1
        ) as sp:
            res = self._update_impl(upd)
            sp.set(
                noop=res.noop, escalated=res.escalated,
                used_view=res.used_view, region=res.region_size,
            )
        self._record_latency(res)
        return res

    def _update_impl(self, upd: GraphUpdate) -> UpdateResult:
        t0 = time.time()
        sp_ms: Dict[str, float] = {}
        t_last = time.perf_counter()

        def lap(phase: str) -> None:
            # always-on phase clock (plain perf_counter reads); feeds span_ms
            nonlocal t_last
            now = time.perf_counter()
            sp_ms[phase] = sp_ms.get(phase, 0.0) + (now - t_last) * 1e3
            t_last = now

        upd.validate(self.store.n)
        lap("validate")
        self._step += 1
        st = self.engine.stats
        h2d0, d2h0 = st.h2d_bytes, st.d2h_bytes
        prospective_n = self.store.n + upd.num_new_nodes
        net_u, net_v, net_w = upd.net_arcs(max(prospective_n, 1))
        if net_u.size == 0 and upd.num_new_nodes == 0:
            # net no-op: nothing to store, nothing to repair — the resident
            # label tensor is left untouched
            last = self.trajectory[-1]
            res = UpdateResult(
                step=self._step, n=self.store.n, m=self.store.m, cut=last.cut,
                imbalance=last.imbalance, feasible=last.feasible, noop=True,
                seconds=time.time() - t0,
                t_mono=time.monotonic(), span_ms=sp_ms,
            )
            self.trajectory.append(res)
            return res
        first_new = self.store.n
        self.store.apply(upd)
        lap("store")
        # ---- compaction policy: below the threshold, repair on the base +
        # overlay view and skip the merge; past it, compact — synchronously,
        # or (defer_compaction) launch the merge and keep serving from the
        # view while it runs
        use_view = (
            self.cfg.compact_fraction > 0.0
            and upd.num_new_nodes == 0
            and self.store.can_view()
        )
        deferred = False
        if use_view and (
            self.store.overlay_fraction() > self.cfg.compact_fraction
        ):
            if self.cfg.defer_compaction:
                self.store.compact(deferred=True)
                deferred = True
            else:
                use_view = False
        if use_view:
            g = self.store.base         # overlay stays pending; the base
            adjacency = self.store.view()   # handle (and every engine cache
        else:                           # keyed on it) survives the step
            g = self.store.graph()      # compacts the overlay
            adjacency = None
        lap("compact")
        self._rebase(g)
        self._assign_new_nodes(g, first_new)
        lap("rebuild")
        touched = np.concatenate([
            net_u, net_v,
            np.arange(first_new, self.store.n, dtype=np.int64),
        ])
        seed = self._step_seed()
        self.labels, rsize, cut, bw = self.engine.repair(
            g, self.labels, touched, self.k, self._lmax(),
            hops=self.cfg.hops, iters=self.cfg.repair_iters,
            gain_rounds=self.cfg.gain_rounds,
            balance_rounds=self.cfg.balance_rounds, seed=seed,
            hop_degree_cap=self._hop_cap(),
            adjacency=None if adjacency is None else adjacency[:4],
        )
        lap("repair")
        if adjacency is None:
            m_now = self.store.m
            ew_now = max(float(g.ew.sum()) / 2.0, 1e-9)
        else:
            # merged counts come from the view (the base is stale by the
            # pending overlay); padding arcs carry weight 0
            m_now = int(adjacency[4])
            ew_now = max(float(adjacency[3].sum()) / 2.0, 1e-9)
        st.d2h_bytes += 8
        res = self._settle(cut, bw, ew_now, seed, m_now, lap,
                           region_size=int(rsize), used_view=use_view,
                           compact_deferred=deferred, span_ms=sp_ms)
        if use_view:
            self.view_hits += 1
        res.seconds = time.time() - t0
        res.h2d_bytes = st.h2d_bytes - h2d0
        res.d2h_bytes = st.d2h_bytes - d2h0
        return res

    def stage_lane(self, upd: GraphUpdate, touched: np.ndarray):
        """A ``SessionGroup`` lane's half of :meth:`update` (no node churn,
        always compacted): absorb the validated ``upd`` and stage this
        step's repair around ``touched``; :meth:`_settle` takes its result."""
        self._step += 1
        self.store.apply(upd)
        g = self.store.graph()
        self._rebase(g)
        return self.engine.repair_lane(g, self.labels, touched, self.k,
                                       self._lmax(), self._step_seed(),
                                       self._hop_cap(), None)

    def _settle(self, cut: float, bw: np.ndarray, ew_now: float, seed: int,
                m: int, lap, **fields) -> UpdateResult:
        """The quality guard's verdict on a repaired step (solo or group
        lane): score its ``cut`` and block weights ``bw`` (in ``bw``'s
        dtype), escalate (or flag stale) when it is infeasible or the cut
        drifted past the last full partition's, scaled by ``ew_now``, and
        append the trajectory point; ``lap`` clocks the phases."""
        W = max(self.store.total_node_weight, 1e-9)
        imb = float(bw.max() * self.k / W - 1.0)
        feas = bool(bw.max() <= self._lmax() + 1e-6)
        scaled_ref = self._cut_ref * (ew_now / self._ew_ref)
        wanted = (not feas) or (
            cut > self.cfg.escalate_cut_ratio * max(scaled_ref, 1.0)
        )
        escalated = wanted and not self.suppress_escalation
        stale = wanted and self.suppress_escalation
        lap("score")
        if stale:
            self.suppressed_escalations += 1
        if escalated:
            self._escalate(seed)
            # escalation compacted the store — rescore on the fresh base
            cut, imb, feas = self._score(self.store.base)
            m = self.store.m
            lap("escalate")
        self.updates_applied += 1
        res = UpdateResult(
            step=self._step, n=self.store.n, m=m, cut=cut, imbalance=imb,
            feasible=feas, escalated=escalated, stale=stale,
            t_mono=time.monotonic(), **fields,
        )
        self.trajectory.append(res)
        return res

    def add_edges(self, u, v, w=None) -> UpdateResult:
        return self.update(GraphUpdate.add_edges(u, v, w))

    def remove_edges(self, u, v, w=None) -> UpdateResult:
        return self.update(GraphUpdate.remove_edges(u, v, w))

    def add_nodes(self, nw) -> UpdateResult:
        return self.update(GraphUpdate.add_nodes(nw))

    def remove_nodes(self, ids) -> UpdateResult:
        """Remove *isolated* nodes (disconnect them with ``remove_edges``
        first): tombstone, vacuum the CSR on the device (ids re-pack
        contiguously; ``store.last_vacuum_map`` is the old -> new map), and
        remap the resident labels through the same map.  The cut is
        untouched; the balance bound tightens with the total weight, so the
        step re-scores feasibility and escalates under the usual guard."""
        t0 = time.time()
        self._step += 1
        step = self._step
        st = self.engine.stats
        h2d0, d2h0 = st.h2d_bytes, st.d2h_bytes
        n_old = self.store.n
        self.store.remove_nodes(ids)    # validates isolation (compacts)
        mapping = self.store.vacuum()
        keep = mapping >= 0
        lab_old = self.labels[:n_old].cpu().numpy()
        st.d2h_bytes += lab_old.nbytes
        lab_new = lab_old[keep]
        g = self.store.base
        self._rebase(g)
        self.labels = self.engine.to_arena(lab_new, self.store.n, fill=self.k)
        st.h2d_bytes += lab_new.size * 4
        cut, imb, feas = self._score(g)
        seed = self._step_seed()
        escalated = stale = False
        if not feas:
            if self.suppress_escalation:
                stale = True
                self.suppressed_escalations += 1
            else:
                escalated = True
                self._escalate(seed)
                cut, imb, feas = self._score(self.store.base)
        res = UpdateResult(
            step=step, n=self.store.n, m=self.store.m, cut=cut,
            imbalance=imb, feasible=feas, escalated=escalated, stale=stale,
            seconds=time.time() - t0,
            h2d_bytes=st.h2d_bytes - h2d0, d2h_bytes=st.d2h_bytes - d2h0,
            t_mono=time.monotonic(),
        )
        self.updates_applied += 1
        self._record_latency(res)
        self.trajectory.append(res)
        return res

    def stats(self) -> dict:
        """Engine + store + session counters (the serving dashboard row)."""
        d = self.engine.stats_dict()
        d.update(
            updates=self._step,
            updates_applied=self.updates_applied,
            view_hits=self.view_hits,
            escalations=self.escalations,
            escalate_h2d_saved=self.escalate_h2d_saved,
            suppressed_escalations=self.suppressed_escalations,
            degraded=self.suppress_escalation,
            engine_rebuilds=self.engine_rebuilds,
            compact_calls=self.store.stats.compact_calls,
            compact_bucket_count=self.store.stats.compact_bucket_count,
            compact_deferred=self.store.stats.compact_deferred,
            compact_pending=self.store.compact_pending,
            view_calls=self.store.stats.view_calls,
            view_bucket_count=self.store.stats.view_bucket_count,
            vacuum_calls=self.store.stats.vacuum_calls,
            vacuum_bucket_count=self.store.stats.vacuum_bucket_count,
            overlay_len=self.store.overlay_len,
            edges_added=self.store.stats.edges_added,
            edges_removed=self.store.stats.edges_removed,
            nodes_added=self.store.stats.nodes_added,
            nodes_removed=self.store.stats.nodes_removed,
            slo_budget_remaining=self.metrics.get_gauge(
                "slo_budget_remaining", 1.0
            ),
        )
        return d

    # ------------------------------------------------------- snapshot support

    def snapshot_state(self) -> dict:
        """Capture the full serving state by reference: labels, the
        quality-guard references, the step counter that seeds repair, the
        engine, the trajectory prefix and the store's graph state.  Sound
        because no serving code writes into a captured tensor (labels are
        only rebound; see the module docstring).  Restoring a capture makes
        the session bit-identical to the moment it was taken."""
        return dict(
            labels=self.labels,
            step=self._step,
            cut_ref=self._cut_ref,
            ew_ref=self._ew_ref,
            base_id=self._base_id,
            engine=self.engine,
            escalations=self.escalations,
            engine_rebuilds=self.engine_rebuilds,
            escalate_h2d_saved=self.escalate_h2d_saved,
            trajectory=list(self.trajectory),
            store=self.store.snapshot_state(),
        )

    def restore_state(self, st: dict) -> None:
        """Rebind session state to a :meth:`snapshot_state` capture."""
        self.labels = st["labels"]
        self._step = st["step"]
        self._cut_ref = st["cut_ref"]
        self._ew_ref = st["ew_ref"]
        self._base_id = st["base_id"]
        self.engine = st["engine"]
        self.escalations = st["escalations"]
        self.engine_rebuilds = st["engine_rebuilds"]
        self.escalate_h2d_saved = st["escalate_h2d_saved"]
        self.trajectory = list(st["trajectory"])
        self.store.restore_state(st["store"])
