"""Multi-tenant throughput mode (dynamic subsystem, layer 4) — the torch
twin of ``repro.dynamic.group``.

:class:`SessionGroup` serves many independent :class:`PartitionSession`
tenants and batches their repair: :func:`~repro_torch.dynamic.repair.
repair_lanes` runs every repair program (frontier expansion, region-pack
gather, block weights, the chunked LP sweep, gain and balance rounds, the
guard's cuts and weights) once per bucket over an explicit leading lane
axis, where the reference ``vmap``s it.  Only host planning (each lane's
region pack) loops over lanes, and each tenant's verdict is its session's
own (``PartitionSession._settle``).

Bucketing: tenants batch together when their shapes agree — ``(arena A,
arc bucket Mb, indptr bucket, k, pack geometry, repair config)``.  Within a
bucket, per-step quantities that differ (live counts, region sizes, chunk
counts, seeds, ``L_max``) are per-lane values, and host-planned layouts are
padded to shared buckets (touched ``Tb``, chunks ``Cb``, edge capacity
``Eb``).  All padding is label-inert, so every lane's labels equal a solo
``session.update`` of the same stream.

Updates that change the node set, net no-ops and post-repair escalations
take the solo path per tenant.  :meth:`SessionGroup.update_many` accepts an
interleaved ``(tenant, update)`` stream and coalesces several updates of a
tenant into one batch (:meth:`GraphUpdate.merged`).  All sessions of a
group must live on one device.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np

from ..obs import RegistryBackedStats
from ..obs import span as _obs_span
from ..obs.watchdog import note_new
from .repair import repair_lanes
from .session import PartitionSession, UpdateResult
from .store import GraphUpdate

__all__ = ["SessionGroup", "GroupStats"]

# repair_lanes' programs under the reference's group.repair key names
_GROUP_KEYS = {"expand": "gexpand", "gather": "ggather", "sweep": "gsweep",
               "gain": "ggain", "balance": "gbal", "score": "gscore"}


class GroupStats(RegistryBackedStats):
    """Counters surfaced through ``SessionGroup.stats_dict()``:
    ``group_steps`` (update_many calls that dispatched a group),
    ``lanes_repaired`` (tenant-updates served by the batched repair),
    ``solo_fallbacks`` (served by session.update), ``noops``, ``coalesced``
    (extra updates merged into a tenant batch); ``group_buckets`` holds the
    reference's per-program shape keys."""

    _COUNTER_FIELDS = (
        "group_steps", "lanes_repaired", "solo_fallbacks", "noops",
        "coalesced",
    )
    _SET_FIELDS = ("group_buckets",)

    @property
    def group_bucket_count(self) -> int:
        return len(self.group_buckets)


class SessionGroup:
    """Serve a fleet of :class:`PartitionSession` tenants with batched
    repair.  Tenants keep their full solo identity (store, engine, labels,
    trajectory, escalation guard), so any tenant can leave the group and
    continue solo at any step."""

    def __init__(self, sessions: Mapping[str, PartitionSession]):
        if not sessions:
            raise ValueError("SessionGroup needs at least one session")
        devices = {s.device for s in sessions.values()}
        if len(devices) > 1:
            raise ValueError(f"SessionGroup sessions live on several devices: {devices}")
        self.sessions: Dict[str, PartitionSession] = dict(sessions)
        self.device = devices.pop()
        self.stats = GroupStats()
        self._bucket_E: Dict[tuple, int] = {}   # sticky shared edge buckets

    # ------------------------------------------------------------- public

    def update_many(
        self, updates: Iterable[Tuple[str, GraphUpdate]]
    ) -> Dict[str, UpdateResult]:
        """Absorb one merged update stream: coalesce per tenant, batch the
        eligible lanes into repair buckets, fall back to solo
        ``session.update`` for the rest.  Returns the newest
        :class:`UpdateResult` per updated tenant; a batched lane's
        ``seconds`` is the group step's wall time divided by its lanes.

        Every update is validated before ANY tenant's state moves — a bad
        batch aborts the whole call with all sessions as they were."""
        per: Dict[str, GraphUpdate] = {}
        order: List[str] = []
        for name, upd in updates:
            if name not in self.sessions:
                raise KeyError(f"unknown tenant {name!r}")
            if name in per:
                per[name] = per[name].merged(upd)
                self.stats.coalesced += 1
            else:
                per[name] = upd
                order.append(name)
        for name in order:
            per[name].validate(self.sessions[name].store.n)
        results: Dict[str, UpdateResult] = {}
        lanes = []
        for name in order:
            sess, upd = self.sessions[name], per[name]
            net_u, net_v, _ = upd.net_arcs(
                max(sess.store.n + upd.num_new_nodes, 1)
            )
            if net_u.size == 0 and upd.num_new_nodes == 0:
                results[name] = sess.update(upd)     # solo no-op (cheap)
                self.stats.noops += 1
            elif upd.num_new_nodes:
                results[name] = sess.update(upd)     # node churn: solo
                self.stats.solo_fallbacks += 1
            else:
                lanes.append((name, sess, upd, net_u, net_v))
        if not lanes:
            return results
        t0 = time.time()
        # ---- apply + compact per lane, bucket by shapes ----
        buckets: Dict[tuple, list] = {}
        for name, sess, upd, net_u, net_v in lanes:
            lane = sess.stage_lane(upd, np.concatenate([net_u, net_v]))
            cfg = sess.cfg
            gkey = (
                lane.labels.shape[0], lane.src.shape[0], lane.indptr.shape[0],
                sess.k, *lane.pack, cfg.hops, cfg.repair_iters,
                cfg.gain_rounds, cfg.balance_rounds,
            )
            buckets.setdefault(gkey, []).append((name, sess, lane))
        for gkey, members in buckets.items():
            k, (hops, iters, gain_rounds, balance_rounds) = gkey[3], gkey[-4:]
            with _obs_span(
                "group.lane", cat="group", lanes=len(members),
                tenants=",".join(m[0] for m in members),
            ):
                rep = repair_lanes([lane for _, _, lane in members], k, hops=hops,
                                   iters=iters, gain_rounds=gain_rounds,
                                   balance_rounds=balance_rounds,
                                   E=self._bucket_E.get(gkey, 0), note=self._note)
                self._bucket_E[gkey] = rep.E
                for i, (name, sess, lane) in enumerate(members):
                    sess.labels = rep.labels[i]
                    self.stats.lanes_repaired += 1
                    # the reference's group scores in float64, its session
                    # in float32
                    results[name] = sess._settle(
                        rep.cuts[i], rep.bws[i].astype(np.float64),
                        max(float(rep.ews[i]), 1e-9), lane.seed, sess.store.m,
                        lambda phase: None, region_size=rep.sizes[i])
        elapsed = time.time() - t0
        nl = max(len(lanes), 1)
        for name, *_ in lanes:
            results[name].seconds = elapsed / nl
        self.stats.group_steps += 1
        return results

    def _note(self, stage: str, T: int, *dims) -> None:
        """:func:`repair_lanes`' note hook: the reference's group keys."""
        note_new(self.stats.group_buckets, "group.repair",
                 (_GROUP_KEYS[stage], T) + dims)

    def stats_dict(self) -> dict:
        return dict(
            tenants=len(self.sessions),
            group_steps=self.stats.group_steps,
            lanes_repaired=self.stats.lanes_repaired,
            solo_fallbacks=self.stats.solo_fallbacks,
            noops=self.stats.noops,
            coalesced=self.stats.coalesced,
            group_bucket_count=self.stats.group_bucket_count,
        )
