"""Multi-tenant throughput mode (dynamic subsystem, layer 4) — the torch
twin of ``repro.dynamic.group``.

:class:`SessionGroup` serves many independent :class:`PartitionSession`
tenants and batches their repair: every repair program (frontier
expansion, region-pack gather, block weights, the chunked LP sweep, gain
and balance rounds, the guard's cuts and weights, the final select) runs
once per bucket over an explicit leading lane axis, where the reference
``vmap``s it.  Only host planning (each lane's region pack) loops over
lanes.

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
import torch

from ..core.label_propagation import hash_base_u32, lp_sweep_batched
from ..core.metrics import block_weights_dense, cut_from_arcs
from ..graph.csr import pow2
from ..graph.packing import gather_pack_device, plan_region_pack
from ..obs import RegistryBackedStats
from ..obs import span as _obs_span
from ..obs.watchdog import note_new
from .repair import (
    TAG_DYN_GAIN,
    TAG_DYN_GAIN_GATE,
    balance_rounds_device,
    expand_region_device,
    gain_round_device,
)
from .session import PartitionSession, UpdateResult
from .store import GraphUpdate

__all__ = ["SessionGroup", "GroupStats"]


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
            sess._step += 1
            sess.store.apply(upd)
            g = sess.store.graph()
            sess._maybe_rebuild_engine()
            if id(g) != sess._base_id:
                sess.engine.evict(keep=(g,))
                sess._base_id = id(g)
            eng, cfg = sess.engine, sess.cfg
            gkey = (
                eng.A, g.indices.shape[0], g.indptr.shape[0], sess.k,
                eng.N, eng._e_request, eng.pack_block, cfg.hops,
                cfg.repair_iters, cfg.gain_rounds, cfg.balance_rounds,
            )
            buckets.setdefault(gkey, []).append((name, sess, g, net_u, net_v))
        for gkey, members in buckets.items():
            with _obs_span(
                "group.lane", cat="group", lanes=len(members),
                tenants=",".join(m[0] for m in members),
            ):
                self._dispatch_bucket(gkey, members, results)
        elapsed = time.time() - t0
        nl = max(len(lanes), 1)
        for name, *_ in lanes:
            results[name].seconds = elapsed / nl
        self.stats.group_steps += 1
        return results

    # ------------------------------------------------------------ internals

    def _dispatch_bucket(self, gkey, members, results) -> None:
        (A, Mb, ipb, k, Npack, e_req, pblock, hops, iters, gain_rounds,
         balance_rounds) = gkey
        dev = self.device
        T = len(members)
        Kb = k + 1
        def note(key):
            note_new(self.stats.group_buckets, "group.repair", key)

        # ---- per-lane host planning (mirrors LPEngine.repair) ----
        seeds, caps, ns, Us, t_list, ars = [], [], [], [], [], []
        for name, sess, g, net_u, net_v in members:
            ars.append(sess.engine._arena(g))
            seeds.append((sess.cfg.seed * 0x9E3779B1 + sess._step) & 0x7FFFFFFF)
            hc = sess._hop_cap()
            # the conversion LPEngine.repair applies: None / <= 0 = uncapped
            caps.append(0x7FFFFFFF if hc is None or hc <= 0 else int(hc))
            ns.append(g.n)
            Us.append(sess._lmax())
            t_ids = np.unique(np.concatenate([net_u, net_v]).astype(np.int64))
            t_list.append(t_ids[(t_ids >= 0) & (t_ids < g.n)])
        Tb = pow2(max(max(t.size, 8) for t in t_list))
        tp = np.empty((T, Tb), np.int64)
        for i, t_ids in enumerate(t_list):
            tp[i] = ns[i]
            tp[i, : t_ids.size] = t_ids
        src_s = torch.stack([a.src for a in ars])
        dst_s = torch.stack([a.dst for a in ars])
        ew_s = torch.stack([a.ew for a in ars])
        nwa_s = torch.stack([a.nw_arena for a in ars])
        ip_s = torch.stack([g.indptr for _, _, g, _, _ in members])
        lab_s = torch.stack([m[1].labels for m in members])
        n_d = torch.tensor(ns, dtype=torch.int64, device=dev)
        note(("gexpand", T, Tb, Mb, ipb, A))
        masks = expand_region_device(
            torch.from_numpy(tp).to(dev), src_s, dst_s, ip_s, ns, hops, caps, A=A
        )
        masks_np = masks.cpu().numpy()
        # ---- region pack per lane, padded to shared (Cb, Npack, Eb) ----
        orders = [
            np.random.default_rng(seeds[i]).permutation(
                np.flatnonzero(masks_np[i, : ns[i]])).astype(np.int64)
            for i in range(T)
        ]
        R = max(max(o.size for o in orders), 1)
        opad = np.zeros((T, R), np.int64)
        for i, o in enumerate(orders):
            opad[i, : o.size] = o
        o_d = torch.from_numpy(opad).to(dev)
        deg_all = (ip_s.gather(1, o_d + 1) - ip_s.gather(1, o_d)).cpu().numpy()
        plans = []
        E_need, C_need = 0, 1
        for i, o in enumerate(orders):
            nodes, node_valid, C, N, E = plan_region_pack(
                deg_all[i, : o.size], o, ns[i], max_nodes=Npack,
                max_edges=e_req, block=pblock,
            )
            plans.append((nodes, node_valid, C, N, o.size))
            E_need = max(E_need, E)
            C_need = max(C_need, C)
        Cb = pow2(C_need)
        Eb = max(self._bucket_E.get(gkey, 0), -(-E_need // 512) * 512)
        self._bucket_E[gkey] = Eb
        nodes_b = np.empty((T, Cb, Npack), np.int64)
        nv_b = np.zeros((T, Cb, Npack), bool)
        nchunks = []
        for i, (nodes, node_valid, C, N, _) in enumerate(plans):
            nodes_b[i] = ns[i]
            nodes_b[i, :C, :N] = nodes
            nv_b[i, :C, :N] = node_valid
            nchunks.append(C)
        nodes_d = torch.from_numpy(nodes_b).to(dev)
        nv_d = torch.from_numpy(nv_b).to(dev)
        note(("ggather", T, Cb, Npack, ipb, Mb, Eb))
        ed, ew_p, es, ev = gather_pack_device(
            nodes_d, nv_d, ip_s, dst_s, ew_s, n_d, E=Eb
        )
        # ---- sweep + gain + balance, all lanes at once ----
        bw0 = block_weights_dense(lab_s, nwa_s, Kb)
        w0 = bw0.clone()
        w0[:, Kb - 1] = float("inf")
        note(("gsweep", T, Cb, Npack, Eb, A, Kb, iters))
        out, _, _ = lp_sweep_batched(
            nodes_d, nv_d, ed, ew_p, es, ev, lab_s, w0, nwa_s,
            torch.zeros(1, dtype=torch.int32, device=dev), Us, seeds, k, nchunks,
            iters=iters, refine_mode=True, use_restrict=False, permute_chunks=True,
        )
        for r in range(gain_rounds):
            note(("ggain", T, A, Mb, Kb))
            out = gain_round_device(
                src_s, dst_s, ew_s, nwa_s, out, masks, ns, k, Us,
                [hash_base_u32(s, r, TAG_DYN_GAIN) for s in seeds],
                [hash_base_u32(s, r, TAG_DYN_GAIN_GATE) for s in seeds], Kb=Kb,
            )
        if balance_rounds:
            note(("gbal", T, A, Kb, balance_rounds))
            out = balance_rounds_device(
                nwa_s, out, masks, ns, k, Us, [s & 0x7FFFFFFF for s in seeds],
                Kb=Kb, rounds=balance_rounds,
            )
        # ---- guard per lane (the solo guard, batched) ----
        note(("gscore", T, Mb, A, Kb))
        bw_o = block_weights_dense(out, nwa_s, Kb)
        scal = torch.cat([
            cut_from_arcs(lab_s, src_s, dst_s, ew_s)[:, None],
            cut_from_arcs(out, src_s, dst_s, ew_s)[:, None],
            (ew_s.sum(dim=1) / 2.0)[:, None], bw0, bw_o,
        ], dim=1).to(torch.float64).cpu().numpy()
        cut_i, cut_o, ews = scal[:, 0], scal[:, 1], scal[:, 2]
        bw0_np, bw_o_np = scal[:, 3:3 + Kb], scal[:, 3 + Kb:]
        ok = np.empty(T, bool)
        for i in range(T):
            U = Us[i]
            bw_old_max = bw0_np[i, :k].max()
            bw_new_max = bw_o_np[i, :k].max()
            ok_cut = (
                cut_o[i] <= cut_i[i]
                and bw_new_max <= max(bw_old_max, U + 1e-6)
            )
            ok[i] = ok_cut or (bw_old_max > U >= bw_new_max)
        final = torch.where(torch.from_numpy(ok).to(dev)[:, None], out, lab_s)
        # ---- write back + trajectory + escalation per lane ----
        for i, (name, sess, g, _, _) in enumerate(members):
            sess.labels = final[i]
            self.stats.lanes_repaired += 1
            cut = float(cut_o[i] if ok[i] else cut_i[i])
            bw = (bw_o_np if ok[i] else bw0_np)[i, :sess.k]
            W = max(sess.store.total_node_weight, 1e-9)
            imb = float(bw.max() * sess.k / W - 1.0)
            feas = bool(bw.max() <= Us[i] + 1e-6)
            scaled_ref = sess._cut_ref * (max(ews[i], 1e-9) / sess._ew_ref)
            wanted = (not feas) or (
                cut > sess.cfg.escalate_cut_ratio * max(scaled_ref, 1.0)
            )
            escalated = wanted and not sess.suppress_escalation
            stale = wanted and sess.suppress_escalation
            if stale:
                sess.suppressed_escalations += 1
            if escalated:
                sess._escalate(seeds[i])
                cut, imb, feas = sess._score(sess.store.base)
            res = UpdateResult(
                step=sess._step, n=sess.store.n, m=sess.store.m, cut=cut,
                imbalance=imb, feasible=feas, region_size=int(plans[i][4]),
                escalated=escalated, stale=stale, t_mono=time.monotonic(),
            )
            sess.updates_applied += 1
            sess.trajectory.append(res)
            results[name] = res

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
