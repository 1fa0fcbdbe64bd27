"""Deployment-side partition objectives (deployment subsystem, layer 2) —
host numpy code, a copy of ``repro.deploy.metrics``.

The edge cut the partitioner optimizes is a proxy; what ParMetis-era
consumers actually pay for at serving time is **communication volume** (how
many (node, foreign block) label/feature copies cross the interconnect per
bulk-synchronous step) and **boundary size** (how many nodes participate in
the exchange at all).  This module computes those objectives two ways:

* :func:`block_comm_metrics_np` — from the global labels (the partitioner's
  view): per-block send volume (sum over owned nodes of the number of
  distinct foreign adjacent blocks), receive volume (number of distinct
  foreign nodes adjacent to the block == its 1-ring ghost count), and
  boundary-node count.  ``sum(send) == sum(recv) == comm_volume_np`` of
  ``repro.core.metrics`` by symmetry of the (node, block) incidence.
* :func:`shard_comm_metrics` — from deployed :class:`~.extract.BlockShard`
  artifacts (the consumer's view): send volume is the total send-list
  length, receive volume the ring-1 ghost count, boundary the interface
  buffer size.  At halo depth 1 both views agree exactly (tested); deeper
  halos pay proportionally more, which is precisely what the deployment
  report should surface.
"""

from __future__ import annotations

import numpy as np

from ..graph.csr import GraphNP

__all__ = ["block_comm_metrics_np", "shard_comm_metrics"]


def block_comm_metrics_np(g: GraphNP, labels: np.ndarray, k: int) -> dict:
    """Per-block exchange objectives from the global labels (1-ring)."""
    labels = np.asarray(labels[: g.n], dtype=np.int64)
    src = g.arc_sources().astype(np.int64)
    dst = g.indices.astype(np.int64)
    lab_s = labels[src]
    lab_d = labels[dst]
    foreign = lab_s != lab_d
    # boundary nodes: owned nodes with >= 1 foreign neighbour
    bnd = np.zeros(g.n, bool)
    np.logical_or.at(bnd, src[foreign], True)
    boundary = np.bincount(labels[np.flatnonzero(bnd)], minlength=k)[:k]
    # send volume: distinct (owned node, foreign block) pairs per block
    key = src[foreign] * np.int64(k + 1) + lab_d[foreign]
    uniq = np.unique(key)
    send = np.bincount(labels[uniq // (k + 1)], minlength=k)[:k]
    # recv volume: distinct (foreign node, block) pairs — arc (s, d) with
    # lab(s) = b, lab(d) != b makes d a 1-ring ghost of b
    key2 = dst[foreign] * np.int64(k + 1) + lab_s[foreign]
    recv = np.bincount(np.unique(key2) % (k + 1), minlength=k)[:k]
    return dict(
        boundary=boundary.astype(np.int64),
        send=send.astype(np.int64),
        recv=recv.astype(np.int64),
        total_volume=int(send.sum()),
        max_volume=int(send.max(initial=0)),
        total_boundary=int(boundary.sum()),
        max_boundary=int(boundary.max(initial=0)),
    )


def shard_comm_metrics(shards) -> dict:
    """The same objectives measured on deployed shard artifacts.

    Requires the exchange schedule (``assemble_schedule``).  ``send`` per
    block is the total send-list length (one entry per (owned node,
    requesting block) pair), ``recv`` the ring-1 ghost count, ``boundary``
    the interface-buffer size.  Identical to
    :func:`block_comm_metrics_np` at halo depth 1.
    """
    from .extract import BlockShard

    hosts = [s.host() if isinstance(s, BlockShard) else s for s in shards]
    k = len(hosts)
    send = np.zeros(k, np.int64)
    recv = np.zeros(k, np.int64)
    boundary = np.zeros(k, np.int64)
    for i, h in enumerate(hosts):
        if h.send_local is None:
            raise ValueError("shard has no exchange schedule; run "
                             "assemble_schedule first")
        send[i] = h.send_local.shape[0]
        recv[i] = int((h.ghost_hop == 1).sum())
        boundary[i] = h.iface_global.shape[0]
    return dict(
        boundary=boundary,
        send=send,
        recv=recv,
        total_volume=int(send.sum()),
        max_volume=int(send.max(initial=0)),
        total_boundary=int(boundary.sum()),
        max_boundary=int(boundary.max(initial=0)),
    )
