"""Throughput mode: overlay-aware repair, deferred compaction, multi-tenant
batched serving (PyTorch/CUDA port; twin of
``examples/partition_throughput.py``).

Three escalating configurations on the same update stream:

1. default ``SessionConfig`` — compact the overlay before every repair;
2. ``SessionConfig.throughput()`` — repair directly on the base CSR +
   overlay *view* (bit-identical labels), defer threshold compactions;
3. a ``SessionGroup`` — four independent tenants served through one
   batched repair per shape bucket.

    PYTHONPATH=src python examples/torch/partition_throughput.py [--device cuda|cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.dynamic import (
    GraphUpdate, PartitionSession, SessionConfig, SessionGroup,
)
from repro_torch.graph import barabasi_albert

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = torch.device(args.device)


def sync():
    """Wall-clock timings on the card wait for its queued work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


N, K, STEPS = 4096, 4, 8
g = barabasi_albert(N, 6, seed=3)
print(f"graph: ba n={g.n} m={g.m // 2} edges, k={K}\n")


def stream(seed):
    rng = np.random.default_rng(seed)
    nb = g.m // 2 // 200
    for _ in range(STEPS):
        u = rng.integers(0, N, nb)
        v = (u + 1 + rng.integers(0, N - 1, nb)) % N
        yield GraphUpdate.add_edges(u, v)


# ---- 1. default: compact every step --------------------------------------
sess_d = PartitionSession(g, SessionConfig(k=K, seed=0), device=dev)
for upd in stream(11):          # warm the caches out of the timing
    sess_d.update(upd)
sync()
t0 = time.time()
for upd in stream(12):
    sess_d.update(upd)
sync()
t_default = (time.time() - t0) / STEPS

# ---- 2. throughput preset: view repair + deferred compaction -------------
sess_t = PartitionSession(g, SessionConfig.throughput(k=K, seed=0), device=dev)
for upd in stream(11):
    sess_t.update(upd)
sync()
t0 = time.time()
view_steps = 0
for upd in stream(12):
    view_steps += int(sess_t.update(upd).used_view)
sync()
t_thr = (time.time() - t0) / STEPS
st = sess_t.stats()
print(f"default        : {t_default * 1e3:7.1f} ms/update "
      f"({1 / t_default:5.1f} updates/s)  cut={sess_d.cut:.0f}")
print(f"throughput     : {t_thr * 1e3:7.1f} ms/update "
      f"({1 / t_thr:5.1f} updates/s)  cut={sess_t.cut:.0f}  "
      f"[{view_steps}/{STEPS} view steps, "
      f"{st['compact_deferred']} deferred compactions]")

# ---- 3. multi-tenant: 4 sessions, one batched repair per bucket ----------
tenants = {
    f"t{i}": PartitionSession(
        barabasi_albert(1024, 6, seed=20 + i),
        SessionConfig(k=K, seed=i, repair_iters=2), device=dev,
    )
    for i in range(4)
}
group = SessionGroup(tenants)
rng = np.random.default_rng(17)


def tenant_batch():
    out = []
    for name, s in tenants.items():
        u = rng.integers(0, s.n, 24)
        v = (u + 1 + rng.integers(0, s.n - 1, 24)) % s.n
        out.append((name, GraphUpdate.add_edges(u, v)))
    return out


group.update_many(tenant_batch())       # warm the group buckets
sync()
t0 = time.time()
for _ in range(STEPS):
    group.update_many(tenant_batch())
sync()
t_group = (time.time() - t0) / STEPS / len(tenants)
gs = group.stats_dict()
print(f"group (4-way)  : {t_group * 1e3:7.1f} ms/update amortized "
      f"({1 / t_group:5.1f} updates/s/tenant)  "
      f"[{gs['lanes_repaired']} lanes, {gs['group_bucket_count']} buckets]")
