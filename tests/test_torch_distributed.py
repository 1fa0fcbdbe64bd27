"""Port parity for the distributed path: repro_torch's shard_graph,
build_plan, distributed SCLaP sweeps, distributed contraction,
partition(engine="dist") and the island-sharded batched GA return the
reference's arrays and labels bit for bit (integral weights).

The reference side runs once per module, in two subprocesses with 8 host
devices each (its ``shard_map`` needs them), which write every output to
``.npz`` files; the port runs here on the CPU with ``devices=["cpu"] * D``.
The port-only tests come first, so that they run while the reference's
subprocesses do.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.graph as R

from _subproc import SRC
from repro_torch.core import LPEngine, PartitionerConfig, contract, partition
from repro_torch.core import distributed_lp as TD
from repro_torch.core import engine as TE
from repro_torch.core.evolutionary import EvoConfig
from repro_torch.core.metrics import lmax
from repro_torch.graph import from_reference, shard_graph
from repro_torch.kernels.lp_score import threefry
from repro_torch.launch import make_mesh

torch.set_num_threads(1)

PLAN_FIELDS = ("ch_nodes", "ch_edge_dst", "ch_edge_w", "ch_edge_slot",
               "ch_edge_valid", "ch_node_valid")
PLAN_GRAPHS = {
    "rmat": lambda: R.rmat(12, 8, seed=2),
    "mesh": lambda: R.mesh2d(64),
    "ba": lambda: R.barabasi_albert(3000, 4, seed=1),
}
PART_CASES = {
    "ba8192": (lambda: R.barabasi_albert(8192, 6, seed=3),
               dict(k=2, preset="minimal", coarsest_factor=100, seed=0)),
    "rmat": (lambda: R.rmat(12, 8, seed=2), dict(k=4, preset="fast", seed=0)),
}
GA_CFG = dict(k=2, islands=4, pop_per_island=2, generations=3, refine_iters=3,
              seed=5)

# the reference's outputs, computed by two subprocesses side by side (the
# sweeps and the end-to-end runs), each writing one .npz; the inputs that
# are not generated from a seed come in through ``inputs.npz``
REF_HEAD = """
import numpy as np
import repro.graph as R
from repro.core import LPEngine, PartitionerConfig, partition
from repro.core.distributed_lp import (build_plan, contract_distributed,
    lp_cluster_distributed, lp_refine_distributed)
from repro.core.evolutionary import EvoConfig
from repro.core.metrics import lmax

inp = np.load(DIR + "/inputs.npz")
out = {}
"""
REF_SWEEPS = """
graphs = {"rmat": R.rmat(12, 8, seed=2), "mesh": R.mesh2d(64),
          "ba": R.barabasi_albert(3000, 4, seed=1)}
for name, g in graphs.items():
    for P in (1, 3, 8):
        for order in ("degree", "random"):
            plan = build_plan(g, P, chunks_per_shard=4, order=order, seed=0)
            for f in PLAN_FIELDS:
                out[f"{name}_{P}_{order}_{f}"] = getattr(plan, f)
            for f, v in vars(plan.sg).items():
                out[f"{name}_{P}_{order}_sg_{f}"] = np.asarray(v)

g = graphs["rmat"]
out["cluster"] = lp_cluster_distributed(build_plan(g, 8, chunks_per_shard=4),
                                        U=lmax(g.n, 2, 0.03) / 14, iters=3, seed=1)
gm = graphs["mesh"]
out["refine"] = lp_refine_distributed(
    build_plan(gm, 8, chunks_per_shard=4, order="random"), inp["noisy"], k=2,
    U=lmax(gm.n, 2, 0.03), iters=6, seed=0)
gb = graphs["ba"]
out["node0"] = lp_cluster_distributed(build_plan(gb, 8, chunks_per_shard=4),
                                      U=lmax(gb.n, 2, 0.03) / 14, iters=3, seed=1)

gc = R.rmat(11, 8, seed=7)
coarse, cmap = contract_distributed(build_plan(gc, 8), inp["clabels"])
for f in ("indptr", "indices", "ew", "nw"):
    out[f"contract_{f}"] = getattr(coarse, f)
out["contract_C"] = cmap
# shards of 375 nodes padded to 376: the reference's ghost read is shifted
coarse, _ = contract_distributed(build_plan(gb, 8), inp["clabels_ba"])
out["contract_ba_m"] = np.int64(coarse.m)
np.savez(DIR + "/sweeps.npz", **out)
"""
REF_RUNS = """
cases = {"ba8192": (R.barabasi_albert(8192, 6, seed=3),
                    dict(k=2, preset="minimal", coarsest_factor=100, seed=0)),
         "rmat": (R.rmat(12, 8, seed=2), dict(k=4, preset="fast", seed=0))}
for name, (g, kw) in cases.items():
    rep = partition(g, PartitionerConfig(engine="dist", dist_shards=8, **kw))
    out[f"part_{name}_labels"] = rep.labels
    out[f"part_{name}_cut"] = np.float64(rep.cut)
    out[f"part_{name}_level_sizes"] = np.array(rep.level_sizes)
    out[f"part_{name}_cycle_cuts"] = np.array(rep.cycle_cuts)

gp = R.planted_partition(600, 6, p_in=0.05, p_out=0.004, seed=1)
cfg = EvoConfig(Lmax=lmax(gp.n, 2, 0.03), **GA_CFG)
out["ga"] = np.asarray(LPEngine(gp, seed=0).evolve_device(gp, cfg))
np.savez(DIR + "/runs.npz", **out)
"""


def _noisy_mesh_labels():
    """test_distributed's refinement input: mesh2d(64)'s two halves with
    15 % of the labels flipped."""
    side = 64
    truth = (np.arange(side * side) // side >= side // 2).astype(np.int32)
    noisy = truth.copy()
    noisy[np.random.default_rng(0).random(side * side) < 0.15] ^= 1
    return noisy


def _contract_labels(n):
    return np.random.default_rng(0).integers(0, 300, n)


class _Reference:
    """The reference's outputs, computed in background subprocesses with 8
    host devices while the port-only tests run; :meth:`get` waits."""

    def __init__(self, d):
        np.savez(d / "inputs.npz", noisy=_noisy_mesh_labels(),
                 clabels=_contract_labels(R.rmat(11, 8, seed=7).n),
                 clabels_ba=_contract_labels(3000))
        head = f"PLAN_FIELDS = {PLAN_FIELDS!r}\nGA_CFG = {GA_CFG!r}\nDIR = {str(d)!r}\n"
        env = dict(os.environ, PYTHONPATH=SRC,
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
        self.dir = d
        self.jobs = []
        for name, body in (("sweeps", REF_SWEEPS), ("runs", REF_RUNS)):
            log = open(d / f"{name}.log", "w+")
            proc = subprocess.Popen([sys.executable, "-c", head + REF_HEAD + body],
                                    env=env, stdout=log, stderr=subprocess.STDOUT)
            self.jobs.append((name, proc, log))
        self.out = None

    def get(self) -> dict:
        if self.out is None:
            out = {}
            for name, proc, log in self.jobs:
                rc = proc.wait(timeout=900)
                log.seek(0)
                assert rc == 0, f"reference subprocess {name} failed:\n{log.read()}"
                with np.load(self.dir / f"{name}.npz") as z:
                    out.update(z)
            self.out = out
        return self.out

    def close(self):
        for _, proc, log in self.jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    r = _Reference(tmp_path_factory.mktemp("dist_ref"))
    yield r
    r.close()


def _port(gr):
    return from_reference(gr.indptr, gr.indices, gr.ew, gr.nw)


def _cpus(D):
    return ["cpu"] * D


# --------------------------------------------------------------------------
# port-only checks (they run while the reference's subprocesses do)
# --------------------------------------------------------------------------


def test_plan_cache_hits_refreshes_and_evicts():
    """build_plan returns the cached plan for the same graph object and
    key, refreshes it on a hit, evicts first-in beyond 8 entries and drops
    the entries of a collected graph."""
    TD._PLAN_CACHE.clear()
    g = _port(R.mesh2d(16))
    a = TD.build_plan(g, 2, chunks_per_shard=2, seed=0)
    assert TD.build_plan(g, 2, chunks_per_shard=2, seed=0) is a
    assert TD.build_plan(g, 2, chunks_per_shard=2, seed=1) is not a
    # 7 more keys: 9 in all, so the oldest but refreshed entry survives
    # while the seed-1 entry (now oldest) is evicted
    for P in range(3, 10):
        if P == 5:
            assert TD.build_plan(g, 2, chunks_per_shard=2, seed=0) is a
        TD.build_plan(g, P, chunks_per_shard=2, seed=0)
    assert len(TD._PLAN_CACHE) == TD._PLAN_CACHE_CAP
    assert TD.build_plan(g, 2, chunks_per_shard=2, seed=0) is a
    assert (id(g), 2, 2, "degree", 1) not in TD._PLAN_CACHE
    # an equal graph that is another object misses
    g2 = _port(R.mesh2d(16))
    assert TD.build_plan(g2, 2, chunks_per_shard=2, seed=0) is not a
    del g, a
    import gc

    gc.collect()
    TD.build_plan(g2, 3, chunks_per_shard=2, seed=0)
    assert all(v[0]() is g2 for v in TD._PLAN_CACHE.values())
    TD._PLAN_CACHE.clear()


def test_make_mesh_assigns_pes_cyclically():
    mesh = make_mesh(5, ["cpu", "meta"])
    assert [d.type for d in mesh] == ["cpu", "meta", "cpu", "meta", "cpu"]
    assert make_mesh(3, ["cpu"]) == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        make_mesh(0, ["cpu"])
    with pytest.raises(ValueError):
        make_mesh(2, [])


# --------------------------------------------------------------------------
# PRNG
# --------------------------------------------------------------------------


@pytest.mark.parametrize("lo,hi", [(0.0, 0.49), (-1.5, 2.25), (0.0, 1.0)])
def test_split_and_uniform_match_jax_random(lo, hi):
    """split and uniform(minval, maxval) equal jax.random bit for bit
    (partitionable threefry), over a chain of splits as the sweep draws."""
    import jax
    import jax.numpy as jnp

    jkey = jax.random.fold_in(jax.random.PRNGKey(123), 5)
    key = threefry.fold_in(threefry.prng_key(123), 5)
    for _ in range(4):
        jkey, jsub = jax.random.split(jkey)
        key, sub = threefry.split(key)
        assert tuple(int(x) for x in np.asarray(jkey)) == key
        assert tuple(int(x) for x in np.asarray(jsub)) == sub
        want = np.asarray(jax.random.uniform(jsub, (4099,), jnp.float32, lo, hi))
        got = threefry.uniform(sub, (4099,), "cpu", lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_contract_arcs_matches_host_dedup():
    """One shard's quotient dedup: the distinct (cu, cv) pairs in order
    with their summed weights; self arcs and invalid arcs dropped."""
    from repro_torch.core.contraction import contract_arcs

    rng = np.random.default_rng(3)
    E, n_c = 500, 40
    cu = rng.integers(0, n_c, E)
    cv = rng.integers(0, n_c, E)
    w = rng.integers(1, 5, E).astype(np.float32)
    valid = rng.random(E) < 0.8
    out = contract_arcs(*(torch.from_numpy(x) for x in (cu, cv, w, valid)), n_c)
    cu2, cv2, w2, v2 = (t.numpy() for t in out)
    ok = valid & (cu != cv)
    pairs = {}
    for a, b, x in zip(cu[ok], cv[ok], w[ok]):
        pairs[(a, b)] = pairs.get((a, b), 0.0) + x
    keys = sorted(pairs)
    assert v2.sum() == len(keys) and v2[: len(keys)].all()
    np.testing.assert_array_equal(cu2[v2], [a for a, _ in keys])
    np.testing.assert_array_equal(cv2[v2], [b for _, b in keys])
    np.testing.assert_array_equal(w2[v2], np.float32([pairs[q] for q in keys]))
    assert (w2[~v2] == 0).all()


def test_partition_evo_shard_islands_matches_unsharded(monkeypatch):
    """partition(evo_shard_islands=True) over two mesh entries equals the
    unsharded run at the eco preset (generations > 0, 4 islands)."""
    calls = []
    real = TE.evo_generation_step_sharded
    monkeypatch.setattr(TE, "evo_generation_step_sharded",
                        lambda Gs, *a: calls.append(len(Gs)) or real(Gs, *a))
    g = _port(R.planted_partition(300, 4, p_in=0.08, p_out=0.005, seed=1))
    reps, shards = [], []
    for kw in ({}, {"evo_shard_islands": True}):
        calls.clear()
        reps.append(partition(g, PartitionerConfig(k=2, preset="eco", seed=0, **kw),
                              device="cpu", devices=_cpus(2)))
        shards.append(list(calls))
    steps = reps[1].engine_stats["evo_calls"] - 5
    assert steps > 0 and shards == [[1] * steps, [2] * steps]
    np.testing.assert_array_equal(reps[0].labels, reps[1].labels)
    assert reps[0].cycle_cuts == reps[1].cycle_cuts
    assert reps[0].engine_stats["evo_calls"] == reps[1].engine_stats["evo_calls"]


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_ga_gossip_crosses_shards(D):
    """A case whose result depends on the gossip reaching across shards
    (barabasi_albert(1000, 3), k=4, 4 generations): islands split over D
    mesh entries still give the unsharded labels, which equal the numpy
    oracle's."""
    g = _port(R.barabasi_albert(1000, 3, seed=2))
    cfg = EvoConfig(k=4, Lmax=lmax(g.n, 4, 0.03), islands=4, pop_per_island=2,
                    generations=4, refine_iters=3, seed=5)
    eng = LPEngine(g, seed=0, device="cpu")
    single = eng.evolve_device(g, cfg).numpy()
    np.testing.assert_array_equal(single, eng.evolve_oracle(g, cfg))
    sharded = LPEngine(g, seed=0, device="cpu").evolve_device(
        g, cfg, shard=True, devices=_cpus(D)).numpy()
    np.testing.assert_array_equal(sharded, single)


def test_dist_entry_points_need_cuda_by_default():
    """With devices=None the mesh is every CUDA device: without one, every
    distributed entry point raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh is valid here")
    g = _port(R.mesh2d(16))
    plan = TD.build_plan(g, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.lp_cluster_distributed(plan, U=10.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.lp_refine_distributed(plan, np.zeros(g.n, np.int64), k=2, U=200.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.contract_distributed(plan, np.arange(g.n))
    with pytest.raises(RuntimeError, match="CUDA"):
        partition(g, PartitionerConfig(k=2, engine="dist", dist_shards=2))


# --------------------------------------------------------------------------
# against the reference: host planning
# --------------------------------------------------------------------------


@pytest.mark.parametrize("order", ["degree", "random"])
@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(PLAN_GRAPHS))
def test_shard_graph_and_build_plan_match_reference(ref, name, P, order):
    """Every field of the plan and of its ShardedGraph equals the
    reference's, dtype included (P = 3 does not divide n)."""
    g = _port(PLAN_GRAPHS[name]())
    plan = TD._build_plan_impl(g, P, 4, order, 0)
    for f in PLAN_FIELDS:
        want = ref.get()[f"{name}_{P}_{order}_{f}"]
        got = getattr(plan, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    sg = shard_graph(g, P)
    for f, v in vars(plan.sg).items():
        want = ref.get()[f"{name}_{P}_{order}_sg_{f}"]
        got = np.asarray(v)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
        np.testing.assert_array_equal(np.asarray(getattr(sg, f)), got, err_msg=f)


# --------------------------------------------------------------------------
# the distributed sweeps
# --------------------------------------------------------------------------


@pytest.mark.parametrize("D", [1, 3, 8])
def test_lp_cluster_distributed_matches_reference(ref, D):
    """test_distributed's clustering case at P = 8: the same labels with
    the 8 PEs on 1, 3 or 8 devices (placement does not change results)."""
    g = _port(R.rmat(12, 8, seed=2))
    plan = TD.build_plan(g, 8, chunks_per_shard=4)
    got = TD.lp_cluster_distributed(plan, U=lmax(g.n, 2, 0.03) / 14, iters=3, seed=1,
                                    devices=_cpus(D))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref.get()["cluster"])
    assert np.unique(got).size < g.n / 2      # clustering merges


@pytest.mark.parametrize("D", [1, 3, 8])
def test_lp_refine_distributed_matches_reference(ref, D):
    """test_distributed's refinement case (noisy halves of mesh2d(64)):
    labels equal the reference's on every placement, exact psum weights."""
    g = _port(R.mesh2d(64))
    plan = TD.build_plan(g, 8, chunks_per_shard=4, order="random")
    noisy = _noisy_mesh_labels()
    got = TD.lp_refine_distributed(plan, noisy, k=2, U=lmax(g.n, 2, 0.03), iters=6,
                                   seed=0, devices=_cpus(D))
    np.testing.assert_array_equal(got, ref.get()["refine"])
    assert (got != noisy).sum() > 0


def test_padded_chunk_keeps_local_node_zero(ref):
    """The reference's duplicate-index write: PE 3 of barabasi_albert(3000,
    4) sweeps its local node 0 in a chunk with padding, whose pad slots
    write node 0's old label back, so that node never moves — in both
    packages — while every other PE's node 0 with edges does, and the port
    equals the reference everywhere.  The shards hold 375 nodes padded to
    376, so the reference's shifted ghost read is reproduced here too."""
    g = _port(R.barabasi_albert(3000, 4, seed=1))
    plan = TD.build_plan(g, 8, chunks_per_shard=4)
    got = TD.lp_cluster_distributed(plan, U=lmax(g.n, 2, 0.03) / 14, iters=3, seed=1,
                                    devices=_cpus(2))
    np.testing.assert_array_equal(got, ref.get()["node0"])
    sg = plan.sg
    assert (sg.n_local < sg.max_local).all()
    for p in range(8):
        c = int(np.flatnonzero((plan.ch_nodes[p] == 0).any(axis=1))[0])
        padded = not plan.ch_node_valid[p, c].all()
        a = int(sg.range_start[p])
        assert padded == (p == 3), p
        for labels in (got, ref.get()["node0"]):
            assert (labels[a] == a) == (p == 3), p


def test_contract_distributed_matches_reference_and_host(ref):
    gr = R.rmat(11, 8, seed=7)
    g = _port(gr)
    labels = _contract_labels(g.n)
    got, C = TD.contract_distributed(TD.build_plan(g, 8), labels, devices=_cpus(3))
    host, C_host = contract(g, labels)
    np.testing.assert_array_equal(C, ref.get()["contract_C"])
    np.testing.assert_array_equal(C, C_host)
    for f in ("indptr", "indices", "ew", "nw"):
        np.testing.assert_array_equal(getattr(got, f), ref.get()[f"contract_{f}"], err_msg=f)
        np.testing.assert_array_equal(getattr(got, f), getattr(host, f), err_msg=f)


def test_contract_distributed_reads_ghosts_where_they_are(ref):
    """On shards whose node count is not a multiple of 8 (barabasi_albert(
    3000, 4) on 8 PEs: 375 nodes padded to 376) the port's distributed
    contraction still equals the host contract; the reference's reads each
    ghost's coarse id one place off and returns another arc count."""
    g = _port(R.barabasi_albert(3000, 4, seed=1))
    labels = _contract_labels(g.n)
    plan = TD.build_plan(g, 8)
    assert (plan.sg.n_local < plan.sg.max_local).all()
    got, C = TD.contract_distributed(plan, labels, devices=_cpus(2))
    host, C_host = contract(g, labels)
    np.testing.assert_array_equal(C, C_host)
    for f in ("indptr", "indices", "ew", "nw"):
        np.testing.assert_array_equal(getattr(got, f), getattr(host, f), err_msg=f)
    assert int(ref.get()["contract_ba_m"]) != host.m


# --------------------------------------------------------------------------
# partition(engine="dist")
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(PART_CASES))
def test_partition_dist_matches_reference(ref, case):
    """partition(engine="dist", dist_shards=8): labels, cut, level sizes
    and cycle cuts of the reference.  ba8192 is test_distributed's
    end-to-end case; rmat(12, 8) at the fast preset takes the restricted
    engine clustering in its second V-cycle."""
    make, kw = PART_CASES[case]
    g = _port(make())
    got = partition(g, PartitionerConfig(engine="dist", dist_shards=8, **kw),
                    device="cpu", devices=_cpus(8))
    np.testing.assert_array_equal(got.labels, ref.get()[f"part_{case}_labels"])
    assert got.cut == float(ref.get()[f"part_{case}_cut"])
    assert got.level_sizes == [tuple(x) for x in ref.get()[f"part_{case}_level_sizes"].tolist()]
    assert got.cycle_cuts == ref.get()[f"part_{case}_cycle_cuts"].tolist()
    assert got.feasible
    assert got.engine_stats["evo_calls"] == 0           # host GA, as the reference
    assert len(got.level_sizes) > 1


# --------------------------------------------------------------------------
# the island-sharded GA
# --------------------------------------------------------------------------


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_ga_matches_unsharded_reference_and_oracle(ref, D, monkeypatch):
    """test_evo_device's sharding case: islands split over D mesh entries
    give the unsharded labels, the reference's and the numpy oracle's."""
    calls = []
    real = TE.evo_generation_step_sharded
    monkeypatch.setattr(TE, "evo_generation_step_sharded",
                        lambda Gs, *a: calls.append(len(Gs)) or real(Gs, *a))
    g = _port(R.planted_partition(600, 6, p_in=0.05, p_out=0.004, seed=1))
    cfg = EvoConfig(Lmax=lmax(g.n, 2, 0.03), **GA_CFG)
    eng = LPEngine(g, seed=0, device="cpu")
    single = eng.evolve_device(g, cfg).numpy()
    G = GA_CFG["generations"]
    assert calls == [1] * G
    sharded = LPEngine(g, seed=0, device="cpu").evolve_device(
        g, cfg, shard=True, devices=_cpus(D)).numpy()
    assert calls == [1] * G + [D] * G
    np.testing.assert_array_equal(sharded, single)
    np.testing.assert_array_equal(single, ref.get()["ga"])
    np.testing.assert_array_equal(single, eng.evolve_oracle(g, cfg))
