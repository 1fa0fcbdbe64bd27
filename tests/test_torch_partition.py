"""Port parity end to end: repro_torch.core.partition on the CPU returns the
labels, cut, level sizes and per-cycle cuts of repro.core.partition with
the host GA and with the default evo_engine="auto" (the batched device GA
wherever the reference picks it), for dense and chunked refinement."""

import numpy as np
import pytest
import torch

import repro.graph as R
from repro.core import PartitionerConfig as RefConfig
from repro.core import partition as ref_partition

from repro_torch.core import PartitionerConfig, partition
from repro_torch.graph import from_reference

torch.set_num_threads(1)


def _graph(case):
    return {
        "rmat": lambda: R.rmat(11, 8, seed=1),
        "planted": lambda: R.planted_partition(4096, 8, p_in=0.02, p_out=0.0005, seed=2),
        "mesh": lambda: R.mesh2d(32),
    }[case]()


# dense_min_n / numpy_below lowered so small graphs run dense rounds on the
# device engine and still hand their coarsest levels to the numpy engine
CASES = [
    ("rmat", "dense", 4, dict(dense_min_n=600, numpy_below=600, coarsest_factor=100)),
    ("rmat", "chunked", 4, dict(numpy_below=600, coarsest_factor=100)),
    # this graph does not contract (first-cycle clusters stall), so the host
    # GA sees all 4096 nodes: one individual keeps it short
    ("planted", "dense", 4, dict(dense_min_n=2048, coarsest_factor=100,
                                 islands=1, pop_per_island=1)),
    ("mesh", "dense", 8, dict(dense_min_n=256, numpy_below=256, coarsest_factor=20)),
    ("mesh", "chunked", 2, dict(numpy_below=256, coarsest_factor=50)),
]


def _check(gr, kw):
    want = ref_partition(gr, RefConfig(**kw))
    got = partition(from_reference(gr.indptr, gr.indices, gr.ew, gr.nw),
                    PartitionerConfig(**kw), device="cpu")
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.cut == want.cut
    assert got.level_sizes == want.level_sizes
    assert got.cycle_cuts == want.cycle_cuts
    assert got.feasible == want.feasible
    assert got.engine_stats["dense_rounds"] == want.engine_stats["dense_rounds"]
    assert got.engine_stats["evo_calls"] == want.engine_stats["evo_calls"]
    return got


@pytest.mark.parametrize("case,refine,k,extra", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_partition_matches_reference(case, refine, k, extra):
    kw = dict(k=k, preset="fast", refine_engine=refine, evo_engine="host", seed=0,
              **extra)
    got = _check(_graph(case), kw)
    assert got.feasible
    if refine == "dense":
        assert got.engine_stats["dense_rounds"] > 0
    else:
        assert got.engine_stats["dense_rounds"] == 0


AUTO_CASES = [c for c in CASES if (c[0], c[1]) in {("rmat", "dense"), ("mesh", "chunked")}]


@pytest.mark.parametrize("case,refine,k,extra", AUTO_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in AUTO_CASES])
def test_partition_default_evo_engine_matches_reference(case, refine, k, extra):
    """The default evo_engine="auto" picks the reference's GA: the batched
    device GA on these integral graphs, in both V-cycles."""
    kw = dict(k=k, preset="fast", refine_engine=refine, seed=0, **extra)
    got = _check(_graph(case), kw)
    assert got.feasible
    assert got.engine_stats["evo_calls"] == 2


# k = 16 on this graph leaves the finest labels infeasible in both V-cycles,
# so the device finish moves nodes
FINISH_CASES = [("rmat", "dense", 16, dict(dense_min_n=600, numpy_below=600,
                                           coarsest_factor=100))]


@pytest.mark.parametrize("case,refine,k,extra", FINISH_CASES,
                         ids=[f"{c[0]}-{c[1]}-k{c[2]}" for c in FINISH_CASES])
def test_partition_device_finish_matches_reference(case, refine, k, extra):
    """The finish repairs balance and cuts on the device engine (the finest
    labels never leave it before the repair) and still returns the
    reference's labels and cuts."""
    kw = dict(k=k, preset="fast", refine_engine=refine, evo_engine="host", seed=0,
              **extra)
    got = _check(_graph(case), kw)
    assert got.feasible
    assert got.engine_stats["finish_device"] >= 1
    assert got.engine_stats["finish_moved"] > 0


def test_partition_with_initial_labels_matches_reference():
    gr = _graph("rmat")
    k = 4
    init = (np.arange(gr.n) * 2654435761 % 2**32 % k).astype(np.int64)
    kw = dict(k=k, preset="fast", refine_engine="dense", evo_engine="host", seed=1,
              dense_min_n=600, numpy_below=600, coarsest_factor=100,
              initial_labels=init)
    got = _check(gr, kw)
    assert got.cut < _hash_cut(gr, init)


def _hash_cut(gr, labels):
    src = gr.arc_sources()
    return float(gr.ew[labels[src] != labels[gr.indices]].sum() / 2)
