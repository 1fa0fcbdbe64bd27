"""The V-cycle's final balance repair on the device engine: its CPU twin
(the prelude in torch ops, then the plain walk over the candidates) equals
:func:`repro_torch.core.initial_partition.repair_balance` label for label,
and ``partition()`` takes it only under the exact-weight gate."""

import numpy as np
import pytest
import torch

from _torch_finish import CASES, make_case
from repro_torch.core import LPEngine, PartitionerConfig, partition, repair_balance
from repro_torch.core.metrics import cut_np
from repro_torch.graph import rmat
from repro_torch.graph.csr import GraphNP
from repro_torch.kernels.balance import repair_balance_walk

torch.set_num_threads(1)
CPU = "cpu"


@pytest.mark.parametrize("name", list(CASES))
def test_twin_equals_repair_balance(name):
    g, lab, k, L = make_case(name)
    want = repair_balance(g, lab, k, L)
    eng = LPEngine(g, device=CPU)
    arena = eng.to_arena(lab, g.n, fill=k)
    got, moved = eng.repair_balance(g, arena, k, L)
    np.testing.assert_array_equal(got[: g.n].numpy(), want)
    assert (got[g.n:] == k).all()
    assert int(moved) == np.count_nonzero(want != lab)
    assert eng.stats.finish_device == 1
    # the finish's cut, on the repaired arena labels
    assert eng.cut(g, got) == cut_np(g, want)
    if CASES[name][2] is None:
        assert got is arena and int(moved) == 0
    else:
        assert int(moved) > 0
        assert (arena[: g.n].numpy() == lab).all()   # the input is not written


def test_walk_on_a_hand_made_input():
    """The walk's own contract on a hand-made input: the lightest block
    takes each move, ties go to the lowest index, a node that fits nowhere
    is skipped, a block at L is not above it, and the inputs are not
    written."""
    bw = torch.tensor([9.0, 2.0, 2.0], dtype=torch.float64)
    labels = torch.tensor([0, 0, 0, 0, 1, 2], dtype=torch.int32)
    cand = torch.tensor([3, 0, 1, 2], dtype=torch.int64)
    nw = torch.tensor([4.0, 1.0, 1.0, 2.0], dtype=torch.float32)
    out, moved = repair_balance_walk(cand, labels[cand], nw, labels, bw, 5.0)
    # node 3 (weight 4) fits nowhere (2 + 4 > 5); node 0 -> block 1 (the
    # first of two lightest), node 1 -> block 2, node 2 -> block 1 (3 + 2
    # reaches L exactly), which brings block 0 down to L
    assert out.tolist() == [1, 2, 1, 0, 1, 2]
    assert int(moved) == 3
    # the block weights the moves leave: each candidate's weight leaves its
    # old block and joins its new one
    x = nw.double()
    bw_out = bw.clone().index_add_(0, labels[cand].long(), -x).index_add_(
        0, out[cand].long(), x)
    assert bw_out.tolist() == [5.0, 5.0, 3.0]
    assert labels.tolist() == [0, 0, 0, 0, 1, 2] and bw.tolist() == [9.0, 2.0, 2.0]


def test_host_finish_off_the_gate():
    """Non-integral edge weights fail the exact-weight gate, the only one
    (any k passes): the finish stays on the host and still counts its
    moves."""
    g = rmat(10, 8, seed=3)
    # symmetric weights: the weight of arc (u, v) follows min(u, v), max(u, v)
    src = g.arc_sources()
    lo, hi = np.minimum(src, g.indices), np.maximum(src, g.indices)
    ew = np.where((lo + hi) % 2 == 0, 1.5, 1.0).astype(np.float32)
    gf = GraphNP(indptr=g.indptr, indices=g.indices, ew=ew, nw=g.nw)
    cfg = dict(k=8, preset="fast", refine_engine="dense", dense_min_n=256,
               numpy_below=256, coarsest_factor=50, evo_engine="host", seed=0)
    rep = partition(gf, PartitionerConfig(**cfg), device=CPU)
    assert rep.feasible
    assert rep.engine_stats["finish_device"] == 0
    assert rep.engine_stats["finish_moved"] > 0
    assert LPEngine(g, device=CPU).can_finish_device()
    assert not LPEngine(gf, device=CPU).can_finish_device()
