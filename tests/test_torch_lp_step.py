"""The host side of the chunk-step kernel (``repro_torch.kernels.lp_step``):
CPU tensors take the plain version, the argument block matches the
kernel's, the wrapper refuses what the kernel does not take, and every
pack the port builds keeps the layout the kernel's segment search relies
on (the kernel itself runs in ``tests/test_torch_cuda.py``)."""

import ctypes
import re

import numpy as np
import pytest
import torch

from _torch_lp_step import CASES
from repro_torch.core import LPEngine
from repro_torch.core.label_propagation import lp_sweep_batched, make_order
from repro_torch.graph import (
    gather_pack_device,
    plan_region_pack,
    rmat,
    to_device_csr,
)
from repro_torch.kernels.lp_step import ChunkStep, check_inputs
from repro_torch.kernels.lp_step.chunk_step import SOURCE, StepArgs

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["cluster_restrict", "ga", "lanes", "hub_refine"])
def test_cpu_tensors_take_the_plain_version(name):
    args, kw = CASES[name]()
    before = ChunkStep.launches
    labels, weights, moves = lp_sweep_batched(*args, **kw)
    assert ChunkStep.launches == before
    assert labels.device.type == weights.device.type == moves.device.type == "cpu"
    assert int(moves.sum()) > 0


def test_step_args_match_the_kernels_struct():
    """``StepArgs`` lists the fields of the source's ``Args`` in its order,
    a pointer where the source has one and a 64-bit integer elsewhere."""
    body = re.search(r"struct Args \{(.*?)\n\};", SOURCE.read_text(), re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if decl:
            kind, names = re.match(r"(.*?)\s*(\w+(?:\s*,\s*\w+)*)$", decl).groups()
            fields += [(n.strip(), "*" in kind or "*" in decl.split(n)[0])
                       for n in names.split(",")]
            assert "*" in kind or kind.strip() == "long long", decl
    assert [(n, t is ctypes.c_void_p) for n, t in StepArgs._fields_] == fields
    assert ctypes.sizeof(StepArgs) == 8 * len(fields)


def test_chunk_step_refuses_cpu_tensors():
    args, kw = CASES["refine"]()
    B, steps = args[6].shape[0], 4
    perm = torch.zeros((B, steps), dtype=torch.int64)
    bases = torch.zeros((kw["iters"], B, steps), dtype=torch.int64)
    with pytest.raises(ValueError, match="one CUDA device"):
        ChunkStep(args[:6], *args[6:10], torch.ones(B), perm, bases, bases, args[12],
                  refine_mode=True, use_restrict=False)


def test_check_inputs_casts_the_pack_and_refuses_what_the_kernel_cannot_take():
    args, kw = CASES["cluster_restrict"]()
    pack, (labels, weights, nw, restrict) = list(args[:6]), args[6:10]
    narrow = [t.to(torch.int32) if t.dtype == torch.int64 else t for t in pack]
    out = check_inputs(narrow, labels, weights, nw, restrict, use_restrict=True)
    assert [t.dtype for t in out] == [t.dtype for t in pack]
    assert all(torch.equal(a, b) for a, b in zip(out, pack))
    with pytest.raises(TypeError, match="labels"):
        check_inputs(pack, labels.float(), weights, nw, restrict, use_restrict=True)
    with pytest.raises(TypeError, match="float32"):
        check_inputs(pack, labels, weights.double(), nw, restrict, use_restrict=True)
    with pytest.raises(ValueError, match="restriction"):
        check_inputs(pack, labels, weights, nw, restrict[:5], use_restrict=True)
    check_inputs(pack, labels, weights, nw, restrict[:1], use_restrict=False)
    with pytest.raises(ValueError, match="node weights"):
        check_inputs(pack, labels, weights, nw[:-1], restrict, use_restrict=True)
    with pytest.raises(ValueError, match="pack"):
        check_inputs([pack[0][None]] + pack[1:], labels, weights, nw, restrict,
                     use_restrict=True)


def _warp_first(lo: int, hi: int, pred) -> int:
    """The kernel's ``warp_first``, lane by lane: the first index in [lo,
    hi) where the monotone ``pred`` holds, else hi."""
    while lo < hi:
        step = (hi - lo + 31) // 32
        hits = [q >= hi or pred(q) for q in (lo + lane * step for lane in range(32))]
        if hits[0]:
            return lo
        if not any(hits):
            lo += 31 * step + 1
            continue
        f = hits.index(True)
        hi = min(hi, lo + f * step)
        lo += (f - 1) * step + 1
    return lo


def _assert_segments(nodes, node_valid, edge_src_slot, edge_valid, chunks=None):
    """In each chunk the valid arcs are a prefix with non-decreasing slots,
    and the kernel's two searches find each valid slot's arcs exactly."""
    slot_all, valid_all = edge_src_slot.numpy(), edge_valid.numpy()
    nv_all = node_valid.numpy()
    C, E = slot_all.shape[-2:]
    for c in (range(C) if chunks is None else chunks):
        slot, valid, nv = slot_all[c], valid_all[c], nv_all[c]
        ne = int(valid.sum())
        assert valid[:ne].all()
        assert (np.diff(slot[:ne]) >= 0).all()
        deg = np.bincount(slot[:ne], minlength=nv.shape[0])
        assert not deg[~nv].any()
        for s in np.flatnonzero(nv):
            lo = _warp_first(0, E, lambda i: not valid[i] or slot[i] >= s)
            hi = _warp_first(lo, E, lambda i: not valid[i] or slot[i] > s)
            assert hi - lo == deg[s] and (lo == hi or slot[lo] == s), (c, s)


@pytest.mark.parametrize("name", ["cluster", "lanes", "hub_cluster"])
def test_test_packs_keep_the_segment_layout(name):
    args, _ = CASES[name]()
    nodes, node_valid, _, _, slot, valid = args[:6]
    if nodes.dim() == 3:
        for b in range(nodes.shape[0]):
            _assert_segments(nodes[b], node_valid[b], slot[b], valid[b])
    else:
        _assert_segments(nodes, node_valid, slot, valid)


def test_engine_and_region_packs_keep_the_segment_layout():
    """The packs the engine gathers for a level (degree and random order)
    and a region pack gathered from the resident CSR, as the repair builds
    it, all keep the layout the kernel's search relies on."""
    g = rmat(11, 8, seed=5)
    eng = LPEngine(g, seed=0, device="cpu")
    for mode in ("degree", "random"):
        dp = eng._pack(g, mode)
        _assert_segments(dp.nodes, dp.node_valid, dp.edge_src_slot, dp.edge_valid)
    gd = to_device_csr(g, "cpu")
    region = np.sort(np.random.default_rng(1).choice(g.n, 300, replace=False))
    order = make_order(g, "random", 3)
    order = order[np.isin(order, region)]
    deg = np.diff(g.indptr)[order]
    nodes, nv, C, N, E = plan_region_pack(deg, order, g.n, max_nodes=64, max_edges=512)
    pack = gather_pack_device(torch.from_numpy(nodes).long(), torch.from_numpy(nv),
                              gd.indptr, gd.indices, gd.ew, g.n, E=E + 64)
    _assert_segments(torch.from_numpy(nodes), torch.from_numpy(nv), pack[2], pack[3])
