"""repro_torch cases that need an NVIDIA GPU: each hand-written CUDA kernel
against its plain PyTorch version on the card, and the dense round's, the
batched GA's, the dynamic serving subsystem's, the DR stack's, the
distributed path's, the matching baseline's, the LM's and the
expert-parallel MoE's card paths against their CPU paths.  Marked
``cuda``; they skip without a device.  This file imports neither jax nor
the reference package, so it runs on a GPU machine that has only
PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_finish import CASES as FINISH_CASES
from _torch_finish import kron19_case, make_case
from _torch_lp_step import CASES as STEP_CASES
from _torch_lp_step import HUB_CASES
from repro_torch.core import LPEngine, PartitionerConfig, partition, repair_balance
from repro_torch.core.label_propagation import lp_sweep_batched
from repro_torch.core.evolutionary import EvoConfig
from repro_torch.core.metrics import lmax
from repro_torch.graph import barabasi_albert, ell_pack, rmat
from repro_torch.kernels.balance import repair_balance_walk, shared_k_limit
from repro_torch.kernels.lp_step import ChunkStep, block_nodes, light_arcs
from repro_torch.kernels.lp_score import (
    dense_round_device,
    dense_round_device_batched,
    lp_score_rows,
    lp_score_rows_ref,
)

torch.set_num_threads(1)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card: exact on
    integral weights, rtol=1e-5 on float weights (atomics reorder sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for (r, w, k, integral) in ((4096, 128, 16, True), (1003, 37, 5, False),
                                (512, 128, 300, False)):
        lbl = torch.randint(-1, k + 2, (r, w), generator=gen, device="cuda",
                            dtype=torch.int32)
        wt = (torch.randint(0, 4, (r, w), generator=gen, device="cuda").float()
              if integral else torch.rand((r, w), generator=gen, device="cuda"))
        before = lp_score_rows.launches
        got = lp_score_rows(lbl, wt, k)
        torch.cuda.synchronize()
        assert lp_score_rows.launches == before + 1
        want = lp_score_rows_ref(lbl, wt, k)
        if integral:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        lp_score_rows(lbl, wt.cpu(), k)
    with pytest.raises(TypeError):
        lp_score_rows(lbl.long(), wt, k)


@pytest.mark.cuda
def test_dense_round_card_matches_cpu():
    """A dense round on the card (kernel, atomics, threefry on the device)
    returns the CPU path's labels on integral weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = rmat(10, 8, seed=7)
    k = 4
    ell = ell_pack(g)
    rng = np.random.default_rng(1)
    nb = 1 << g.n.bit_length()
    lab = np.full(nb, k, np.int32)
    lab[: g.n] = rng.integers(0, k, g.n)
    nw = np.zeros(nb, np.float32)
    nw[: g.n] = g.nw
    U = float(np.ceil(g.n / k) * 1.05)
    args = (ell.dst.astype(np.int64), ell.w, ell.row_node.astype(np.int64), lab, nw)
    before = lp_score_rows.launches
    on_card = dense_round_device(
        *(torch.from_numpy(a).cuda() for a in args), U, 11, 0.5, g.n, k=k
    ).cpu()
    assert lp_score_rows.launches == before + 1
    on_cpu = dense_round_device(*(torch.from_numpy(a) for a in args), U, 11, 0.5,
                                g.n, k=k)
    assert torch.equal(on_card, on_cpu)
    assert int((on_cpu[: g.n] != torch.from_numpy(lab[: g.n])).sum()) > 0


@pytest.mark.cuda
def test_batched_dense_round_card_matches_rows():
    """The batched dense round scores all rows with one kernel launch; on
    the card each row equals a one-row round with its seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = rmat(10, 8, seed=7)
    k, B = 4, 3
    ell = ell_pack(g)
    nb = 1 << g.n.bit_length()
    lab = np.full((B, nb), k, np.int32)
    lab[:, : g.n] = np.random.default_rng(1).integers(0, k, (B, g.n))
    nw = np.zeros(nb, np.float32)
    nw[: g.n] = g.nw
    U = float(np.ceil(g.n / k) * 1.05)
    ell_t = [torch.from_numpy(a).cuda() for a in
             (ell.dst.astype(np.int64), ell.w, ell.row_node.astype(np.int64))]
    labs, nw_t = torch.from_numpy(lab).cuda(), torch.from_numpy(nw).cuda()
    before = lp_score_rows.launches
    got = dense_round_device_batched(*ell_t, labs, nw_t, U, [3, 17, 40000], 0.5, g.n, k=k)
    assert lp_score_rows.launches == before + 1
    for b, seed in enumerate((3, 17, 40000)):
        one = dense_round_device(*ell_t, labs[b], nw_t, U, seed, 0.5, g.n, k=k)
        assert torch.equal(got[b], one)


@pytest.mark.cuda
def test_batched_ga_card_matches_cpu():
    """The batched GA on the card (device sorts, scatters and atomics) returns
    the CPU run's labels, and the numpy oracle's, on an integral graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = barabasi_albert(500, 4, seed=2)
    k = 4
    cfg = EvoConfig(k=k, Lmax=lmax(g.n, k, 0.03), islands=4, pop_per_island=3,
                    generations=2, refine_iters=3, seed=15)
    cpu = LPEngine(g, seed=0, device="cpu")
    want = cpu.evolve_device(g, cfg)
    on_card = LPEngine(g, seed=0, device="cuda").evolve_device(g, cfg)
    assert on_card.is_cuda
    assert torch.equal(on_card.cpu(), want)
    np.testing.assert_array_equal(want.numpy(), cpu.evolve_oracle(g, cfg))


def _churn(g, rng, nb, n):
    """``nb`` random adds plus ``nb`` removals of surviving original edges."""
    from repro_torch.dynamic import GraphUpdate

    src0 = g.arc_sources()
    removed = src0 >= g.indices
    while True:
        au = rng.integers(0, n, nb)
        av = (au + 1 + rng.integers(0, n - 1, nb)) % n
        cand = rng.permutation(np.flatnonzero(~removed))[:nb]
        removed[cand] = True
        yield GraphUpdate.add_edges(au, av).merged(
            GraphUpdate.remove_edges(src0[cand], g.indices[cand]))


def _assert_same(a, b, sa, sb):
    np.testing.assert_array_equal(sa.labels_np(), sb.labels_np())
    for f in ("cut", "region_size", "imbalance", "feasible", "escalated", "used_view"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["default", "throughput"])
def test_session_stream_card_matches_cpu(preset):
    """A small mixed stream (edge churn, 32 added nodes, 24 of them wired
    in, the 8 isolated ones removed) gives the same labels, cuts and region
    sizes on the card as on the CPU after every batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.dynamic import GraphUpdate, PartitionSession, SessionConfig

    g = barabasi_albert(1024, 4, seed=5)
    rng = np.random.default_rng(1)
    churn = _churn(g, rng, 24, g.n)
    new = np.arange(g.n, g.n + 24)
    acts = [next(churn), next(churn),
            GraphUpdate.add_nodes(np.ones(32, np.int64)).merged(next(churn)),
            GraphUpdate.add_edges(new, rng.integers(0, g.n, 24)).merged(next(churn)),
            next(churn), np.arange(g.n + 24, g.n + 32)]
    make = (SessionConfig.throughput if preset == "throughput" else SessionConfig)
    kw = dict(compact_fraction=0.02) if preset == "throughput" else {}
    card = PartitionSession(g, make(k=4, seed=0, **kw), device="cuda")
    cpu = PartitionSession(g, make(k=4, seed=0, **kw), device="cpu")
    assert card.store.base.indptr.is_cuda and card.labels.is_cuda
    for act in acts:
        if isinstance(act, np.ndarray):
            a, b = card.remove_nodes(act), cpu.remove_nodes(act)
        else:
            a, b = card.update(act), cpu.update(act)
        _assert_same(a, b, card, cpu)
    assert card.n == g.n + 24 and card.labels.is_cuda


@pytest.mark.cuda
def test_group_card_matches_cpu():
    """A three-tenant group (one tenant at k = 3) on the card equals the same
    group on the CPU, lane for lane, after every step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.dynamic import PartitionSession, SessionConfig, SessionGroup

    graphs = [(barabasi_albert(1024, 4, seed=5 + i), k) for i, k in enumerate((4, 4, 3))]
    groups = {d: SessionGroup({
        f"t{i}": PartitionSession(gi, SessionConfig(k=k, seed=i, repair_iters=2), device=d)
        for i, (gi, k) in enumerate(graphs)}) for d in ("cuda", "cpu")}
    streams = [_churn(gi, np.random.default_rng(20 + i), 16, gi.n)
               for i, (gi, _) in enumerate(graphs)]
    for _ in range(3):
        batch = [(f"t{i}", next(st)) for i, st in enumerate(streams)]
        res = {d: grp.update_many(batch) for d, grp in groups.items()}
        for name in res["cpu"]:
            _assert_same(res["cuda"][name], res["cpu"][name],
                         groups["cuda"].sessions[name], groups["cpu"].sessions[name])
    assert groups["cuda"].stats.lanes_repaired == 9


@pytest.mark.cuda
def test_dr_stack_card_matches_cpu(tmp_path):
    """The replicated, transactional, durable stack over a mangled stream
    with each fault class injected once gives the same host digest, the
    same TxResults and the same shards (every field) on the card as on the
    CPU after every submit, after heal() and after a restore: the smoke
    run's phase 7a, called here so that the check lives in one place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _smoke().check_dr_small(torch, str(tmp_path))


@pytest.mark.cuda
def test_dist_sweeps_card_match_cpu():
    """The distributed clustering and refinement sweeps, the distributed
    contraction and partition(engine="dist", dist_shards=8) with every PE
    on the card give the CPU's labels and coarse graph: the smoke run's
    phase 8a."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _smoke().check_dist_small(torch)


@pytest.mark.cuda
def test_sharded_ga_card_matches_unsharded():
    """The batched GA with its islands split over ``["cuda"] * 2`` (and
    ``* 4``) gives the unsharded GA's labels on the card: phase 8a."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _smoke().check_sharded_ga_small(torch)


def _smoke():
    """``chip_smoke.py`` as a module, so its checks live in one place."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.cuda
def test_accounting_on_card_stays_within_allocator_and_will_fit_reads_card():
    """A small partition() on the card with accounting on: the accountant's
    live and peak bytes stay at or below what the caching allocator holds,
    and will_fit reads the card's own memory as its budget."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import PartitionerConfig, partition
    from repro_torch.obs import accountant, set_accounting, will_fit

    g = barabasi_albert(8192, 6, seed=3)
    cfg = PartitionerConfig(k=4, refine_engine="dense", coarsest_factor=100, seed=0)
    a = accountant()
    a.reset()
    set_accounting(True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rep = partition(g, cfg)
        torch.cuda.synchronize()
        snap = a.snapshot()
        assert rep.feasible and snap["peak_total"] > 0
        assert snap["peak_total"] <= torch.cuda.max_memory_allocated()
        assert snap["total"] <= torch.cuda.memory_allocated()
    finally:
        set_accounting(False)
        a.reset()
    res = will_fit(g.n, g.m, 4, cfg)
    assert res["budget_bytes"] == torch.cuda.mem_get_info()[1]
    assert res["fits"] is True


@pytest.mark.cuda
def test_matching_multilevel_card_matches_cpu(monkeypatch):
    """The matching baseline on the card gives the CPU's labels: as it runs
    (small levels refine on the host), and with every level sent through
    its device branch (the chunked ``lp_refine`` of levels >= 200,000
    nodes, lowered to 0 here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import repro_torch.core.baselines as B

    g = rmat(11, 8, seed=1)
    for k in (2, 4):
        card = B.matching_multilevel(g, k, seed=0)
        cpu = B.matching_multilevel(g, k, seed=0, device="cpu")
        np.testing.assert_array_equal(card.labels, cpu.labels)
        assert card.cut == cpu.cut and card.level_sizes == cpu.level_sizes
    g = barabasi_albert(4096, 6, seed=2)
    monkeypatch.setattr(B, "DEVICE_REFINE_MIN_N", 0)
    card = B.matching_multilevel(g, 4, seed=0)
    cpu = B.matching_multilevel(g, 4, seed=0, device="cpu")
    assert len(card.level_sizes) > 1
    np.testing.assert_array_equal(card.labels, cpu.labels)


@pytest.mark.cuda
def test_lm_prefill_and_decode_card_matches_cpu():
    """The LM at smoke width in float32, the same weights on both devices:
    prefill's last logits and four greedy decode steps agree within rtol
    1e-4 / atol 1e-3 (reordered float32 sums, TF32 off) and the tokens are
    equal, for a dense, a sliding-window, an MoE and a hybrid Mamba stack."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import copy

    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import pad_caches
    from repro_torch.models import decode_step, init_params, prefill

    assert not torch.backends.cuda.matmul.allow_tf32
    for arch in ("qwen2.5-3b", "gemma3-27b", "granite-moe-1b-a400m", "jamba-1.5-large-398b"):
        cfg = ARCHS[arch].smoke()
        gen = torch.Generator().manual_seed(0)
        cpu = init_params(cfg, gen, "cpu")
        tokens = torch.randint(0, cfg.vocab, (2, 20), generator=gen)
        out = {}
        for dev in ("cpu", "cuda"):
            model = cpu if dev == "cpu" else copy.deepcopy(cpu).to(dev)
            last, caches = prefill(cfg, model, tokens.to(dev))
            caches = pad_caches(cfg, caches, 20, 25)
            logits, tok = [last], last.argmax(-1)
            for i in range(4):
                lg, caches = decode_step(cfg, model, tok, caches, 20 + i)
                logits.append(lg)
                tok = lg.argmax(-1)
            out[dev] = [t.cpu() for t in logits]
        for a, b in zip(out["cpu"], out["cuda"]):
            torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-3)
            assert torch.equal(a.argmax(-1), b.argmax(-1)), arch


@pytest.mark.cuda
def test_lm_grads_and_train_step_card_matches_cpu():
    """Training at smoke width in float32 (TF32 off), the same weights and
    batch on both devices: the loss within rtol 1e-5 and every gradient
    leaf within a relative L2 of 3e-5 (the CPU tests' limits against the
    reference), then one train step with and without int8 compression:
    all parameters together within 1e-5 (1e-4 with compression), for a
    dense, an MoE and an SSM stack."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import copy

    from repro_torch.configs import ARCHS
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import adamw_init, ef_init

    assert not torch.backends.cuda.matmul.allow_tf32

    def rel(a, b):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        return float((a - b).norm() / b.norm())

    for arch in ("qwen2.5-3b", "granite-moe-1b-a400m", "mamba2-2.7b"):
        cfg = ARCHS[arch].smoke()
        cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = TokenPipeline(vocab=cfg.vocab, batch=2, seq=24).batch_at(0)["tokens"]
        out = {}
        for dev in ("cpu", "cuda"):
            model = copy.deepcopy(cpu).to(dev)
            batch = {"tokens": torch.from_numpy(toks).long().to(dev)}
            loss, _ = loss_fn(cfg, model, batch)
            loss.backward()
            grads = {k: p.grad for k, p in model.named_parameters()}
            steps = []
            for compress in (False, True):
                m = copy.deepcopy(cpu).to(dev)
                named = dict(m.named_parameters())
                opt = adamw_init(named)
                opt = (opt, ef_init(named)) if compress else opt
                m, _, _ = make_train_step(cfg, lr=1e-3, compress_grads=compress)(m, opt, batch)
                steps.append(torch.cat([p.detach().flatten().cpu() for p in m.parameters()]))
            out[dev] = (float(loss), grads, steps)
        (l0, g0, s0), (l1, g1, s1) = out["cpu"], out["cuda"]
        assert abs(l1 - l0) <= 1e-5 * abs(l0), arch
        assert max(rel(g1[k], g0[k]) for k in g0) <= 3e-5, arch
        assert rel(s1[0], s0[0]) <= 1e-5 and rel(s1[1], s0[1]) <= 1e-4, arch


@pytest.mark.cuda
def test_moe_ep_card_matches_cpu():
    """``moe_ep`` at smoke width in float32 on a 2x4 mesh of the card
    against the port's own CPU result on a 2x4 mesh of CPU coordinates:
    at capacity 1.25 and 0.5 the same assignments are dropped and the
    output, aux and input gradient agree within 1e-5; at 8.0 nothing
    drops and it equals ``moe_dense`` within 2e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import make_mesh
    from repro_torch.models.moe import moe_dense, moe_ep

    assert not torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator().manual_seed(0)
    E, D, F = 8, 32, 64
    p = {"router": torch.randn(D, E, generator=gen) * D ** -0.5,
         "w_up": torch.randn(E, D, F, generator=gen) * D ** -0.5,
         "w_gate": torch.randn(E, D, F, generator=gen) * D ** -0.5,
         "w_down": torch.randn(E, F, D, generator=gen) * F ** -0.5}
    x = torch.randn(4, 16, D, generator=gen)
    for cf in (8.0, 1.25, 0.5):
        out = {}
        for dev in ("cpu", "cuda"):
            mesh = make_mesh((2, 4), ("data", "model"), [dev] * 8)
            xd = x.to(dev, copy=True).requires_grad_(True)
            stats = {}
            y, aux = moe_ep({k: v.to(dev) for k, v in p.items()}, xd, mesh=mesh, topk=2,
                            n_experts=E, capacity_factor=cf, stats=stats)
            (y.square().sum() + aux).backward()
            out[dev] = (y.detach().cpu(), float(aux), xd.grad.cpu(),
                        [k.cpu() for k in stats["keep"]])
        (y0, a0, g0, k0), (y1, a1, g1, k1) = out["cpu"], out["cuda"]
        assert all(torch.equal(a, b) for a, b in zip(k0, k1)), cf
        torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(g1, g0, rtol=1e-5, atol=1e-5)
        assert abs(a1 - a0) <= 1e-5 * abs(a0)
        if cf == 8.0:
            assert all(bool(k.all()) for k in k0)
            assert float((y0 - moe_dense(p, x, topk=2)[0]).abs().max()) < 2e-4


def _finish_on(g, lab, k, L, device):
    out, moved = LPEngine(g, device=device).repair_balance(g, lab, k, L)
    return out[: g.n].cpu().numpy(), int(moved)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [*FINISH_CASES, "kron19"])
def test_repair_balance_walk_card_matches_host_and_twin(name):
    """The final balance repair on the card (the prelude's device sort and
    atomics, then the walk kernel) returns ``repair_balance``'s labels and
    its CPU twin's, on the CPU tests' cases (k = 8192 and 40,000 take the
    kernel's opt-in shared memory and its global variant) and on a
    kron19-sized input where ~70 % of the nodes move."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g, lab, k, L = kron19_case() if name == "kron19" else make_case(name)
    want = repair_balance(g, lab, k, L)
    twin, moved_twin = _finish_on(g, lab, k, L, "cpu")
    before = repair_balance_walk.launches
    card, moved_card = _finish_on(g, lab, k, L, "cuda")
    torch.cuda.synchronize()
    feasible = name != "kron19" and FINISH_CASES[name][2] is None
    assert repair_balance_walk.launches == before + (0 if feasible else 1)
    np.testing.assert_array_equal(card, want)
    np.testing.assert_array_equal(twin, want)
    assert moved_card == moved_twin == np.count_nonzero(want != lab)
    if name == "kron19":
        assert moved_card > 0.6 * g.n


@pytest.mark.cuda
def test_repair_balance_walk_kernel_contract():
    """The kernel on the twin's hand-made input, where the block weights
    live (shared memory up to the card's opt-in limit, which the k = 8192
    case needs and the k = 40,000 case outgrows), and what the wrapper
    refuses: no blocks, wrong dtypes, mixed devices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = "cuda"
    bw = torch.tensor([9.0, 2.0, 2.0], dtype=torch.float64, device=dev)
    labels = torch.tensor([0, 0, 0, 0, 1, 2], dtype=torch.int32, device=dev)
    cand = torch.tensor([3, 0, 1, 2], dtype=torch.int64, device=dev)
    nw = torch.tensor([4.0, 1.0, 1.0, 2.0], dtype=torch.float32, device=dev)
    out, moved = repair_balance_walk(cand, labels[cand], nw, labels, bw, 5.0)
    assert out.tolist() == [1, 2, 1, 0, 1, 2] and int(moved) == 3
    assert labels.tolist() == [0, 0, 0, 0, 1, 2] and bw.tolist() == [9.0, 2.0, 2.0]
    # 48 KiB without an opt-in hold (48 - 16) KiB / 8 = 4,096 weights beside
    # the tile; the H100 opts in to 227 KiB
    assert 8192 <= shared_k_limit() < 40000
    none = torch.zeros(0, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="k=0"):
        repair_balance_walk(cand, labels[cand], nw, labels, none, 5.0)
    with pytest.raises(TypeError):
        repair_balance_walk(cand, labels[cand], nw, labels.long(), bw, 5.0)
    with pytest.raises(ValueError):
        repair_balance_walk(cand, labels[cand], nw.cpu(), labels, bw, 5.0)


@pytest.mark.cuda
def test_partition_device_finish_card_matches_cpu():
    """``partition()`` on the card repairs and cuts its finest labels on
    the card and returns the CPU run's labels, cuts and moved count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = rmat(11, 8, seed=1)
    cfg = dict(k=16, preset="fast", refine_engine="dense", seed=0, dense_min_n=600,
               numpy_below=600, coarsest_factor=100)
    cpu = partition(g, PartitionerConfig(**cfg), device="cpu")
    before = repair_balance_walk.launches
    card = partition(g, PartitionerConfig(**cfg), device="cuda")
    assert repair_balance_walk.launches > before
    np.testing.assert_array_equal(card.labels, cpu.labels)
    assert card.cut == cpu.cut and card.cycle_cuts == cpu.cycle_cuts
    for key in ("finish_device", "finish_moved"):
        assert card.engine_stats[key] == cpu.engine_stats[key], key
    assert card.engine_stats["finish_device"] > 0
    assert card.engine_stats["finish_moved"] > 0


@pytest.mark.cuda
def test_finest_pack_gathers_match_host_packers_within_budget():
    """The finest graph's chunk packs and ELL, gathered on the card from
    its resident CSR, equal the host packers' arrays on a 2^17-node rmat,
    and building each raises the peak above its outputs by no more than
    ``GATHER_BUDGET_BYTES``, though one ungrouped gather would exceed it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import repro_torch.graph.packing as TP
    from repro_torch.core.label_propagation import make_order
    from repro_torch.graph import pow2

    g = rmat(17, 16, seed=1)
    assert g.n >= 2**17
    eng = LPEngine(g, device="cuda")
    eng._dev(g)                      # the resident CSR, built before the peaks
    torch.cuda.synchronize()
    buckets = [eng.C_bucket, eng.E_floor]

    def build(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    for mode in ("degree", "random"):
        dp, peak = build(lambda: eng._pack(g, mode))
        order = make_order(g, mode, eng.seed)
        pack = TP.pack_chunks(g, order, max_nodes=eng.N,
                              max_edges=max(eng._e_request, buckets[1]),
                              block=eng.pack_block)
        buckets[0] = max(buckets[0], pow2(pack.nodes.shape[0]))
        buckets[1] = max(buckets[1], -(-pack.edge_dst.shape[1] // 512) * 512)
        want = TP.pad_pack(pack, buckets[0], eng.N, buckets[1])
        assert dp.shape == (buckets[0], eng.N, buckets[1])
        outs = [getattr(dp, f) for f in ("nodes", "node_valid", "edge_dst", "edge_w",
                                         "edge_src_slot", "edge_valid")]
        for got, f in zip(outs, ("nodes", "node_valid", "edge_dst", "edge_w",
                                 "edge_src_slot", "edge_valid")):
            np.testing.assert_array_equal(got.cpu().numpy(), getattr(want, f), err_msg=f)
        out_bytes = sum(t.numel() * t.element_size() for t in outs)
        slots = dp.shape[0] * dp.shape[2]
        assert slots * TP._PACK_SLOT_BYTES > 2 * TP.GATHER_BUDGET_BYTES
        assert peak - out_bytes <= TP.GATHER_BUDGET_BYTES, (mode, peak, out_bytes)
    de, peak = build(lambda: eng._ell(g))
    ell = TP.ell_pack(g)
    R, Rb = ell.rows, de.dst.shape[0]
    assert Rb == pow2(R)
    np.testing.assert_array_equal(
        de.dst.cpu().numpy(), np.pad(ell.dst, ((0, Rb - R), (0, 0)), constant_values=g.n))
    np.testing.assert_array_equal(de.w.cpu().numpy(), np.pad(ell.w, ((0, Rb - R), (0, 0))))
    np.testing.assert_array_equal(
        de.row_node.cpu().numpy(), np.pad(ell.row_node, (0, Rb - R), constant_values=g.n))
    out_bytes = sum(t.numel() * t.element_size() for t in (de.dst, de.w, de.row_node))
    assert Rb * TP.ELL_WIDTH * TP._ELL_SLOT_BYTES > 2 * TP.GATHER_BUDGET_BYTES
    assert peak - out_bytes <= TP.GATHER_BUDGET_BYTES, ("ell", peak, out_bytes)
    assert eng.stats.gather_builds == eng.stats.pack_builds == 3


def _on_card(args):
    return tuple(a.cuda() if isinstance(a, torch.Tensor) else a for a in args)


def _block_path_visits(args, iters: int) -> int:
    """The hub visits of a sweep: each row's valid nodes with more arcs in
    their chunk than the kernel's warp path takes, once an iteration
    (padded chunks hold no valid node)."""
    nodes, node_valid, _, _, slot, valid = args[:6]
    B = args[6].shape[0]
    if nodes.dim() == 2:
        node_valid, slot, valid = (t.expand(B, *t.shape) for t in (node_valid, slot, valid))
    N = nodes.shape[-1]
    deg = torch.zeros(node_valid.shape, dtype=torch.int64)
    deg.scatter_add_(2, slot, valid.to(torch.int64))
    return iters * int(((deg > light_arcs()) & node_valid).sum()) if N else 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STEP_CASES))
def test_lp_chunk_step_card_matches_plain(name):
    """The chunk-step kernel against its plain version (the torch-ops body
    on the CPU), labels, block weights and moves bit for bit: cluster and
    refine mode with and without the restriction, rows of one shared pack
    with their own chunk orders (the GA), lanes of their own packs with
    uneven chunk counts (the repair), bucket-padded chunks, slots and arcs,
    hubs whose arcs blocks share in pieces, and edge weights that sum alike
    only in pack order.  Three launches a step; the hub counter counts each
    visit of a node with more arcs than the warp path takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = STEP_CASES[name]()
    want = lp_sweep_batched(*args, **kw)
    live = args[-1] if isinstance(args[-1], list) else [args[-1]]
    before, visits = ChunkStep.launches, block_nodes()
    got = lp_sweep_batched(*_on_card(args), **kw)
    torch.cuda.synchronize()
    assert ChunkStep.launches == before + 3 * kw["iters"] * max(live)
    heavy = _block_path_visits(args, kw["iters"])
    assert block_nodes() - visits == heavy
    assert heavy > 0 or name not in HUB_CASES
    for part, g, w in zip(("labels", "weights", "moves"), got, want):
        assert g.is_cuda
        assert torch.equal(g.cpu(), w), part
    assert int(want[2].sum()) > 0


@pytest.mark.cuda
def test_lp_chunk_step_wrapper_contract():
    """int64 label rows run as int32 ones do; what the wrapper refuses:
    tensors on two devices, float labels, a restriction of another dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert light_arcs() == 256
    args, kw = STEP_CASES["cluster_restrict"]()
    card = list(_on_card(args))
    want = lp_sweep_batched(*card, **kw)
    wide = list(card)
    wide[6] = card[6].long()
    got = lp_sweep_batched(*wide, **kw)
    assert got[0].dtype == torch.int64
    assert torch.equal(got[0], want[0].long()) and torch.equal(got[1], want[1])
    mixed = list(card)
    mixed[3] = args[3]
    with pytest.raises(ValueError, match="one CUDA device"):
        lp_sweep_batched(*mixed, **kw)
    bad = list(card)
    bad[6] = card[6].float()
    with pytest.raises(TypeError):
        lp_sweep_batched(*bad, **kw)
    bad = list(card)
    bad[9] = card[9].long()
    with pytest.raises(ValueError, match="restriction"):
        lp_sweep_batched(*bad, **kw)


@pytest.mark.cuda
def test_partition_chunk_steps_card_match_cpu():
    """A whole ``partition()`` on rmat(17, 16): its sweeps (the levels'
    cluster sweeps, the GA's refine sweeps) run the chunk-step kernel on
    the card and give the CPU run's labels and cuts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = rmat(17, 16, seed=1)
    cfg = dict(k=16, preset="fast", refine_engine="dense", seed=0, coarsest_factor=100)
    cpu = partition(g, PartitionerConfig(**cfg), device="cpu")
    before = ChunkStep.launches
    card = partition(g, PartitionerConfig(**cfg), device="cuda")
    assert ChunkStep.launches > before
    np.testing.assert_array_equal(card.labels, cpu.labels)
    assert card.cut == cpu.cut and card.cycle_cuts == cpu.cycle_cuts
