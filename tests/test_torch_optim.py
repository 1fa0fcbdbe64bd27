"""The port's optimizer, data pipeline and optimizer checkpoints
(``repro_torch.optim``, ``repro_torch.data``, ``repro_torch.ckpt``) against
the reference's on the CPU, every input made once from a seed with numpy.

Tolerances: token batches equal bit for bit; int8 compression equals the
reference's function as written (eager) bit for bit, and its jitted form in
the dequantized gradients (XLA contracts the residual ``x - q * scale`` into
one fused multiply-add, which moves the residual by an ulp of ``x``);
AdamW's ``gnorm`` within rtol 1e-6 of the reference's jitted update and
its parameters, moments and master within rtol 1e-6 / atol 1e-8 (measured:
``gnorm``'s float32 sum in another order within 1.5e-7; 1-ulp differences
in a few elements of the master, which near zero are up to 2.7e-6 relative
and 1.6e-9 absolute: an ulp of a 1e-2 step); the warmup-cosine schedule
within rtol 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

import repro.data as RD
import repro.optim as RO
import repro_torch.data as PD
import repro_torch.optim as PO
from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore, save

torch.set_num_threads(1)

SHAPES = {"a": (64, 32), "b": (7,), "c": (3, 5, 9)}
RTOL = 1e-6
STATE_TOL = dict(rtol=1e-6, atol=1e-8)


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _port(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _close(got: dict, want: dict, **tol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k,
                                   **(tol or STATE_TOL))


# ---------------------------------------------------------------- AdamW


@pytest.mark.parametrize("gscale", [1e-3, 3.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference(gscale):
    """Four steps of the reference's jitted update and the port's on the
    same parameters and gradients: below and above the clipping norm."""
    rng = np.random.default_rng(1)
    p, g = _tree(rng), _tree(rng, gscale)
    upd = jax.jit(lambda g, s, p: RO.adamw_update(g, s, p, lr=1e-2))
    rp, rs = p, RO.adamw_init(p)
    pp = _port(p)
    ps = PO.adamw_init(pp)
    for i in range(4):
        gi = {k: v * (1 + i) for k, v in g.items()}
        rp, rs, rg = upd(gi, rs, rp)
        pp, ps, pg = PO.adamw_update(_port(gi), ps, pp, lr=1e-2)
        assert ps.step.dtype == torch.int32 and int(ps.step) == int(rs.step) == i + 1
        np.testing.assert_allclose(float(pg), float(rg), rtol=RTOL)
        _close(pp, rp)
        for f in ("mu", "nu", "master"):
            _close(getattr(ps, f), getattr(rs, f))
    if gscale > 1:
        assert float(rg) > 1.0          # the clipped case clips


def test_adamw_init_copies_the_master():
    """The master is a float32 copy, never the float32 parameter itself;
    the moments are float32 zeros; the update writes the parameters in
    place with the master cast to their dtype."""
    params = {"w": torch.ones(4), "h": torch.full((3,), 1.5, dtype=torch.bfloat16)}
    st = PO.adamw_init(params)
    assert st.master["w"].data_ptr() != params["w"].data_ptr()
    assert [t.dtype for t in st.master.values()] == [torch.float32] * 2
    assert all(not t.any() for t in list(st.mu.values()) + list(st.nu.values()))
    w = params["w"]
    new, st, _ = PO.adamw_update({"w": torch.ones(4), "h": torch.ones(3, dtype=torch.bfloat16)},
                                 st, params, lr=0.1)
    assert new["w"] is w and not torch.equal(w, torch.ones(4))
    assert torch.equal(new["w"], st.master["w"])
    assert new["h"].dtype == torch.bfloat16
    assert torch.equal(new["h"], st.master["h"].to(torch.bfloat16))


def test_adamw_minimizes_quadratic():
    params = {"w": torch.full((4,), 5.0, requires_grad=True)}
    opt = PO.adamw_init(params)
    for _ in range(200):
        params["w"].grad = None
        loss = torch.sum(params["w"] ** 2)
        loss.backward()
        params, opt, _ = PO.adamw_update({"w": params["w"].grad}, opt, params, lr=0.1,
                                         weight_decay=0.0)
    assert float(torch.sum(params["w"].detach() ** 2)) < 1e-2


def test_grad_clip():
    params = {"w": torch.zeros(4)}
    opt = PO.adamw_init(params)
    _, _, gnorm = PO.adamw_update({"w": torch.full((4,), 1e6)}, opt, params, lr=0.0,
                                  clip_norm=1.0)
    assert float(gnorm) > 1e5  # reported norm is pre-clip


# ---------------------------------------------------------------- schedule


def test_warmup_cosine_matches_reference():
    kw = dict(peak=1e-3, warmup=10, total=100)
    ref = jax.jit(lambda s: RO.warmup_cosine(s, **kw))
    for s in range(0, 120):
        got = PO.warmup_cosine(s, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref(s)), rtol=RTOL)
        np.testing.assert_allclose(float(got), float(RO.warmup_cosine(s, **kw)), rtol=RTOL)


def test_warmup_cosine_shape():
    lrs = [float(PO.warmup_cosine(s, peak=1.0, warmup=10, total=100)) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0
    assert lrs[99] < lrs[50] < lrs[12]


# ---------------------------------------------------------------- compression


def test_compress_decompress_matches_reference():
    """Five steps of error feedback on gradients that grow: the eager
    reference bit for bit; the jitted one in the dequantized gradients,
    with residuals within an ulp of the compressed values."""
    rng = np.random.default_rng(2)
    g = _tree(rng, 3.0)
    eager_res = RO.ef_init(g)
    res = PO.ef_init(_port(g))
    assert all(t.dtype == torch.float32 and not t.any() for t in res.values())
    cd = jax.jit(RO.compress_decompress)
    for i in range(5):
        gi = {k: v * (1 + 0.3 * i) for k, v in g.items()}
        deq_e, eager_res = RO.compress_decompress(gi, eager_res)
        deq, res_new = PO.compress_decompress(_port(gi), res)
        for k in g:
            assert np.array_equal(deq[k].numpy(), np.asarray(deq_e[k])), (i, k)
            assert np.array_equal(res_new[k].numpy(), np.asarray(eager_res[k])), (i, k)
            # the jitted reference from the same residuals as the port
            dj, rj = cd({k: gi[k]}, {k: res[k].numpy()})
            assert np.array_equal(deq[k].numpy(), np.asarray(dj[k])), (i, k)
            ulp = float(np.spacing(np.abs(gi[k] + res[k].numpy()).max()))
            np.testing.assert_allclose(res_new[k].numpy(), np.asarray(rj[k]), rtol=0, atol=ulp)
        res = res_new


def test_compression_error_feedback_unbiased():
    """With error feedback, the cumulative compressed sum tracks the true
    cumulative sum (residual stays bounded)."""
    rng = np.random.default_rng(0)
    g_true = {"w": torch.from_numpy(rng.standard_normal(256).astype(np.float32))}
    res = PO.ef_init(g_true)
    total_c = np.zeros(256)
    for i in range(50):
        g = {"w": g_true["w"] * (1 + 0.01 * i)}
        deq, res = PO.compress_decompress(g, res)
        total_c += deq["w"].numpy()
    assert float(res["w"].abs().max()) < 0.2


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("kw", [dict(vocab=256, batch=4, seq=32, seed=7),
                                dict(vocab=97, batch=3, seq=10, seed=1, n_prefix=4, d_model=8),
                                dict(vocab=151_936, batch=2, seq=64, seed=0)],
                         ids=["smoke", "prefix", "qwen-vocab"])
def test_batches_equal_reference(kw):
    ref, port = RD.TokenPipeline(**kw), PD.TokenPipeline(**kw)
    for step in (0, 3, 11):
        a, b = ref.batch_at(step), port.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (step, k)


def test_deterministic_by_step():
    p1 = PD.TokenPipeline(vocab=256, batch=4, seq=32, seed=7)
    p2 = PD.TokenPipeline(vocab=256, batch=4, seq=32, seed=7)
    for s in (0, 5, 17):
        np.testing.assert_array_equal(p1.batch_at(s)["tokens"], p2.batch_at(s)["tokens"])
    assert not np.array_equal(p1.batch_at(0)["tokens"], p1.batch_at(1)["tokens"])


def test_learnable_structure():
    t = PD.TokenPipeline(vocab=97, batch=8, seq=64, seed=0).batch_at(0)["tokens"]
    hits = (t[:, 1:] == (t[:, :-1] * 31 + 7) % 97).mean()
    assert hits > 0.3  # induced bigram structure present


# ---------------------------------------------------------------- checkpoints


def _train_state(rng, dtype=torch.float32):
    params = {k: torch.from_numpy(v).to(dtype) for k, v in _tree(rng).items()}
    opt = PO.adamw_init(params)
    params, opt, _ = PO.adamw_update(_port(_tree(rng)), opt, params, lr=1e-2)
    return params, (opt, {k: torch.from_numpy(v) for k, v in _tree(rng, 0.01).items()})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_checkpoint_round_trips_optimizer_state(tmp_path, dtype):
    """``restore`` rebuilds ``(params, (AdamWState, residuals))``: the
    named tuple, its int32 step and every leaf equal, bfloat16 parameters
    included; the async writer's copy is taken at submit time."""
    rng = np.random.default_rng(3)
    params, opt = _train_state(rng, dtype)
    save(str(tmp_path / "s"), 4, (params, opt), {"step": 4})
    like = _train_state(np.random.default_rng(9), dtype)
    (p2, (st2, res2)), extra = restore(str(tmp_path / "s"), 4, like)
    assert extra == {"step": 4}
    assert isinstance(st2, PO.AdamWState) and st2.step.dtype == torch.int32
    assert int(st2.step) == 1
    for a, b in ((p2, params), (st2.mu, opt[0].mu), (st2.nu, opt[0].nu),
                 (st2.master, opt[0].master), (res2, opt[1])):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k

    ck = AsyncCheckpointer(str(tmp_path / "a"))
    ck.submit(7, (params, opt), {"step": 7})
    want = {k: t.clone() for k, t in params.items()}
    for t in params.values():
        t.add_(1.0)                     # a later step, after the submit
    ck.wait()
    assert latest_step(str(tmp_path / "a")) == 7
    (p3, _), _ = restore(str(tmp_path / "a"), 7, like)
    assert all(torch.equal(p3[k], want[k]) for k in want)
