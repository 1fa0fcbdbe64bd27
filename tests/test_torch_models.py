"""The port's LM modules (``repro_torch.configs``, ``repro_torch.models``)
against the reference's on the CPU: every input is made once from a seed
with numpy, the reference's weights are carried into the port, and both
compute in float32 unless a test says otherwise.

Tolerances (float32): a single block (norm, rope, attention, FFN, router,
MoE, SSD, Mamba-2) within rtol 1e-5 / atol 1e-5 of the reference, the whole
model's logits within rtol 1e-4 / atol 1e-3 (16 smoke layers of reordered
float32 sums; measured at most 1.9e-4 on logits up to 4.2), the loss and
the aux loss within 1e-5.  Integer outputs (top-k indices, argmax) are
equal.  The bf16 switches are held to rtol / atol 2e-2.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.configs as RC
import repro.configs.mini_lm as RMINI
import repro.models.layers as RL
import repro.models.mamba2 as RMA
import repro.models.model as RM
import repro.models.moe as RMOE
import repro_torch.configs as PC
import repro_torch.configs.mini_lm as PMINI
import repro_torch.models.layers as PL
import repro_torch.models.mamba2 as PMA
import repro_torch.models.moe as PMOE
from repro_torch.models import forward, from_reference_params, loss_fn

torch.set_num_threads(1)

ARCHS = sorted(RC.ARCHS)
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _close(got, want, **tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **(tol or F32))


def _ref(fn, *args, **kw):
    """The reference function jitted, its keyword arguments static (eager
    JAX compiles op by op, which costs seconds a call)."""
    return jax.jit(functools.partial(fn, **kw))(*args)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _attn_params(rng, D, H, G, dh, bias=True):
    p = {"wq": _normal(rng, D, H * dh, scale=D ** -0.5),
         "wk": _normal(rng, D, G * dh, scale=D ** -0.5),
         "wv": _normal(rng, D, G * dh, scale=D ** -0.5),
         "wo": _normal(rng, H * dh, D, scale=D ** -0.5)}
    if bias:
        p.update(bq=_normal(rng, H * dh, scale=0.1), bk=_normal(rng, G * dh, scale=0.1),
                 bv=_normal(rng, G * dh, scale=0.1))
    return p


def _port(p):
    return {k: _t(v) for k, v in p.items()}


# ---------------------------------------------------------------- configs


def test_configs_equal_reference():
    """Every field of every architecture, its smoke config, the shapes, the
    cell grid and the demo config equal the reference's."""
    assert list(PC.ARCHS) == list(RC.ARCHS)
    for a in ARCHS:
        for r, p in ((RC.ARCHS[a], PC.ARCHS[a]), (RC.ARCHS[a].smoke(), PC.ARCHS[a].smoke())):
            assert dataclasses.asdict(p) == dataclasses.asdict(r), a
            assert (p.d_head, p.layer_plan(), p.scan_split()) == \
                (r.d_head, r.layer_plan(), r.scan_split())
        assert dataclasses.asdict(PC.get_config(a)) == dataclasses.asdict(RC.get_config(a))
    assert {k: dataclasses.asdict(v) for k, v in PC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()}
    assert PC.cells() == RC.cells()
    assert dataclasses.asdict(PMINI.MINI_LM) == dataclasses.asdict(RMINI.MINI_LM)
    with pytest.raises(KeyError):
        PC.get_config("gpt-5")


# ---------------------------------------------------------------- layers


def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x, w = _normal(rng, 2, 5, 32), _normal(rng, 32, scale=0.3)
    for eps in (1e-6, 1e-5):
        _close(PL.rmsnorm(_t(x), _t(w), eps), _ref(RL.rmsnorm, x, w, eps=eps))
    pos = np.arange(40, dtype=np.int32)
    for theta in (10_000.0, 1_000_000.0):
        pc, ps = PL.rope_table(_t(pos), 16, theta)
        rc, rs = _ref(RL.rope_table, pos, d_head=16, theta=theta)
        _close(pc, rc)
        _close(ps, rs)
        q = _normal(rng, 2, 40, 4, 16)
        _close(PL.apply_rope(_t(q), pc[:, None, :], ps[:, None, :]),
               _ref(RL.apply_rope, q, rc[:, None, :], rs[:, None, :]))


@pytest.mark.parametrize("S,q_chunk,window", [
    (24, 8, None), (21, 8, None), (21, 8, 6), (24, 1024, 8), (5, 4, 8)],
    ids=["chunked", "ragged", "ragged-window", "window", "short-window"])
def test_attention(S, q_chunk, window):
    """Query-chunked causal attention, S a multiple of the chunk or not,
    global or sliding-window, with the serving cache."""
    rng = np.random.default_rng(S + q_chunk)
    D, H, G, dh = 32, 4, 2, 8
    p = _attn_params(rng, D, H, G, dh)
    x = _normal(rng, 2, S, D)
    kw = dict(n_heads=H, n_kv=G, d_head=dh, rope_theta=1e6, window=window,
              q_chunk=q_chunk, return_cache=True)
    y, c = PL.attention(_port(p), _t(x), **kw)
    ry, rc = _ref(RL.attention, p, x, **kw)
    _close(y, ry)
    for name in ("k", "v"):
        assert c[name].shape == rc[name].shape
        _close(c[name], rc[name])


@pytest.mark.parametrize("S_c,pos,window", [(16, 9, None), (8, 5, 8), (8, 13, 8)],
                         ids=["plain", "ring-filling", "ring-full"])
def test_decode_attention(S_c, pos, window):
    """One decode token against a plain cache or a ring buffer; the cache
    comes back with the token written at the reference's slot."""
    rng = np.random.default_rng(pos)
    D, H, G, dh = 32, 4, 2, 8
    p = _attn_params(rng, D, H, G, dh)
    x = _normal(rng, 2, 1, D)
    cache = {"k": _normal(rng, 2, S_c, G, dh), "v": _normal(rng, 2, S_c, G, dh)}
    kw = dict(n_heads=H, n_kv=G, d_head=dh, rope_theta=1e4, window=window)
    with torch.no_grad():
        y, c = PL.decode_attention(_port(p), _t(x), _port(cache), pos, **kw)
    ry, rc = _ref(RL.decode_attention, p, x, cache, jnp.int32(pos), **kw)
    _close(y, ry)
    _close(c["k"], rc["k"])
    _close(c["v"], rc["v"])


@pytest.mark.parametrize("glu,act", [(True, "silu"), (False, "gelu"), (True, "gelu")])
def test_ffn(glu, act):
    """The dense FFN; gelu is jax's default tanh form (the exact erf form
    misses by ~1e-3)."""
    rng = np.random.default_rng(3)
    p = {"w_up": _normal(rng, 32, 64), "w_down": _normal(rng, 64, 32, scale=0.125)}
    if glu:
        p["w_gate"] = _normal(rng, 32, 64)
    x = _normal(rng, 2, 7, 32)
    _close(PL.ffn(_port(p), _t(x), glu=glu, act=act),
           _ref(RL.ffn, p, x, glu=glu, act=act))


# ---------------------------------------------------------------- MoE


def test_router_topk_breaks_ties_like_lax_top_k():
    """Columns 1, 3 and 5 of the router are equal, so those experts tie on
    every token; the indices must come out in jax.lax.top_k's order (the
    lower index first)."""
    rng = np.random.default_rng(4)
    w = _normal(rng, 16, 8, scale=0.25)
    w[:, 3] = w[:, 1]
    w[:, 5] = w[:, 1]
    w[:, 1] += 2.0                      # make the tied experts the top ones
    w[:, 3] += 2.0
    w[:, 5] += 2.0
    x = np.abs(_normal(rng, 12, 16))
    topv, topi, aux = PMOE.router_topk(_t(x), _t(w), 2)
    rv, ri, raux = _ref(RMOE.router_topk, x, w, topk=2)
    assert np.array_equal(topi.numpy(), np.asarray(ri))
    assert (topi.numpy() == [1, 3]).all()
    _close(topv, rv)
    _close(aux, raux)


@pytest.mark.parametrize("glu,act", [(True, "silu"), (False, "gelu")])
def test_moe_dense(glu, act):
    rng = np.random.default_rng(5)
    E, D, Ff = 4, 32, 16
    p = {"router": _normal(rng, D, E, scale=D ** -0.5),
         "w_up": _normal(rng, E, D, Ff, scale=D ** -0.5),
         "w_down": _normal(rng, E, Ff, D, scale=Ff ** -0.5)}
    if glu:
        p["w_gate"] = _normal(rng, E, D, Ff, scale=D ** -0.5)
    x = _normal(rng, 2, 9, D)
    y, aux = PMOE.moe_dense(_port(p), _t(x), topk=2, glu=glu, act=act)
    ry, raux = _ref(RMOE.moe_dense, p, x, topk=2, glu=glu, act=act)
    _close(y, ry)
    _close(aux, raux)


# ---------------------------------------------------------------- Mamba-2


def _ssd_inputs(rng, B=2, S=37, H=4, P=8, N=16):
    X = _normal(rng, B, S, H, P)
    dt = np.logaddexp(_normal(rng, B, S, H), 0)
    A = -np.exp(_normal(rng, H, scale=0.3))
    return X, dt, A, _normal(rng, B, S, N, scale=0.3), _normal(rng, B, S, N, scale=0.3), \
        _normal(rng, B, H, P, N, scale=0.1)


def test_ssd_chunked():
    """S = 37 is not a multiple of the chunk (8), the heads run in blocks
    of 2, and the scan starts from a non-zero state."""
    X, dt, A, Bm, Cm, h0 = _ssd_inputs(np.random.default_rng(6))
    Y, h = PMA._ssd_chunked(*map(_t, (X, dt, A, Bm, Cm, h0)), chunk=8, head_block=2)
    rY, rh = _ref(RMA._ssd_chunked, X, dt, A, Bm, Cm, h0, chunk=8, head_block=2)
    _close(Y, rY)
    _close(h, rh)


def _mamba_params(rng, D=32, N=16, P=8, expand=2, W=4):
    """The reference's shapes and scales, with non-trivial dt bias, decay,
    skip and norm weights."""
    Di = expand * D
    H = Di // P
    return dict(wz=_normal(rng, D, Di, scale=D ** -0.5), wx=_normal(rng, D, Di, scale=D ** -0.5),
                wB=_normal(rng, D, N, scale=D ** -0.5), wC=_normal(rng, D, N, scale=D ** -0.5),
                wdt=_normal(rng, D, H, scale=D ** -0.5), dt_bias=_normal(rng, H, scale=0.5),
                A_log=_normal(rng, H, scale=0.3), D_skip=_normal(rng, H),
                conv_w=_normal(rng, W, Di, scale=0.2), conv_b=_normal(rng, Di, scale=0.1),
                norm_w=_normal(rng, Di, scale=0.2), wo=_normal(rng, Di, D, scale=Di ** -0.5))


def test_mamba_block_and_decode():
    """The block over S = 21 tokens with chunk 8 (not a multiple), its
    cache, and one decode step from that cache."""
    rng = np.random.default_rng(8)
    p = _mamba_params(rng)
    x = _normal(rng, 2, 22, 32, scale=0.5)
    kw = dict(d_state=16, headdim=8)
    out, c = PMA.mamba_block(_port(p), _t(x[:, :21]), chunk=8, return_cache=True, **kw)
    rout, rc = _ref(RMA.mamba_block, p, x[:, :21], chunk=8, return_cache=True, **kw)
    _close(out, rout)
    _close(c["h"], rc["h"])
    _close(c["conv"], rc["conv"])
    y, c2 = PMA.mamba_decode(_port(p), _t(x[:, 21:]), c, **kw)
    ry, rc2 = _ref(RMA.mamba_decode, p, x[:, 21:], rc, **kw)
    _close(y, ry)
    _close(c2["h"], rc2["h"])
    _close(c2["conv"], rc2["conv"])
    # a prompt shorter than the conv window pads the conv cache in front
    _, c3 = PMA.mamba_block(_port(p), _t(x[:, :2]), return_cache=True, **kw)
    _, rc3 = _ref(RMA.mamba_block, p, x[:, :2], return_cache=True, **kw)
    _close(c3["conv"], rc3["conv"])


def test_softplus_is_jax_softplus():
    """jax.nn.softplus is logaddexp(x, 0); torch's F.softplus returns x
    itself above 20.  The port uses the reference's formula."""
    x = np.concatenate([np.linspace(-40, 40, 801), [-1e4, 1e4]]).astype(np.float32)
    _close(PMA._softplus(_t(x)), jax.nn.softplus(jnp.asarray(x)), rtol=1e-6, atol=1e-7)


def test_argmax_takes_the_first_maximum():
    logits = np.zeros((3, 10), np.float32)
    logits[0, [2, 7]] = 1.0
    logits[1, [9, 0]] = 2.0
    assert np.array_equal(_t(logits).argmax(-1).numpy(), np.asarray(jnp.argmax(logits, -1)))


# ---------------------------------------------------------------- switches


def test_bf16_switches(monkeypatch):
    """REPRO_ATTN_DTYPE=bf16 (the reference's module switch, read at each
    call by the port) and REPRO_SSD_DTYPE=bf16 with REPRO_SSD_CHUNK=4 (read
    at call time by both), on bf16 activations and caches."""
    monkeypatch.setattr(RL, "_ATTN_DT", "bf16")
    monkeypatch.setenv("REPRO_ATTN_DTYPE", "bf16")
    rng = np.random.default_rng(9)
    D, H, G, dh = 32, 4, 2, 8
    p = _attn_params(rng, D, H, G, dh)
    x = _normal(rng, 2, 12, D)
    bf = torch.bfloat16
    kw = dict(n_heads=H, n_kv=G, d_head=dh, return_cache=True)
    pp = {k: _t(v, bf) for k, v in p.items()}
    rp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    y, c = PL.attention(pp, _t(x, bf), **kw)
    ry, rc = _ref(RL.attention, rp, jnp.asarray(x, jnp.bfloat16), **kw)
    _close(y, np.asarray(ry, np.float32), **BF16)
    cache = {k: F.pad(v, (0, 0, 0, 0, 0, 4)) for k, v in c.items()}
    rcache = {k: jnp.pad(v, ((0, 0), (0, 4), (0, 0), (0, 0))) for k, v in rc.items()}
    xd = _normal(rng, 2, 1, D)
    kw.pop("return_cache")
    with torch.no_grad():
        y, _ = PL.decode_attention(pp, _t(xd, bf), cache, 12, **kw)
    ry, _ = _ref(RL.decode_attention, rp, jnp.asarray(xd, jnp.bfloat16), rcache, jnp.int32(12),
                 **kw)
    _close(y, np.asarray(ry, np.float32), **BF16)

    monkeypatch.setenv("REPRO_SSD_DTYPE", "bf16")
    monkeypatch.setenv("REPRO_SSD_CHUNK", "4")
    args = _ssd_inputs(np.random.default_rng(10), S=13)
    Y, h = PMA._ssd_chunked(*map(_t, args), chunk=8)
    rY, rh = _ref(RMA._ssd_chunked, *args, chunk=8)
    _close(Y, rY, **BF16)
    _close(h, rh, **BF16)



# ---------------------------------------------------------------- whole model


def _model_inputs(cfg, seed=0, B=2, S=24):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    pe = _normal(rng, B, cfg.n_prefix, cfg.d_model) if cfg.n_prefix else None
    return tokens, pe


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss(arch):
    """forward's logits and aux, and loss_fn's value, at smoke width for
    every architecture (prefix embeddings for the audio and vision stubs)."""
    cfg = RC.ARCHS[arch].smoke()
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    tokens, pe = _model_inputs(cfg)
    batch = {"tokens": tokens} if pe is None else {"tokens": tokens, "prefix_embeds": pe}
    # one program for both, so XLA compiles the shared forward once
    (rl, raux, _), (rloss, rm) = jax.jit(lambda p, b: (
        RM.forward(cfg, p, b["tokens"], prefix_embeds=b.get("prefix_embeds"), remat=False),
        RM.loss_fn(cfg, p, b, remat=False)))(params, batch)

    pcfg = PC.ARCHS[arch].smoke()
    model = from_reference_params(pcfg, jax.tree.map(np.asarray, params), device="cpu")
    tt = _t(tokens).long()
    pbatch = {k: (tt if k == "tokens" else _t(v)) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux, caches = forward(pcfg, model, tt, prefix_embeds=pbatch.get("prefix_embeds"))
        loss, m = loss_fn(pcfg, model, pbatch)
    assert caches is None
    assert logits.shape == rl.shape
    _close(logits, rl, rtol=1e-4, atol=1e-3)
    _close(aux, raux)
    _close(loss, rloss)
    _close(m["ce"], rm["ce"])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-1b-a400m", "mamba2-2.7b"])
def test_forward_bf16(arch):
    """The casts of a bf16 model (the full configs' dtype) follow the
    reference's: the port's logits stray from the reference's no further
    than the reference's own bf16 logits stray from its float32 run on the
    same weights, and within 2 % in relative L2 (measured 0.9-1.3 %)."""
    cfg = dataclasses.replace(RC.ARCHS[arch].smoke(), dtype="bfloat16")
    params = RM.init_params(cfg, jax.random.PRNGKey(1))
    tokens, _ = _model_inputs(cfg, seed=1)
    run = jax.jit(lambda c, p, t: RM.forward(c, p, t, remat=False)[0], static_argnums=0)
    rl = np.asarray(run(cfg, params, tokens), np.float32)
    r32 = np.asarray(run(RC.ARCHS[arch].smoke(),
                         jax.tree.map(lambda a: a.astype(jnp.float32), params), tokens))
    pcfg = dataclasses.replace(PC.ARCHS[arch].smoke(), dtype="bfloat16")
    model = from_reference_params(pcfg, jax.tree.map(np.asarray, params), device="cpu")
    assert model.embed.dtype == torch.bfloat16 and model.final_norm.dtype == torch.float32
    with torch.no_grad():
        logits, _, _ = forward(pcfg, model, _t(tokens).long())
    assert logits.dtype == torch.bfloat16
    got = logits.float().numpy()
    assert np.abs(got - rl).max() <= np.abs(rl - r32).max()
    assert np.linalg.norm(got - rl) <= 0.02 * np.linalg.norm(rl)
