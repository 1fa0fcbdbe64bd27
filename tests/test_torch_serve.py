"""The port's LM serving path (``repro_torch.models`` prefill, caches and
decode, ``repro_torch.launch.serve``) against the reference's on the CPU,
with the reference's weights carried into the port, in float32 at smoke
width.

Tolerances: logits within rtol 1e-4 / atol 1e-3 and caches within rtol
1e-4 / atol 1e-3 of the reference (reordered float32 sums through up to 16
layers); greedy tokens equal exactly.  The reference's functions run
jitted (eager JAX compiles op by op).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.launch.serve as RS
import repro.models.model as RM
import repro_torch.configs as PC
import repro_torch.launch.serve as PS
from repro_torch.models import (caches_from_reference, caches_to_reference, decode_step,
                                forward, from_reference_params, init_caches, init_params,
                                prefill)

torch.set_num_threads(1)

ARCHS = sorted(RC.ARCHS)
TOL = dict(rtol=1e-4, atol=1e-3)
STEPS = 4


def _close(got, want, **tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **(tol or TOL))


def _trees_close(got, want):
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        _close(a, b)


class _Ref:
    """The reference's serving functions for one smoke config, jitted once
    and shared by the tests of that architecture."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.params = RM.init_params(cfg, jax.random.PRNGKey(0))
        self.prefill = jax.jit(lambda p, t, e: RM.prefill(cfg, p, t, prefix_embeds=e))
        self.step = jax.jit(lambda p, t, c, pos: RM.decode_step(cfg, p, t, c, pos))
        self.forward = jax.jit(lambda p, t: RM.forward(cfg, p, t, remat=False)[0])

    def port(self, pcfg):
        return from_reference_params(pcfg, jax.tree.map(np.asarray, self.params), device="cpu")


@functools.lru_cache(maxsize=None)
def _ref(arch):
    return _Ref(RC.ARCHS[arch].smoke())


def _inputs(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    pe = (rng.standard_normal((B, cfg.n_prefix, cfg.d_model)).astype(np.float32)
          if cfg.n_prefix else None)
    return tokens, pe


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode(arch):
    """prefill's last logits and caches, pad_caches, four greedy decode
    steps (logits, tokens, caches), init_caches and one step from it, for
    every architecture at smoke width."""
    cfg, pcfg = RC.ARCHS[arch].smoke(), PC.ARCHS[arch].smoke()
    ref = _ref(arch)
    tokens, pe = _inputs(cfg)
    B, S = tokens.shape
    cur, max_len = S + cfg.n_prefix, S + cfg.n_prefix + STEPS + 1
    rlast, rc = ref.prefill(ref.params, tokens, pe)

    model = ref.port(pcfg)
    tpe = None if pe is None else torch.from_numpy(pe)
    last, caches = prefill(pcfg, model, torch.from_numpy(tokens).long(), prefix_embeds=tpe)
    _close(last, rlast)
    _trees_close(caches_to_reference(pcfg, caches), rc)

    rc = RS.pad_caches(cfg, rc, cur, max_len)
    caches = PS.pad_caches(pcfg, caches, cur, max_len)
    _trees_close(caches_to_reference(pcfg, caches), rc)
    rtok, tok = jnp.argmax(rlast, -1), last.argmax(-1)
    for i in range(STEPS):
        rlog, rc = ref.step(ref.params, rtok, rc, jnp.int32(cur + i))
        logits, caches = decode_step(pcfg, model, tok, caches, cur + i)
        _close(logits, rlog)
        rtok, tok = jnp.argmax(rlog, -1), logits.argmax(-1)
        assert np.array_equal(tok.numpy(), np.asarray(rtok)), (arch, i)
    _trees_close(caches_to_reference(pcfg, caches), rc)

    # zeroed caches of the padded shapes, and one step from them at pos 0
    rz = RM.init_caches(cfg, B, max_len)
    z = init_caches(pcfg, B, max_len, device="cpu")
    zt = caches_to_reference(pcfg, z)
    assert jax.tree.structure(zt) == jax.tree.structure(jax.tree.map(np.asarray, rz))
    for a, b in zip(jax.tree.leaves(zt), jax.tree.leaves(rz)):
        assert a.shape == b.shape and not a.any()
    assert [c["k"].dtype if "k" in c else c["h"].dtype for c in z] == \
        [torch.float32] * cfg.n_layers
    rlog, _ = ref.step(ref.params, jnp.asarray(tokens[:, 0]), rz, jnp.int32(0))
    logits, _ = decode_step(pcfg, model, torch.from_numpy(tokens[:, 0]).long(), z, 0)
    _close(logits, rlog)


def test_caches_carry_both_ways():
    """caches_from_reference and caches_to_reference invert each other on
    a hybrid stack (scanned units plus a remainder layer)."""
    cfg = PC.ARCHS["gemma3-27b"].smoke()          # 6-layer unit x 2 + 1 remainder
    tree = jax.tree.map(np.asarray, RM.init_caches(RC.ARCHS["gemma3-27b"].smoke(), 2, 12))
    tree = jax.tree.map(lambda a: np.random.default_rng(a.size).standard_normal(a.shape)
                        .astype(np.float32), tree)
    caches = caches_from_reference(cfg, tree, device="cpu")
    assert len(caches) == cfg.n_layers == 13
    assert caches[5]["k"].shape[1] == 12 and caches[0]["k"].shape[1] == 8
    back = caches_to_reference(cfg, caches)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)


def _ref_main_inputs(cfg, seed, B, S):
    """The reference main's own inputs: params, prompts and prefix
    embeddings all drawn from PRNGKey(seed)."""
    key = jax.random.PRNGKey(seed)
    params = RM.init_params(cfg, key)
    prompts = jax.random.randint(key, (B, S), 0, cfg.vocab)
    pe = (jax.random.normal(key, (B, cfg.n_prefix, cfg.d_model), jnp.float32)
          if cfg.n_prefix else None)
    return params, prompts, pe


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "musicgen-large"])
def test_serve_main_matches_reference(arch, monkeypatch, capsys):
    """``launch.serve.main`` on the CPU returns the reference main's tokens
    when it is handed the reference main's weights, prompts and prefix
    embeddings for the same seed, and prints the reference's three lines."""
    B, S, gen, seed = 2, 12, 6, 3
    argv = ["--arch", arch, "--smoke", "--batch", str(B), "--prompt-len", str(S),
            "--gen", str(gen), "--seed", str(seed)]
    want = np.asarray(RS.main(argv))
    params, prompts, pe = _ref_main_inputs(RC.ARCHS[arch].smoke(), seed, B, S)

    def carried(cfg, seed_, batch, prompt_len, device):
        assert (seed_, batch, prompt_len, device.type) == (seed, B, S, "cpu")
        return (from_reference_params(cfg, jax.tree.map(np.asarray, params), device),
                torch.from_numpy(np.array(prompts)).long(),
                None if pe is None else torch.from_numpy(np.array(pe)))

    monkeypatch.setattr(PS, "make_inputs", carried)
    capsys.readouterr()
    got = PS.main(argv + ["--device", "cpu"])
    assert got.shape == (B, gen)
    assert np.array_equal(got.numpy(), want)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"[prefill] {B}x{S} in ")
    assert lines[1].startswith(f"[decode] {gen - 1} steps in ") and lines[1].endswith("tok/s)")
    assert lines[2] == "[sample tokens] " + str(want[0][:16])


def test_serve_main_runs_its_own_weights(capsys):
    """Without carried weights main draws its own from the seed on the
    device asked for: the same seed gives the same tokens."""
    argv = ["--arch", "jamba-1.5-large-398b", "--smoke", "--batch", "2", "--prompt-len", "9",
            "--gen", "3", "--device", "cpu"]
    a, b = PS.main(argv), PS.main(argv)
    assert a.shape == (2, 3) and torch.equal(a, b)
    assert ((a >= 0) & (a < 256)).all()


def test_pad_caches_pads_attention_caches_by_name():
    """mamba2 at smoke width with a 16-token prompt: the Mamba state h is
    (units, B, H=16, P, N=16) and d_head is 16, so the reference's
    shape rule grows it along H, and its first decode step would fail.  The
    port grows attention K/V only (there are none here), leaves every shape
    as prefill made it, and serves: its steps equal the reference's
    decode_step on the unpadded caches."""
    cfg, pcfg = RC.ARCHS["mamba2-2.7b"].smoke(), PC.ARCHS["mamba2-2.7b"].smoke()
    ref = _ref("mamba2-2.7b")
    tokens, _ = _inputs(cfg, S=16)
    rlast, rc = ref.prefill(ref.params, tokens, None)
    h = rc["scan"][0]["h"]
    assert h.shape[2] == 16 == cfg.d_head == cfg.ssm.d_state
    grown = RS.pad_caches(cfg, rc, 16, 20)["scan"][0]["h"]
    assert grown.shape != h.shape and grown.shape[2] == 20

    model = ref.port(pcfg)
    last, caches = prefill(pcfg, model, torch.from_numpy(tokens).long())
    padded = PS.pad_caches(pcfg, caches, 16, 20)
    assert [{k: t.shape for k, t in c.items()} for c in padded] == \
        [{k: t.shape for k, t in c.items()} for c in caches]
    rtok, tok = jnp.argmax(rlast, -1), last.argmax(-1)
    for i in range(3):
        rlog, rc = ref.step(ref.params, rtok, rc, jnp.int32(16 + i))
        logits, padded = decode_step(pcfg, model, tok, padded, 16 + i)
        _close(logits, rlog)
        rtok, tok = jnp.argmax(rlog, -1), logits.argmax(-1)
        assert np.array_equal(tok.numpy(), np.asarray(rtok))


@pytest.mark.parametrize("S", [8, 10, 16])
def test_window_decode_keeps_reference_ring(S):
    """gemma3 at smoke width (window W = 8): decode at pos S after prefill
    and pad_caches equals the reference's decode for every S.  At S == W the
    window cache is grown too (decode attends to W + 1 keys), and at
    S = 10 prefill's slot order disagrees with the ring write at pos % W, so
    there both packages differ from forward over S + 1 tokens at the last
    position; at S = 16 (a multiple of W) they agree with it."""
    cfg, pcfg = RC.ARCHS["gemma3-27b"].smoke(), PC.ARCHS["gemma3-27b"].smoke()
    ref = _ref("gemma3-27b")
    tokens, _ = _inputs(cfg, B=2, S=S + 1, seed=S)
    rlast, rc = ref.prefill(ref.params, tokens[:, :S], None)
    rc = RS.pad_caches(cfg, rc, S, S + 2)
    rlog, _ = ref.step(ref.params, jnp.asarray(tokens[:, S]), rc, jnp.int32(S))
    full = np.asarray(ref.forward(ref.params, tokens))[:, -1]

    model = ref.port(pcfg)
    _, caches = prefill(pcfg, model, torch.from_numpy(tokens[:, :S]).long())
    caches = PS.pad_caches(pcfg, caches, S, S + 2)
    _trees_close(caches_to_reference(pcfg, caches), rc)
    logits, _ = decode_step(pcfg, model, torch.from_numpy(tokens[:, S]).long(), caches, S)
    _close(logits, rlog)
    with torch.no_grad():
        pfull = forward(pcfg, model, torch.from_numpy(tokens).long())[0][:, -1]
    _close(pfull, full)
    gap = float(np.abs(np.asarray(rlog) - full).max())
    if S % cfg.sliding_window == 0 and S > cfg.sliding_window:
        assert gap < 1e-3, gap
    else:
        assert gap > 0.1, gap
        assert float((logits - pfull).abs().max()) > 0.1


def test_serve_entry_points_need_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = PC.ARCHS["qwen2.5-3b"].smoke()
    gen = torch.Generator()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.main(["--smoke"])
    with pytest.raises(ValueError):
        init_params(cfg, gen, device="meta")
    assert init_params(cfg, gen, device="cpu").embed.device.type == "cpu"
