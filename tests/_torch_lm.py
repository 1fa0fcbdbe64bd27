"""Shared helpers of the port's LM training parity tests: seeded inputs,
the reference's jitted loss and gradients, the port's, and the per-leaf
relative L2 distance between two parameter-shaped trees in the
reference's layout."""

import functools

import jax
import numpy as np
import torch

import repro.configs as RC
import repro.models.model as RM
import repro_torch.configs as PC
from repro_torch.models import from_reference_params, loss_fn, params_to_reference


#: the loss, CE and aux loss against the reference's
LOSS_RTOL = 1e-5
#: every gradient leaf's relative L2 against the reference's
GRAD_REL_L2 = 3e-5


def inputs(cfg, B=2, S=24, seed=0):
    """A numpy batch: tokens and, for a prefix config, prefix embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.n_prefix:
        out["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    return out


def port_batch(batch, device="cpu"):
    out = {k: torch.from_numpy(np.array(v)).to(device) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


@functools.lru_cache(maxsize=None)
def ref_value_and_grad(cfg, remat: bool):
    """The reference's ``value_and_grad(loss_fn)``, jitted once per config."""
    return jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(cfg, p, b, remat=remat), has_aux=True))


def port_model(pcfg, params):
    return from_reference_params(pcfg, jax.tree.map(np.asarray, params), device="cpu")


def port_value_and_grad(pcfg, model, batch, remat: bool):
    """(loss, metrics, gradients in the reference's layout) of the port."""
    for p in model.parameters():
        p.grad = None
    loss, metrics = loss_fn(pcfg, model, port_batch(batch), remat=remat)
    loss.backward()
    grads = params_to_reference(pcfg, {k: p.grad for k, p in model.named_parameters()})
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def leaf_errors(want, got):
    """{path: relative L2 of got against want} over the leaves of two trees
    of one structure."""
    assert jax.tree.structure(jax.tree.map(np.asarray, want)) == jax.tree.structure(got)
    out = {}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        out[jax.tree_util.keystr(path)] = float(np.linalg.norm(a - b) / np.linalg.norm(a))
    return out


def check_arch(arch, remat, grad_tol=GRAD_REL_L2):
    """The loss and every gradient leaf of ``arch``'s smoke config against
    the reference; with ``remat`` the port's gradients also equal its own
    without remat bit for bit.  Returns the per-leaf errors."""
    cfg, pcfg = RC.ARCHS[arch].smoke(), PC.ARCHS[arch].smoke()
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    batch = inputs(cfg)
    (rl, rm), rg = ref_value_and_grad(cfg, remat)(params, batch)
    model = port_model(pcfg, params)
    loss, m, g = port_value_and_grad(pcfg, model, batch, remat)
    np.testing.assert_allclose(float(loss), float(rl), rtol=LOSS_RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=LOSS_RTOL, atol=1e-7)
    errs = leaf_errors(rg, g)
    bad = {k: e for k, e in errs.items() if not e <= grad_tol}
    assert not bad, (arch, remat, bad)
    if remat:
        _, _, g0 = port_value_and_grad(pcfg, model, batch, remat=False)
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g)))
    return errs
