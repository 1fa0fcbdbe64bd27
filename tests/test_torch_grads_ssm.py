"""The port's training gradients on the Mamba-2 stacks (mamba2-2.7b, the
jamba hybrid) against the reference's on the CPU, in float32 at smoke
width with ``remat`` on and off, and the SSD repair: at the chunk length
of the full-width configs (256) the reference's gradients are non-finite
and the port's are finite and equal its own at the smoke chunk (16).

Tolerances as in ``test_torch_grads.py`` (loss within rtol 1e-5, every
gradient leaf within a relative L2 of 3e-5; mamba2 measured at most
6.0e-6), except jamba's leaves, held to 5e-4: measured 2.3e-4, and the
reference's own gradients move by more than 1e-4 when its embedding
table gets half-ulp noise (2.1e-4 measured): rounding grows through its
14 random-weight SSD layers, while every layer alone agrees to 2e-6.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.model as RM
import repro_torch.configs as PC
from _torch_lm import (LOSS_RTOL, check_arch, inputs, leaf_errors, port_model,
                       port_value_and_grad, ref_value_and_grad)

torch.set_num_threads(1)

JAMBA = "jamba-1.5-large-398b"
JAMBA_REL_L2 = 5e-4


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_mamba2_grads_match_reference(remat):
    check_arch("mamba2-2.7b", remat)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_jamba_grads_match_reference(remat):
    check_arch(JAMBA, remat, grad_tol=JAMBA_REL_L2)


def test_jamba_reference_spread_under_half_ulp_noise():
    """What sets jamba's limit: the reference against itself, its
    embedding table perturbed by half an ulp of each entry."""
    cfg = RC.ARCHS[JAMBA].smoke()
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    batch = inputs(cfg)
    f = ref_value_and_grad(cfg, False)
    _, g0 = f(params, batch)
    e = np.asarray(params["embed"])
    rng = np.random.default_rng(0)
    noisy = dict(params, embed=e + (rng.standard_normal(e.shape) * np.abs(e) * 2.0 ** -24)
                 .astype(np.float32))
    _, g1 = f(noisy, batch)
    spread = max(leaf_errors(g0, jax.tree.map(np.asarray, g1)).values())
    assert 1e-4 < spread < JAMBA_REL_L2, spread


def _chunked(arch, chunk):
    out = []
    for C in (RC, PC):
        cfg = C.ARCHS[arch].smoke()
        out.append(dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=chunk)))
    return out


def test_ssd_long_chunk_gradients_are_finite():
    """mamba2 at chunk 256, sequence 256: the reference exponentiates the
    whole (Q, Q) decay matrix before masking its upper triangle, where the
    exponent passes 88 and exp gives inf; the mask's backward then sends
    0 * inf = NaN into every gradient upstream.  The port masks the exponent
    first: the same loss, finite gradients, and those equal the port's own
    at chunk 16 (the same function, chunked otherwise)."""
    cfg, pcfg = _chunked("mamba2-2.7b", 256)
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    batch = inputs(cfg, B=2, S=256)
    (rl, _), rg = ref_value_and_grad(cfg, False)(params, batch)
    bad = sum(int((~np.isfinite(np.asarray(a))).sum()) for a in jax.tree.leaves(rg))
    assert bad > 0 and np.isfinite(float(rl))

    model = port_model(pcfg, params)
    loss, _, g = port_value_and_grad(pcfg, model, batch, remat=True)
    assert all(np.isfinite(a).all() for a in jax.tree.leaves(g))
    np.testing.assert_allclose(float(loss), float(rl), rtol=LOSS_RTOL)
    _, pcfg16 = _chunked("mamba2-2.7b", 16)
    loss16, _, g16 = port_value_and_grad(pcfg16, model, batch, remat=True)
    np.testing.assert_allclose(float(loss), float(loss16), rtol=LOSS_RTOL)
    errs = leaf_errors(g16, g)
    assert max(errs.values()) <= 1e-4, errs
