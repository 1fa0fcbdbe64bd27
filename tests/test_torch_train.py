"""The port's train step (``repro_torch.launch.steps.make_train_step``)
against the reference's jitted ``make_train_step`` on a 1x1 mesh, on the
CPU in float32 at smoke width: a dense, an MoE and an SSM architecture,
with int8 gradient compression off and on, three steps on the data
pipeline's batches, the reference's weights and optimizer state carried
into the port (``repro_torch.models.opt_from_reference``).

Two comparisons per step.  Free-running, each package trains from the
same start: the losses agree within rtol 1e-5 (measured at most 4.3e-6,
mamba2 with compression).  From the same state, the port's step starts
from the reference's parameters and optimizer state before that step and
is held against the reference's result:
- loss and CE within rtol 1e-5; ``gnorm`` within rtol 1e-5 (1e-4 with
  compression: a rounding flip in the quantizer moves one element by a
  quantum; measured 8.7e-7 and 8.5e-6);
- parameters and master by relative L2, every leaf within 1e-2 and all
  leaves together within 1e-5 (1e-4 with compression).  Adam divides each
  element by its own gradient's magnitude, so an element whose gradient
  is at rounding level moves by up to 2 x lr either way (measured: 2.5e-3
  on qwen's key bias, whose gradient nearly cancels; every other leaf at
  most 6.2e-5), and a quantizer flip between 0 and one quantum turns an
  element's first step from 0 into lr (all leaves together: measured
  3.5e-5 with compression, mamba2; 1e-6 or less without);
- the moments by relative L2 per leaf within 1e-4 (measured 6.3e-6), and
  1e-2 with compression, where one flipped element of a 64-element leaf
  weighs (measured 9.0e-4);
- the residuals of the error feedback equal within 1e-3 of each leaf's
  largest residual, except for elements where a quantizer rounding
  flipped, at most one in 10,000 (measured 0-3 of 73,504-140,096).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.launch.steps as RS
import repro.models.model as RM
import repro.optim as RO
import repro_torch.configs as PC
from _torch_lm import LOSS_RTOL, leaf_errors, port_batch, port_model
from repro.launch.mesh import make_mesh
from repro_torch.data import TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import opt_from_reference, opt_to_reference, params_to_reference
from repro_torch.optim import AdamWState

torch.set_num_threads(1)

ARCHS = ("qwen2.5-3b", "granite-moe-1b-a400m", "mamba2-2.7b")
LR = 1e-3
LEAF_REL_L2 = 1e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _total_rel(want, got):
    a = np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(want)])
    b = np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(got)])
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _flips(want, got):
    """(elements of the residuals off by more than 1e-3 of their leaf's
    largest residual, all elements)."""
    n = tot = 0
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        a = np.asarray(a)
        n += int((np.abs(a - b) > 1e-3 * np.abs(a).max()).sum())
        tot += a.size
    return n, tot


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, compress):
    cfg, pcfg = RC.ARCHS[arch].smoke(), PC.ARCHS[arch].smoke()
    step, _, _ = RS.make_train_step(cfg, make_mesh((1, 1), ("data", "model")), lr=LR,
                                    remat=True, compress_grads=compress)
    ref_step = jax.jit(step)
    port_step = make_train_step(pcfg, lr=LR, remat=True, compress_grads=compress)
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    opt = RO.adamw_init(params)
    if compress:
        opt = (opt, RO.ef_init(params))
    free, free_opt = port_model(pcfg, params), opt_from_reference(pcfg, _np(opt), "cpu")
    pipe = TokenPipeline(vocab=cfg.vocab, batch=4, seq=32, seed=0, n_prefix=cfg.n_prefix,
                         d_model=cfg.d_model)
    for s in range(3):
        batch = pipe.batch_at(s)
        model, popt = port_model(pcfg, params), opt_from_reference(pcfg, _np(opt), "cpu")
        params, opt, rm = ref_step(params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
        model, popt, pm = port_step(model, popt, port_batch(batch))
        free, free_opt, fm = port_step(free, free_opt, port_batch(batch))
        for m in (pm, fm):
            np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=LOSS_RTOL)
            np.testing.assert_allclose(float(m["ce"]), float(rm["ce"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pm["gnorm"]), float(rm["gnorm"]),
                                   rtol=1e-4 if compress else 1e-5)

        got = opt_to_reference(pcfg, popt)
        (st, pst) = (opt[0], got[0]) if compress else (opt, got)
        assert isinstance(popt[0] if compress else popt, AdamWState)
        assert int(pst.step) == int(st.step) == s + 1
        for want, have in ((params, params_to_reference(pcfg, model)), (st.master, pst.master)):
            errs = leaf_errors(want, have)
            assert max(errs.values()) <= LEAF_REL_L2, (s, errs)
            assert _total_rel(want, have) <= (1e-4 if compress else 1e-5), s
        for f in ("mu", "nu"):
            errs = leaf_errors(getattr(st, f), getattr(pst, f))
            assert max(errs.values()) <= (1e-2 if compress else 1e-4), (s, f, errs)
        if compress:
            n, tot = _flips(opt[1], got[1])
            assert n <= tot // 10_000, (s, n, tot)
