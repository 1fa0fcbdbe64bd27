"""The port's training gradients against the reference's on the CPU, in
float32 at smoke width, the reference's weights carried into the port:
``loss.backward()`` on ``repro_torch.models.loss_fn`` against
``jax.value_and_grad(repro.models.model.loss_fn)``, with ``remat`` on and
off, for the eight attention architectures (the SSM ones are in
``test_torch_grads_ssm.py``), and the blocks where JAX's and autograd's
derivatives could part: the query-chunked attention's short last chunk,
the sliding window, the top-k router's sort and scatter, the dense MoE.

Tolerances: the loss, CE and aux loss within rtol 1e-5; every gradient
leaf within a relative L2 of 3e-5 (measured at most 2.7e-6, gemma3's
remainder layer; five times the worst of the mamba2 stack's 6.0e-6 in
the SSM file); a block's input and parameter gradients within rtol /
atol 1e-5.  Rematerialization changes no bit of the port's gradients.
"""

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.layers as RL
import repro.models.moe as RMOE
import repro_torch.models.layers as PL
import repro_torch.models.moe as PMOE
from _torch_lm import check_arch

torch.set_num_threads(1)

ATTN_ARCHS = sorted(a for a in RC.ARCHS if a not in ("mamba2-2.7b", "jamba-1.5-large-398b"))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    check_arch(arch, remat)


def _vjp_close(ref_fn, port_fn, args, ct):
    """Input and parameter gradients of one block under the cotangent
    ``ct``: the reference's ``jax.vjp`` against autograd."""
    ry, vjp = jax.vjp(ref_fn, *args)
    rgrads = vjp(ct)
    targs = [jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), a)
             for a in args]
    y = port_fn(*targs)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry), rtol=1e-5, atol=1e-5)
    y.backward(torch.from_numpy(ct))
    for ta, ra in zip(targs, rgrads):
        for t, r in zip(jax.tree.leaves(ta), jax.tree.leaves(ra)):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("S,q_chunk,window", [(21, 8, None), (21, 8, 6), (24, 1024, 8)],
                         ids=["ragged", "ragged-window", "window"])
def test_attention_grads(S, q_chunk, window):
    """Causal attention's gradients with a short last query chunk, with
    and without a sliding window."""
    rng = np.random.default_rng(S + q_chunk)
    D, H, G, dh = 32, 4, 2, 8
    p = {"wq": _normal(rng, D, H * dh, scale=D ** -0.5), "wk": _normal(rng, D, G * dh, scale=D ** -0.5),
         "wv": _normal(rng, D, G * dh, scale=D ** -0.5), "wo": _normal(rng, H * dh, D, scale=D ** -0.5),
         "bq": _normal(rng, H * dh, scale=0.1), "bk": _normal(rng, G * dh, scale=0.1),
         "bv": _normal(rng, G * dh, scale=0.1)}
    x = _normal(rng, 2, S, D)
    kw = dict(n_heads=H, n_kv=G, d_head=dh, rope_theta=1e6, window=window, q_chunk=q_chunk)
    _vjp_close(jax.jit(lambda p, x: RL.attention(p, x, **kw)[0]),
               lambda p, x: PL.attention(p, x, **kw)[0], (p, x), _normal(rng, 2, S, D))


def test_moe_grads():
    """The dense MoE's gradients through the router's top-k (stable sort,
    scatter into the gate) and the aux loss, with a tie between two
    experts' probabilities in some rows (a zero router column)."""
    rng = np.random.default_rng(5)
    D, F, E, k = 16, 24, 4, 2
    p = {"router": _normal(rng, D, E, scale=D ** -0.5), "w_up": _normal(rng, E, D, F, scale=0.2),
         "w_gate": _normal(rng, E, D, F, scale=0.2), "w_down": _normal(rng, E, F, D, scale=0.2)}
    p["router"][:, 3] = p["router"][:, 1]
    x = _normal(rng, 2, 6, D)
    ct = _normal(rng, 2, 6, D)

    def ref(p, x):
        y, aux = RMOE.moe_dense(p, x, topk=k, glu=True, act="silu")
        return y + aux

    def port(p, x):
        y, aux = PMOE.moe_dense(p, x, topk=k, glu=True, act="silu")
        return y + aux

    _vjp_close(jax.jit(ref), port, (p, x), ct)
