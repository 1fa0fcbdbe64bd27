"""The port's MoE models on a mesh against the reference on the CPU, in
float32 at smoke width: ``loss_fn`` and its gradients at a 2x2 mesh, where
every MoE layer runs ``moe_ep`` (granite, dbrx; jamba, with its SSD
layers, is in ``test_torch_mesh_ssm.py``), three ``make_train_step``
steps at 2x2, and ``launch.train.main(["--mesh", "2x2", ...])``.

The reference runs in two background subprocesses with 8 host devices
(``_torch_mesh.RefJobs``; its ``make_mesh((2, 2))`` takes the first 4):
the gradients with dbrx's train steps, and granite's train steps with
the reference main.  The weights are the reference's own (``PRNGKey(0)``,
the main's seed 2), carried by ``repro_torch.models.convert``; the
batches come from a numpy seed (``_torch_lm.inputs``) and the data
pipeline.  Tolerances are ``tests/test_torch_train.py``'s: loss, CE and
aux within rtol 1e-5, gradient leaves by relative L2 within 3e-5, the
parameters after a step within 1e-2 a leaf and 1e-5 all together, gnorm
rtol 1e-5, the main's losses rtol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.model as RM
import repro.optim as RO
import repro_torch.configs as PC
import repro_torch.launch.train as PT
import repro_torch.models.moe as PMOE
from _torch_lm import LOSS_RTOL, leaf_errors, port_batch, port_model
from _torch_mesh import (REF_GRADS, RefJobs, check_model_at_mesh, cpu_mesh, model_batches,
                         ref_tree)
from repro_torch.data import TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import from_reference_params, opt_from_reference, params_to_reference

torch.set_num_threads(1)

MODEL_ARCHS = STEP_ARCHS = ("granite-moe-1b-a400m", "dbrx-132b")
LR = 1e-3
MAIN_ARGV = ["--arch", "granite-moe-1b-a400m", "--smoke", "--mesh", "2x2", "--steps", "6",
             "--batch", "4", "--seq", "32", "--log-every", "3", "--seed", "2"]

#: three jitted train steps of STEPS at 2x2 (the state after each)
REF_STEPS = """
import repro.configs as RC
import repro.launch.steps as RS
import repro.models.model as RM
import repro.optim as RO
from repro.data import TokenPipeline
from repro.launch.mesh import make_mesh

mesh = make_mesh((2, 2), ("data", "model"))
for arch in STEPS:
    cfg = RC.ARCHS[arch].smoke()
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    opt = RO.adamw_init(params)
    step, _, _ = RS.make_train_step(cfg, mesh, lr=LR, remat=True)
    step = jax.jit(step)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=4, seq=32, seed=0, n_prefix=cfg.n_prefix,
                         d_model=cfg.d_model)
    for s in range(3):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(s).items()}
        params, opt, met = step(params, opt, batch)
        out[f"{arch}_step{s}_loss"], out[f"{arch}_step{s}_gnorm"] = met["loss"], met["gnorm"]
        for i, a in enumerate(flat((params, opt))):
            out[f"{arch}_step{s}_state_{i}"] = a
"""

REF_MAIN = """
import repro.launch.train as RT

out["main_losses"] = np.array(RT.main(MAIN_ARGV))
"""


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    jobs = {"grads": f"ARCHS = {MODEL_ARCHS!r}\nSTEPS = {STEP_ARCHS[1:]!r}\n"
                     + REF_GRADS + REF_STEPS,
            "steps": f"STEPS = {STEP_ARCHS[:1]!r}\n" + REF_STEPS + REF_MAIN}
    r = RefJobs(tmp_path_factory.mktemp("mesh_model_ref"), model_batches(MODEL_ARCHS), jobs,
                dict(LR=LR, MAIN_ARGV=MAIN_ARGV))
    yield r
    r.close()


def _total_rel(want, got):
    a = np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(want)])
    b = np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(got)])
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_at_mesh_2x2_matches_reference(ref, arch):
    """The loss, CE, aux loss and every gradient leaf of ``loss_fn`` at a
    2x2 mesh against the reference's (``_torch_mesh.check_model_at_mesh``)."""
    check_model_at_mesh(ref, arch)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_steps_at_mesh_2x2_match_reference(ref, arch):
    """Three ``make_train_step`` steps at a 2x2 mesh, each from the
    reference's state before it: loss and gnorm within rtol 1e-5, the
    parameters after it by relative L2 (1e-2 a leaf, 1e-5 all together),
    as ``tests/test_torch_train.py`` holds the 1x1 step."""
    cfg, pcfg = RC.ARCHS[arch].smoke(), PC.ARCHS[arch].smoke()
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    state = (params, RO.adamw_init(params))
    n = len(jax.tree.leaves(state))
    step = make_train_step(pcfg, cpu_mesh((2, 2)), lr=LR, remat=True)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=4, seq=32, seed=0, n_prefix=cfg.n_prefix,
                         d_model=cfg.d_model)
    out = ref.get()
    for s in range(3):
        model = port_model(pcfg, state[0])
        popt = opt_from_reference(pcfg, jax.tree.map(np.asarray, state[1]), "cpu")
        model, popt, m = step(model, popt, port_batch(pipe.batch_at(s)))
        np.testing.assert_allclose(float(m["loss"]), float(out[f"{arch}_step{s}_loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["gnorm"]), float(out[f"{arch}_step{s}_gnorm"]),
                                   rtol=1e-5)
        state = ref_tree(state, [out[f"{arch}_step{s}_state_{i}"] for i in range(n)])
        got = params_to_reference(pcfg, model)
        errs = leaf_errors(state[0], got)
        assert max(errs.values()) <= 1e-2, (s, errs)
        assert _total_rel(state[0], got) <= 1e-5, s


def test_train_main_mesh_2x2_matches_reference(ref, monkeypatch, capsys):
    """``launch.train.main([... "--mesh", "2x2", "--device", "cpu"])``
    handed the reference main's weights returns the reference main's
    losses within rtol 1e-5, every MoE layer through ``moe_ep`` on a 2x2
    mesh of CPU coordinates."""
    params = jax.tree.map(np.asarray, RM.init_params(
        RC.ARCHS["granite-moe-1b-a400m"].smoke(), jax.random.PRNGKey(2)))
    monkeypatch.setattr(PT, "make_state",
                        lambda cfg, seed, device: from_reference_params(cfg, params, device))
    meshes = []
    real = PMOE.moe_ep
    monkeypatch.setattr(PMOE, "moe_ep", lambda *a, **k: meshes.append(k["mesh"]) or real(*a, **k))
    got = PT.main(MAIN_ARGV + ["--device", "cpu"])
    assert "[done] first loss" in capsys.readouterr().out
    assert meshes and all(dict(m.shape) == {"data": 2, "model": 2} and
                          all(d.type == "cpu" for d in m.devices.flat) for m in meshes)
    np.testing.assert_allclose(got, ref.get()["main_losses"], rtol=1e-5)
