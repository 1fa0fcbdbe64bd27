"""Shared helpers of the port's mesh tests (``test_torch_mesh*.py``): the
reference's sharded programs run in background subprocesses with 8 host
devices (its ``make_mesh`` takes the first ``prod(shape)``), side by side,
each writing its outputs to one ``.npz``; the inputs are made from a
numpy seed in the test process and handed over in ``inputs.npz``.  The
model check at a 2x2 mesh is shared by the MoE and the SSM files."""

import os
import subprocess
import sys

import jax
import numpy as np

import repro.configs as RC
import repro.models.model as RM
import repro_torch.configs as PC
from _subproc import SRC
from _torch_lm import (GRAD_REL_L2, LOSS_RTOL, inputs, leaf_errors, port_batch, port_model,
                       port_value_and_grad)
from repro_torch.launch import make_mesh
from repro_torch.models import loss_fn, params_to_reference

MESHES = {"2x4": ((2, 4), ("data", "model")), "1x4": ((1, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}

HEAD = """
import numpy as np
import jax, jax.numpy as jnp
inp = np.load(DIR + "/inputs.npz")
out = {}
flat = lambda tree: [np.asarray(a) for a in jax.tree.leaves(tree)]
"""


def cpu_mesh(shape, axes=("data", "model")):
    """The port's mesh of ``shape`` with every coordinate on the CPU."""
    return make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))


class RefJobs:
    """Reference jobs (name -> code; ``consts`` prefixed, ``inp`` the
    inputs, ``out`` the dict each saves) started in the background while
    the port-only tests run; :meth:`get` waits for all and merges."""

    def __init__(self, d, inputs: dict, jobs: dict, consts: dict):
        np.savez(d / "inputs.npz", **inputs)
        self.inputs, self.dir = inputs, d
        head = f"DIR = {str(d)!r}\n" + "".join(f"{k} = {v!r}\n" for k, v in consts.items())
        env = dict(os.environ, PYTHONPATH=SRC,
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
        self.jobs = []
        for name, body in jobs.items():
            log = open(d / f"{name}.log", "w+")
            code = head + HEAD + body + f"\nnp.savez(DIR + '/{name}.npz', **out)\n"
            proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=log,
                                    stderr=subprocess.STDOUT)
            self.jobs.append((name, proc, log))
        self.out = None

    def get(self) -> dict:
        if self.out is None:
            out = {}
            for name, proc, log in self.jobs:
                rc = proc.wait(timeout=900)
                log.seek(0)
                assert rc == 0, f"reference job {name} failed:\n{log.read()}"
                with np.load(self.dir / f"{name}.npz") as z:
                    out.update(z)
            self.out = out
        return self.out

    def close(self):
        for _, proc, log in self.jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


#: the reference's loss and gradients of ARCHS at a 2x2 mesh
REF_GRADS = """
import repro.configs as RC
import repro.models.model as RM
from repro.launch.mesh import make_mesh

mesh = make_mesh((2, 2), ("data", "model"))
for arch in ARCHS:
    cfg = RC.ARCHS[arch].smoke()
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    batch = {k[len(arch) + 1:]: jnp.asarray(v) for k, v in inp.items() if k.startswith(arch + "_")}
    (l, m), g = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(cfg, p, b, mesh=mesh, remat=True), has_aux=True))(params, batch)
    out[arch + "_loss"], out[arch + "_ce"], out[arch + "_aux"] = l, m["ce"], m["aux"]
    for i, a in enumerate(flat(g)):
        out[f"{arch}_grad_{i}"] = a
"""


def model_batches(archs) -> dict:
    """Each arch's smoke batch from a numpy seed, keyed ``<arch>_<name>``."""
    return {f"{arch}_{k}": v for arch in archs for k, v in inputs(RC.ARCHS[arch].smoke()).items()}


def ref_tree(like, flat):
    """A reference tree shaped like ``like`` from its flattened leaves."""
    return jax.tree.unflatten(jax.tree.structure(like), list(flat))


def check_model_at_mesh(ref, arch, grad_tol=None):
    """The loss, CE, aux loss and every gradient leaf of ``arch``'s smoke
    config under ``loss_fn`` at a 2x2 mesh of CPU coordinates (the MoE
    layers through ``moe_ep``) against the reference's
    ``jax.value_and_grad(loss_fn(mesh=...))`` from job ``REF_GRADS``; the
    dense MoE's loss differs (per-shard routing, capacity and aux)."""
    cfg, pcfg = RC.ARCHS[arch].smoke(), PC.ARCHS[arch].smoke()
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    batch = {k[len(arch) + 1:]: v for k, v in ref.inputs.items() if k.startswith(arch + "_")}
    model = port_model(pcfg, params)
    loss, m = loss_fn(pcfg, model, port_batch(batch), mesh=cpu_mesh((2, 2)), remat=True)
    loss.backward()
    grads = params_to_reference(pcfg, {k: p.grad for k, p in model.named_parameters()})
    out = ref.get()
    np.testing.assert_allclose(float(loss.detach()), float(out[arch + "_loss"]), rtol=LOSS_RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(m[k].detach()), float(out[f"{arch}_{k}"]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    n = sum(1 for k in out if k.startswith(arch + "_grad_"))
    errs = leaf_errors(ref_tree(params, [out[f"{arch}_grad_{i}"] for i in range(n)]), grads)
    assert max(errs.values()) <= (grad_tol or GRAD_REL_L2), errs
    dense, _, _ = port_value_and_grad(pcfg, port_model(pcfg, params), batch, remat=True)
    assert float(dense) != float(loss.detach())
