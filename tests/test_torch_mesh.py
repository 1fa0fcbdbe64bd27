"""The port's mesh and expert parallelism against the reference on the CPU,
in float32 at smoke width: named meshes, the sharding rules
(``param_pspecs``, ``norm_spec``, ``state_specs``), ``moe_ep`` against
the reference's ``shard_map`` version on 2x4, 1x4 and 2x2x2 meshes, and
the elastic reshard.  The model, its train step and ``launch.train --mesh
2x2`` are in ``test_torch_mesh_model.py``.

The reference's sharded programs run in three background subprocesses
with 8 host devices, one per mesh (``_torch_mesh.RefJobs``); the inputs
are made here from a numpy seed.  The port places its mesh coordinates
on ``["cpu"] * n``.  The port-only tests come first, so that they run
while the subprocesses do.

Tolerances: ``moe_ep``'s output, aux and gradients within 1e-5 (rtol and
atol) with the reference's drop set; ``moe_ep`` against ``moe_dense``
without drops within the reference's own 2e-4; shards bit for bit.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.launch.steps as RS
import repro.models.model as RM
import repro.models.sharding as RSH
import repro_torch.configs as PC
from _torch_mesh import MESHES, RefJobs, cpu_mesh
from repro.ckpt.elastic import _norm_spec as ref_norm_spec
from repro.models.moe import router_topk as ref_router_topk
from repro_torch.ckpt import reshard_restore, save, shardings_for
from repro_torch.launch import make_mesh, make_production_mesh
from repro_torch.launch.steps import norm_spec, state_specs
from repro_torch.models import reference_leaves
from repro_torch.models.model import LM
from repro_torch.models.moe import moe_dense, moe_ep
from repro_torch.models.sharding import DP, TP, P, NamedSharding, act_specs, param_pspecs, wsc

torch.set_num_threads(1)

E, D, F, K = 8, 32, 64, 2
#: case -> (input, capacity factor): a (4, 16) batch at three capacities,
#: a decode-shaped (4, 1) one and a batch of 3 that no data axis divides
CASES = {"c8": ("x", 8.0), "c1.25": ("x", 1.25), "c0.5": ("x", 0.5),
         "decode": ("x_s1", 1.25), "b3": ("x_b3", 0.5)}

#: the reference's moe_ep on one mesh: each case's output, aux and
#: gradients under jax.value_and_grad
REF_MOE = """
from repro.launch.mesh import make_mesh
from repro.models.moe import moe_ep

p = {k: jnp.asarray(inp[k]) for k in ("router", "w_up", "w_gate", "w_down")}
mesh = make_mesh(SHAPE, AXES)
for cname, (xk, cf) in CASES.items():
    ct = jnp.asarray(inp["ct_" + xk])

    def f(p, x, cf=cf, ct=ct):
        y, aux = moe_ep(p, x, mesh=mesh, topk=K, n_experts=E, capacity_factor=cf,
                        dp_axes=AXES[:-1])
        return jnp.sum(y * ct) + 0.37 * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        p, jnp.asarray(inp[xk]))
    key = MNAME + "_" + cname
    out[key + "_y"], out[key + "_aux"], out[key + "_gx"] = y, aux, gx
    for n, g in gp.items():
        out[key + "_g_" + n] = g
"""

#: the reference's elastic test, with the block each device of the new
#: mesh holds: rows of (mesh coordinate, start and stop per axis)
REF_ELASTIC = """
from jax.sharding import PartitionSpec as P
from repro.ckpt import save
from repro.ckpt.elastic import reshard_restore
from repro.launch.mesh import make_mesh

t = {"w": jnp.arange(64.0).reshape(8, 8), "v": jnp.arange(48.0).reshape(6, 8)}
specs = {"w": P("data", "model"), "v": P("data", "model")}
save(DIR + "/ckpt", 0, t, {"step": 0})
for shape in ((2, 4), (4, 2)):
    mesh = make_mesh(shape, ("data", "model"))
    got, _ = reshard_restore(DIR + "/ckpt", 0, t, specs, mesh)
    where = {d.id: c for c, d in np.ndenumerate(mesh.devices)}
    for name, arr in got.items():
        np.testing.assert_array_equal(np.asarray(arr), np.asarray(t[name]))
        out[f"elastic_{shape[0]}x{shape[1]}_{name}"] = np.array([
            list(where[s.device.id]) + [b for sl, n in zip(s.index, arr.shape)
                                        for b in (sl.start or 0, n if sl.stop is None else sl.stop)]
            for s in arr.addressable_shards])
"""


def _inputs():
    """MoE weights, inputs and cotangents from a numpy seed."""
    rng = np.random.default_rng(0)
    n = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    out = {"router": n(D, E, scale=D ** -0.5), "w_up": n(E, D, F, scale=D ** -0.5),
           "w_gate": n(E, D, F, scale=D ** -0.5), "w_down": n(E, F, D, scale=F ** -0.5)}
    for key, (B, S) in (("x", (4, 16)), ("x_s1", (4, 1)), ("x_b3", (3, 16))):
        out[key], out["ct_" + key] = n(B, S, D), n(B, S, D)
    return out


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    """One job per mesh, the elastic test beside the 1x4 one."""
    jobs = {f"moe_{m}": f"SHAPE, AXES, MNAME = {shape!r}, {axes!r}, {m!r}\n" + REF_MOE
            for m, (shape, axes) in MESHES.items()}
    jobs["moe_1x4"] += REF_ELASTIC
    r = RefJobs(tmp_path_factory.mktemp("mesh_ref"), _inputs(), jobs,
                dict(CASES=CASES, E=E, K=K))
    yield r
    r.close()


def _cpu_mesh(name):
    return cpu_mesh(*MESHES[name])


# --------------------------------------------------------------------------
# port-only checks (they run while the reference's subprocess does)
# --------------------------------------------------------------------------


def test_named_mesh_and_production_mesh():
    """A named mesh assigns devices row-major and cyclically; the
    production meshes have the reference's shapes and, on the ``meta``
    device, allocate nothing."""
    mesh = make_mesh((2, 3), ("data", "model"), ["cpu", "meta"])
    assert list(mesh.shape.items()) == [("data", 2), ("model", 3)]
    assert mesh.axis_names == ("data", "model") and mesh.devices.shape == (2, 3)
    assert [mesh.device(c).type for c in mesh.coords()] == ["cpu", "meta"] * 3
    assert mesh.device((1, 0)) == torch.device("meta")
    for multi_pod, shape in ((False, {"data": 16, "model": 16}),
                             (True, {"pod": 2, "data": 16, "model": 16})):
        pm = make_production_mesh(multi_pod=multi_pod, devices=["meta"])
        assert dict(pm.shape) == shape and list(pm.shape) == list(shape)
        assert all(d.type == "meta" for d in pm.devices.flat)
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data", "data"), ["cpu"])


def test_wsc_and_named_sharding():
    """``wsc`` returns its input and rejects an axis the mesh lacks;
    ``NamedSharding`` gives each coordinate its block, the first of a
    tuple of axes major, and refuses a split that does not divide."""
    mesh = _cpu_mesh("2x2x2")
    x = torch.arange(6.0)
    assert wsc(x, P(("pod", "data"), None), mesh) is x
    assert wsc(x, P("nope"), None) is x
    with pytest.raises(ValueError):
        wsc(x, P("nope"), mesh)
    sh = NamedSharding(mesh, P(("pod", "data"), "model"))
    assert sh.shard_shape((8, 6)) == (2, 3)
    assert sh.index((1, 0, 1), (8, 6)) == (slice(4, 6), slice(3, 6))
    assert sh.index((0, 1, 0), (8, 6)) == (slice(2, 4), slice(0, 3))
    with pytest.raises(ValueError):
        sh.shard_shape((6, 6))


def _ref_specs(cfg, multi_pod):
    """The reference's ``param_pspecs`` over its abstract parameters, as
    (path -> spec, path -> shape) with the port's dotted paths
    (``scan.0.attn.wq``)."""
    ap = jax.eval_shape(lambda k: RM.init_params(cfg, k), jax.random.PRNGKey(0))
    specs = RSH.param_pspecs(ap, multi_pod)

    def path(p):
        return ".".join(str(getattr(q, "key", getattr(q, "idx", None))) for q in p)

    shapes = {path(p): a.shape for p, a in jax.tree_util.tree_leaves_with_path(ap)}
    specs = {path(p): tuple(s) for p, s in jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))}
    return specs, shapes


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", sorted(RC.ARCHS))
def test_param_pspecs_match_reference(arch, multi_pod):
    """Every parameter's spec equals the reference's for the leaf that
    holds it, without the stacked leaf's leading ``None``."""
    pcfg = PC.ARCHS[arch].smoke()
    specs, _ = _ref_specs(RC.ARCHS[arch].smoke(), multi_pod)
    got = param_pspecs(LM(pcfg, device=torch.device("meta")), multi_pod)
    leaves = reference_leaves(pcfg)
    assert list(got) == list(leaves)
    for name, spec in got.items():
        want = specs[leaves[name]]
        if leaves[name].startswith("scan."):
            assert want[0] is None
            want = want[1:]
        assert isinstance(spec, P) and tuple(spec) == want, (name, spec, want)
    assert {k: tuple(v) for k, v in act_specs(multi_pod).items()} == \
        {k: tuple(v) for k, v in RSH.act_specs(multi_pod).items()}
    assert (DP(multi_pod), TP) == (RSH.DP(multi_pod), RSH.TP)


def test_norm_spec_matches_reference():
    """``norm_spec`` drops every axis that does not divide, tuples of axes
    included, as the reference's does (a stand-in mesh carries its
    ``.shape``)."""
    fake = SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16})
    cases = [(P("data", "model"), (32, 48)), (P("model", "data"), (49155, 1024)),
             (P(("pod", "data"), "model"), (64, 8)), (P(("pod", "data"), None), (48, 8)),
             (P("model"), (16, 3, 5)), (P(None, "data", "model"), (4, 16, 7))]
    for spec, shape in cases:
        want = RS.norm_spec(jax.sharding.PartitionSpec(*spec), shape, fake)
        assert tuple(norm_spec(spec, shape, fake)) == tuple(want), (spec, shape)
        assert tuple(norm_spec(spec, shape, fake)) == tuple(ref_norm_spec(
            jax.sharding.PartitionSpec(*spec), shape, fake))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
def test_state_specs_full_width_match_reference(multi_pod):
    """qwen2.5-3b at full width on the production mesh of ``meta``
    devices: every parameter's sharding is the reference's ``norm_spec``
    of its rule over a mesh of that shape, and the optimizer state shares
    them; nothing is allocated."""
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"])
    ap, ao, psh, osh = state_specs(PC.ARCHS["qwen2.5-3b"], mesh, multi_pod)
    specs, shapes = _ref_specs(RC.ARCHS["qwen2.5-3b"], multi_pod)
    fake = SimpleNamespace(shape=dict(mesh.shape))
    leaves = reference_leaves(PC.ARCHS["qwen2.5-3b"])
    for name, p in ap.named_parameters():
        assert p.device.type == "meta"
        rl = leaves[name]
        want = tuple(RS.norm_spec(jax.sharding.PartitionSpec(*specs[rl]), shapes[rl], fake))
        if rl.startswith("scan."):
            want = want[1:]
        assert psh[name].mesh is mesh and tuple(psh[name].spec) == want, (name, want)
        psh[name].shard_shape(p.shape)
    assert osh.mu is psh and osh.nu is psh and osh.master is psh
    assert tuple(osh.step.spec) == () and ao.step.device.type == "meta"
    assert tuple(psh["embed"].spec) == (("model", ("pod", "data") if multi_pod else "data"))


def test_moe_ep_matches_dense_oracle():
    """The reference's own check: with a capacity no token overflows,
    ``moe_ep`` on a 2x4 mesh equals ``moe_dense`` within 2e-4, and drops
    nothing."""
    rng = np.random.default_rng(1)
    t = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))
    p = {"router": t(D, E, scale=D ** -0.5), "w_up": t(E, D, F, scale=D ** -0.5),
         "w_gate": t(E, D, F, scale=D ** -0.5), "w_down": t(E, F, D, scale=F ** -0.5)}
    x = t(4, 16, D)
    stats = {}
    y, _ = moe_ep(p, x, mesh=_cpu_mesh("2x4"), topk=K, n_experts=E, capacity_factor=8.0,
                  stats=stats)
    want, _ = moe_dense(p, x, topk=K)
    assert float((y - want).abs().max()) < 2e-4
    assert int(stats["dropped"]) == 0 and stats["assignments"] == 4 * 16 * K
    with pytest.raises(AssertionError):
        moe_ep(p, x, mesh=make_mesh((1, 3), ("data", "model"), ["cpu"]), topk=K,
               n_experts=E)


# --------------------------------------------------------------------------
# against the reference's subprocess
# --------------------------------------------------------------------------


def _ref_drop_set(x, router, mesh_shape, axes, cf):
    """The reference's kept assignments per distinct block (data row
    major), from its own ``router_topk`` on each block and the packing of
    ``moe_ep`` (stable sort by expert, ``searchsorted`` starts)."""
    B, S, _ = x.shape
    P_m, dp = mesh_shape[-1], int(np.prod(mesh_shape[:-1]))
    nb = dp if B % dp == 0 else 1
    ns = P_m if S > 1 and S % P_m == 0 else 1
    Bl, Sl = B // nb, S // ns
    T = Bl * Sl
    cap = int(T * K / E * cf) + 1
    topk = jax.jit(ref_router_topk, static_argnums=2)
    out = []
    for i in range(nb):
        for s in range(ns):
            xt = x[i * Bl:(i + 1) * Bl, s * Sl:(s + 1) * Sl].reshape(T, -1)
            a_exp = np.asarray(topk(xt, router, K)[1]).reshape(-1)
            order = np.argsort(a_exp, kind="stable")
            se = a_exp[order]
            pos = np.empty_like(order)
            pos[order] = np.arange(T * K) - np.searchsorted(se, np.arange(E))[se]
            out.append((pos < cap).reshape(T, K))
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mname", list(MESHES))
def test_moe_ep_matches_reference(ref, mname, case):
    """Output, aux, the drop set and the gradients of ``sum(y * ct) + 0.37
    * aux`` with respect to the input and every weight, against the
    reference's ``moe_ep`` under ``jax.value_and_grad``."""
    inp, out = ref.inputs, ref.get()
    xk, cf = CASES[case]
    shape, axes = MESHES[mname]
    p = {k: torch.from_numpy(inp[k]).requires_grad_(True)
         for k in ("router", "w_up", "w_gate", "w_down")}
    x = torch.from_numpy(inp[xk]).requires_grad_(True)
    stats = {}
    y, aux = moe_ep(p, x, mesh=_cpu_mesh(mname), topk=K, n_experts=E, capacity_factor=cf,
                    dp_axes=axes[:-1], stats=stats)
    ((y * torch.from_numpy(inp["ct_" + xk])).sum() + 0.37 * aux).backward()
    key = f"{mname}_{case}"
    close = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), out[key + "_y"], **close)
    np.testing.assert_allclose(float(aux.detach()), float(out[key + "_aux"]), **close)
    want = _ref_drop_set(inp[xk], inp["router"], shape, axes, cf)
    assert len(stats["keep"]) == len(want)
    for got, w in zip(stats["keep"], want):
        np.testing.assert_array_equal(got.numpy(), w)
    n_drop = sum(int((~w).sum()) for w in want)
    assert int(stats["dropped"]) == n_drop
    if case in ("c0.5", "b3"):
        assert n_drop > 0, "the case must drop"
    np.testing.assert_allclose(x.grad.numpy(), out[key + "_gx"], **close)
    for n, t in p.items():
        np.testing.assert_allclose(t.grad.numpy(), out[key + "_g_" + n], **close)


def test_elastic_reshard_across_mesh_shapes(ref, tmp_path):
    """The reference's elastic test on the port: tensors saved from a 2x4
    mesh come back onto 2x4 and 4x2, each coordinate holding the block
    the reference's restored ``jax.Array`` puts on the device there, bit
    for bit, and ``full()`` the saved tensor; an axis that does not divide
    (6 rows over 4) is dropped, as the reference's ``_norm_spec`` drops
    it; a bfloat16 leaf comes back in bfloat16."""
    out = ref.get()
    t = {"w": torch.arange(64.0).reshape(8, 8), "v": torch.arange(48.0).reshape(6, 8),
         "h": torch.randn(8, 4).to(torch.bfloat16)}
    specs = {"w": P("data", "model"), "v": P("data", "model"), "h": P(None, "model")}
    placed = {k: s.place(t[k]) for k, s in shardings_for(t, specs, cpu_mesh((2, 4))).items()}
    save(str(tmp_path), 0, {k: v.full() for k, v in placed.items()}, {"step": 0})
    for shape in ((2, 4), (4, 2)):
        mesh = cpu_mesh(shape)
        got, extra = reshard_restore(str(tmp_path), 0, t, specs, mesh)
        assert extra == {"step": 0}
        fake = SimpleNamespace(shape=dict(mesh.shape))
        for name, st in got.items():
            want = ref_norm_spec(jax.sharding.PartitionSpec(*specs[name]), t[name].shape, fake)
            assert tuple(st.sharding.spec) == tuple(want)
            assert st.dtype == t[name].dtype and torch.equal(st.full(), t[name])
            for c in mesh.coords():
                assert torch.equal(st.shards[c], t[name][st.sharding.index(c, st.shape)])
            if name == "h":
                continue
            rows = out[f"elastic_{shape[0]}x{shape[1]}_{name}"]
            assert len(rows) == mesh.devices.size
            for r in rows:
                sl = st.sharding.index(tuple(int(v) for v in r[:2]), st.shape)
                assert [b for s_ in sl for b in (s_.start, s_.stop)] == [int(v) for v in r[2:]]
    assert tuple(got["v"].sharding.spec) == (None, "model")
