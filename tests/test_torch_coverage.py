"""Library coverage of the port: every name in the ``__all__`` of the
reference's modules under ``core``, ``graph``, ``kernels``, ``deploy``,
``dynamic``, ``resilience``, ``obs``, ``ckpt`` and ``launch/mesh.py`` exists
in the port's module of the same path, or stands in the table below with
its counterpart or the queue item that ports it.  The reference's
``__all__`` lists are read with ``ast``, without importing the reference."""

import ast
import importlib
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF = SRC / "repro"
PACKAGES = ("core", "graph", "kernels", "deploy", "dynamic", "resilience", "obs", "ckpt")

_Q4 = "Queue 1 item 4"

#: (reference module, name) -> its counterpart in the port (a dotted path
#: that must resolve) or, for a name the port has not taken on yet, the
#: ROADMAP item that ports it.  These reference names are JAX programs or
#: TPU constants; the port has no alias of them by design.
NOT_BY_NAME = {
    ("graph", "Graph"): "repro_torch.graph.GraphDev",
    ("graph.csr", "Graph"): "repro_torch.graph.csr.GraphDev",
    ("graph", "to_device"): "repro_torch.graph.to_device_csr",
    ("graph.csr", "to_device"): "repro_torch.graph.csr.to_device_csr",
    ("graph", "to_host"): "repro_torch.graph.GraphDev.to_host",
    ("graph.csr", "to_host"): "repro_torch.graph.csr.GraphDev.to_host",
    ("core", "cut_jnp"): "repro_torch.core.cut_from_arcs",
    ("core.metrics", "cut_jnp"): "repro_torch.core.metrics.cut_from_arcs",
    ("core.metrics", "cut_from_arcs_jnp"): "repro_torch.core.metrics.cut_from_arcs",
    ("core.metrics", "block_weights_dense_jnp"):
        "repro_torch.core.metrics.block_weights_dense",
    ("core.contraction", "contract_arcs_jnp"): "repro_torch.core.contraction.contract_arcs",
    ("core.evo_device", "evo_generation_step"):
        "repro_torch.core.evo_device.evo_generation_step_sharded",
    ("core.evo_device", "make_generation_sharded"):
        "repro_torch.core.evo_device.evo_generation_step_sharded",
    ("kernels.lp_score.lp_score", "LANE"): "repro_torch.graph.packing.ELL_WIDTH",
    ("kernels.lp_score.lp_score", "TILE_R"): "repro_torch.graph.packing.ell_pack",
    ("ckpt", "reshard_restore"): _Q4,
    ("ckpt", "shardings_for"): _Q4,
    ("ckpt.elastic", "reshard_restore"): _Q4,
    ("ckpt.elastic", "shardings_for"): _Q4,
    ("launch.mesh", "make_production_mesh"): _Q4,
}


def _all_of(path: Path):
    """The module's literal ``__all__`` list, or None."""
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign) else [])
        if any(isinstance(t, ast.Name) and t.id == "__all__" for t in targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    return None


def _reference_modules():
    files = [f for pkg in PACKAGES for f in sorted((REF / pkg).rglob("*.py"))]
    files.append(REF / "launch" / "mesh.py")
    out = []
    for f in files:
        names = _all_of(f)
        if names is not None:
            rel = f.relative_to(REF).with_suffix("")
            parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
            out.append((".".join(parts), names))
    return out


MODULES = _reference_modules()


def _resolve(dotted: str):
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


def test_reference_modules_found():
    mods = dict(MODULES)
    assert len(MODULES) >= 50
    for mod in ("core", "core.baselines", "core.modularity", "core.autoshard",
                "graph.generators", "kernels.lp_score.ops", "launch.mesh"):
        assert mod in mods, mod


@pytest.mark.parametrize("mod,names", MODULES, ids=[m for m, _ in MODULES])
def test_every_reference_name_has_a_port_counterpart(mod, names):
    missing = []
    for name in names:
        where = NOT_BY_NAME.get((mod, name))
        if where is None:
            port = importlib.import_module(f"repro_torch.{mod}")
            if not hasattr(port, name):
                missing.append(name)
        elif where != _Q4:
            _resolve(where)
            assert not hasattr(importlib.import_module(f"repro_torch.{mod}"), name), (
                f"repro_torch.{mod}.{name} exists: drop its table entry")
    assert not missing, f"repro_torch.{mod} lacks {missing}"


def test_table_names_only_reference_names():
    mods = dict(MODULES)
    stale = [key for key in NOT_BY_NAME if key[1] not in mods.get(key[0], ())]
    assert not stale, stale
