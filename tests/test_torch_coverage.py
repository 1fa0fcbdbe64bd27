"""Library coverage of the port: every name the reference's modules under
``core``, ``graph``, ``kernels``, ``deploy``, ``dynamic``, ``resilience``,
``obs``, ``ckpt``, ``configs``, ``models``, ``optim``, ``data`` and
``launch`` export exists in the port's module of the same path, or stands
in the tables below with its counterpart or the queue item that ports it.
A module's exports are its ``__all__``, or without one its public top-level
definitions; they are read with ``ast``, without importing the
reference."""

import ast
import importlib
import importlib.util
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF = SRC / "repro"
PACKAGES = ("core", "graph", "kernels", "deploy", "dynamic", "resilience", "obs", "ckpt",
            "configs", "models", "optim", "data", "launch")

# ROADMAP.md, Queue 1 item 4: every part of it is ported, (4d) the
# dry-run tooling last, so no item is open
ITEMS = ()
#: reference modules the port holds name for name: none of them may stand
#: in the tables below
PORTED_WHOLE = ("optim", "optim.adamw", "optim.compression", "optim.schedule", "data",
                "data.pipeline", "launch.train")
#: a name the reference's ``__all__`` lists but its module never defines
UNDEFINED = "undefined in the reference"

#: reference modules the port has not taken on yet, with the item that
#: ports them: each of their names is open
MODULE_ITEMS = {}

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
    ("launch.hlo_analysis", "analyze_hlo"): "repro_torch.launch.hlo_analysis.count_step",
    ("launch.roofline", "collective_bytes"): "repro_torch.launch.hlo_analysis.count_step",
    ("models.moe", "MoEParams"): UNDEFINED,
}


def _targets(node):
    return (node.targets if isinstance(node, ast.Assign)
            else [node.target] if isinstance(node, ast.AnnAssign) else [])


def _defined(path: Path):
    """The public names a module defines at top level (functions, classes,
    assignments), in order."""
    out = []
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.append(node.name)
        out += [t.id for t in _targets(node) if isinstance(t, ast.Name)]
    return [n for n in out if not n.startswith("_")]


def _exports(path: Path):
    """The module's literal ``__all__`` list, else its public definitions."""
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if any(isinstance(t, ast.Name) and t.id == "__all__" for t in _targets(node)):
            return [ast.literal_eval(e) for e in node.value.elts]
    return _defined(path)


def _reference_modules():
    files = [f for pkg in PACKAGES for f in sorted((REF / pkg).rglob("*.py"))]
    out = []
    for f in files:
        names = _exports(f)
        if names:
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


def _port_has(mod: str) -> bool:
    try:
        return importlib.util.find_spec(f"repro_torch.{mod}") is not None
    except ModuleNotFoundError:            # its parent package is missing too
        return False


def test_reference_modules_found():
    mods = dict(MODULES)
    assert len(MODULES) >= 85
    for mod in ("core", "core.baselines", "core.modularity", "core.autoshard",
                "graph.generators", "kernels.lp_score.ops", "launch.mesh", "launch.serve",
                "configs.registry", "configs.qwen2_5_3b", "models.model", "models.mamba2"):
        assert mod in mods, mod
    assert mods["launch.serve"] == ["pad_caches", "main"]


@pytest.mark.parametrize("mod,names", MODULES, ids=[m for m, _ in MODULES])
def test_every_reference_name_has_a_port_counterpart(mod, names):
    if mod in MODULE_ITEMS:
        assert MODULE_ITEMS[mod] in ITEMS
        assert not _port_has(mod), f"repro_torch.{mod} exists: drop its table entry"
        return
    missing = []
    for name in names:
        where = NOT_BY_NAME.get((mod, name))
        if where is None:
            port = importlib.import_module(f"repro_torch.{mod}")
            if not hasattr(port, name):
                missing.append(name)
            continue
        assert not hasattr(importlib.import_module(f"repro_torch.{mod}"), name), (
            f"repro_torch.{mod}.{name} exists: drop its table entry")
        if where == UNDEFINED:
            assert name not in _defined(REF.joinpath(*mod.split(".")).with_suffix(".py"))
        elif where not in ITEMS:
            _resolve(where)
    assert not missing, f"repro_torch.{mod} lacks {missing}"


def test_table_names_only_reference_names():
    mods = dict(MODULES)
    stale = [key for key in NOT_BY_NAME if key[1] not in mods.get(key[0], ())]
    stale += [mod for mod in MODULE_ITEMS if mod not in mods]
    assert not stale, stale


def test_training_modules_are_held_name_for_name():
    """optim, data and launch.train are ported whole: each is found, none
    stands in a table, so the parametrized test above fails on any of
    their names the port lacks; launch.steps is held name for name, its
    dry-run specs included, and no module or item is open."""
    mods = dict(MODULES)
    for mod in PORTED_WHOLE:
        assert mod in mods and _port_has(mod), mod
        assert mod not in MODULE_ITEMS, mod
        assert not [k for k in NOT_BY_NAME if k[0] == mod], mod
    assert mods["launch.train"] == ["main"]
    assert not {n for (m, n) in NOT_BY_NAME if m == "launch.steps"}
    assert "launch.steps" not in MODULE_ITEMS
    assert not MODULE_ITEMS and not ITEMS
