"""Port hygiene: repro_torch imports neither jax nor the reference package,
imports cleanly with jax unavailable, and its entry points never fall back
to the CPU on their own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_no_jax_or_reference_imports():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 15
    bad = [
        f"{f.relative_to(SRC)}:{line} imports {root}"
        for f in files
        for root, line in _imported_roots(f)
        if root in ("jax", "jaxlib", "repro")
    ]
    assert not bad, bad


def test_imports_with_jax_poisoned():
    """Every module of the port imports in a process where importing jax
    (or the reference package) fails."""
    mods = sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(SRC)),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_need_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch.core import LPEngine, PartitionerConfig, partition
    from repro_torch.graph import mesh2d
    from repro_torch.kernels.lp_score import node_scores

    g = mesh2d(8)
    cfg = PartitionerConfig(k=2, evo_engine="host")
    with pytest.raises(RuntimeError, match="CUDA"):
        partition(g, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        LPEngine(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        node_scores(g, np.zeros(g.n, np.int32), 2)
    # asked for the CPU, the same call runs
    assert partition(g, cfg, device="cpu").feasible


def test_unported_options_raise():
    from repro_torch.core import PartitionerConfig, partition
    from repro_torch.graph import mesh2d

    g = mesh2d(8)
    for kw in (dict(evo_engine="device"), dict(engine="dist")):
        with pytest.raises(NotImplementedError):
            partition(g, PartitionerConfig(k=2, **kw), device="cpu")
