"""Port hygiene: repro_torch and its example twins (``examples/torch``)
import neither jax nor the reference package, the package imports cleanly
with jax unavailable, and its entry points never fall back to the CPU on
their own."""

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
EXAMPLES = SRC.parent / "examples" / "torch"


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
    assert len(files) >= 37
    assert {"dryrun.py", "dryrun_paper.py", "hlo_analysis.py", "roofline.py", "reanalyze.py",
            "summarize.py"} <= {f.name for f in files if f.parent.name == "launch"}
    twins = sorted(EXAMPLES.glob("*.py"))
    assert len(twins) >= 9
    files += twins
    bad = [
        f"{f.relative_to(SRC.parent)}:{line} imports {root}"
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
    from repro_torch.launch.train import main as train_main

    g = mesh2d(8)
    cfg = PartitionerConfig(k=2, evo_engine="host")
    with pytest.raises(RuntimeError, match="CUDA"):
        partition(g, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        LPEngine(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        node_scores(g, np.zeros(g.n, np.int32), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--smoke", "--steps", "1"])
    # asked for the CPU, the same call runs
    assert partition(g, cfg, device="cpu").feasible


def test_unported_options_raise():
    """Every engine of the reference is ported: an unknown engine or GA
    engine is an error, the distributed engine needs a PE count and runs
    with one, and evo_engine="device" runs the batched GA.
    ``launch.train.main`` trains on any --mesh DxM whose model axis splits
    the experts, as the reference's does, and raises otherwise."""
    from repro_torch.core import PartitionerConfig, partition
    from repro_torch.graph import mesh2d
    from repro_torch.launch.train import main as train_main

    for mesh in ("2x1", "1x4"):
        losses = train_main(["--smoke", "--steps", "1", "--mesh", mesh, "--device", "cpu"])
        assert len(losses) == 1 and np.isfinite(losses[0])
    with pytest.raises(AssertionError):
        train_main(["--arch", "granite-moe-1b-a400m", "--smoke", "--steps", "1", "--mesh",
                    "1x3", "--device", "cpu"])
    with pytest.raises(ValueError):
        train_main(["--smoke", "--steps", "1", "--mesh", "4", "--device", "cpu"])

    g = mesh2d(8)
    with pytest.raises(ValueError):
        partition(g, PartitionerConfig(k=2, engine="tpu"), device="cpu")
    with pytest.raises(ValueError):
        partition(g, PartitionerConfig(k=2, engine="dist"), device="cpu")
    rep = partition(g, PartitionerConfig(k=2, engine="dist", dist_shards=2,
                                         numpy_below=16, coarsest_factor=4),
                    device="cpu", devices=["cpu"] * 2)
    assert rep.feasible and rep.engine_stats["evo_calls"] == 0
    with pytest.raises(ValueError):
        partition(g, PartitionerConfig(k=2, evo_engine="gpu"), device="cpu")
    rep = partition(g, PartitionerConfig(k=2, evo_engine="device"), device="cpu")
    assert rep.feasible and rep.engine_stats["evo_calls"] == 2
