"""Build a hand-written CUDA kernel at first use and load it with ctypes.

Each kernel is one ``.cu`` file with a plain C interface (no PyTorch
headers, so ``nvcc`` takes seconds).  It is compiled for Hopper
(``sm_90a``) into ``build/torch_ext/`` at the repository root, under a
name that carries a hash of the source and flags, so an edited source is
rebuilt and an unchanged one is loaded from the cache.  The compiler's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
the library as ``<name>.log``.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_LOADED: Dict[Path, ctypes.CDLL] = {}   # keyed by source path


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build(source: Path) -> Path:
    """Compile ``source`` into a shared library (cached by content);
    returns its path.  Raises with the compiler's output on failure."""
    source = Path(source)
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    (BUILD_DIR / f"{source.stem}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``source`` once per
    process; later calls are a dictionary lookup (wrappers call this on
    every launch)."""
    source = Path(source)
    lib = _LOADED.get(source)
    if lib is None:
        lib = _LOADED[source] = ctypes.CDLL(str(build(source)))
    return lib
