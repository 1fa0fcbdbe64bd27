"""Static registration checks over the ``src/repro_torch`` AST.

Two manifests, one idiom (syntactic detection, then an explicit list with
reasons, enforced by the test suite):

* **device-program sites** (:func:`find_jit_sites` /
  :func:`check_registration` / :func:`stale_jit_sites`): every call of a
  kernel loader (``load(...)`` of ``kernels/build.py``), every
  ``torch.compile`` and every CUDA-graph capture (``torch.cuda.graph``,
  ``torch.cuda.CUDAGraph``, ``torch.cuda.make_graphed_callables``) must be
  registered in ``KNOWN_JIT_SITES``, named by its outermost enclosing def.
  The manifest also lists, by name, the plain torch-op functions that are
  the counterparts of the reference's jit functions; no syntax marks them,
  so an entry is stale when its site is neither detected nor a def of that
  module.
* **device-allocation sites** (:func:`find_alloc_sites` /
  :func:`check_alloc_registration` / :func:`stale_alloc_sites`): every
  ``torch.zeros/ones/empty/full/arange/tensor/as_tensor`` call with a
  ``device=`` argument, every ``torch.cat``/``torch.stack``, every
  ``.to(<device>)`` and ``.cuda()``, and every call of an engine's
  ``_upload`` helper, in the accounted modules
  (:data:`repro_torch.obs.memory.ALLOC_CHECK_MODULES`), must map to a
  buffer family in ``KNOWN_ALLOC_SITES`` or carry an ``exempt:`` reason.
  The functions ``KNOWN_JIT_SITES`` lists are the counterparts of the
  reference's traced defs, so their allocations are temporaries of one
  device program: the walk skips them by manifest.
"""

from __future__ import annotations

import ast
import os
from typing import List, Set, Tuple

__all__ = [
    "find_jit_sites", "check_registration", "stale_jit_sites",
    "find_alloc_sites", "check_alloc_registration", "stale_alloc_sites",
]


def _parse(path: str):
    with open(path) as f:
        try:
            return ast.parse(f.read())
        except SyntaxError:
            return None


def _py_files(root: str):
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                yield os.path.relpath(path, root).replace(os.sep, "/"), path


def _is_torch_attr(node: ast.AST, *chain: str) -> bool:
    """``node`` is the attribute chain ``torch.<chain...>``."""
    for name in reversed(chain):
        if not (isinstance(node, ast.Attribute) and node.attr == name):
            return False
        node = node.value
    return isinstance(node, ast.Name) and node.id == "torch"


def _is_program_ref(node: ast.AST) -> bool:
    """A kernel load, ``torch.compile`` or a CUDA-graph capture."""
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id == "load":
            return True
        if isinstance(f, ast.Attribute) and f.attr == "load" and (
            isinstance(f.value, ast.Name) and f.value.id == "build"
        ):
            return True
    return (
        _is_torch_attr(node, "compile")
        or _is_torch_attr(node, "cuda", "graph")
        or _is_torch_attr(node, "cuda", "CUDAGraph")
        or _is_torch_attr(node, "cuda", "make_graphed_callables")
    )


class _Visitor(ast.NodeVisitor):
    """Collects (lineno, site) for every node ``pred`` accepts, named by
    the outermost enclosing def (methods by their own name), skipping the
    defs in ``skip``."""

    def __init__(self, pred, skip: Set[str] = frozenset()):
        self.pred = pred
        self.skip = skip
        self.sites: List[Tuple[int, str]] = []
        self._stack: List[str] = []

    def visit_FunctionDef(self, node):
        if not self._stack and node.name in self.skip:
            return
        for dec in node.decorator_list:
            self.visit(dec)
        self._stack.append(node.name)
        for stmt in node.body:
            self.visit(stmt)
        self._stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        for stmt in node.body:
            self.visit(stmt)

    def generic_visit(self, node):
        if self.pred(node):
            name = self._stack[0] if self._stack else f"line{node.lineno}"
            self.sites.append((node.lineno, name))
        super().generic_visit(node)


def _defs(tree: ast.AST) -> Set[str]:
    """Names of the module's functions and of its classes' methods."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.update(
                s.name for s in node.body
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
            )
    return out


def find_jit_sites(root: str) -> List[str]:
    """``<relpath>::<site>`` of every kernel load, ``torch.compile`` and
    CUDA-graph capture under ``root`` (a ``src/repro_torch`` dir)."""
    found = set()
    for rel, path in _py_files(root):
        tree = _parse(path)
        if tree is None:
            continue
        v = _Visitor(_is_program_ref)
        v.visit(tree)
        found.update(f"{rel}::{name}" for _lineno, name in v.sites)
    return sorted(found)


def check_registration(root: str) -> List[str]:
    """The UNREGISTERED device-program sites (empty == check passes)."""
    from .watchdog import KNOWN_JIT_SITES

    return [s for s in find_jit_sites(root) if s not in KNOWN_JIT_SITES]


def _stale(root: str, manifest, live: Set[str]) -> List[str]:
    out = []
    for site in sorted(manifest):
        if site in live:
            continue
        rel, _, name = site.partition("::")
        path = os.path.join(root, rel)
        tree = _parse(path) if os.path.exists(path) else None
        if tree is None or name not in _defs(tree):
            out.append(site)
    return out


def stale_jit_sites(root: str) -> List[str]:
    """Manifest entries that name neither a detected site nor a def."""
    from .watchdog import KNOWN_JIT_SITES

    return _stale(root, KNOWN_JIT_SITES, set(find_jit_sites(root)))


# --------------------------------------------------------------------------
# device-allocation sites (memory accounting manifest)
# --------------------------------------------------------------------------

#: torch constructors that allocate on the device their ``device=`` names
_DEVICE_CTORS = ("zeros", "ones", "empty", "full", "arange", "tensor",
                 "as_tensor")


def _is_dtype_arg(node: ast.AST) -> bool:
    """``torch.<dtype>``, ``x.dtype`` or a name holding a dtype."""
    if isinstance(node, ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "torch":
            return True
        return node.attr == "dtype"
    return isinstance(node, ast.Name) and "dtype" in node.id


def _is_alloc_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Name):
        return f.id == "_upload"
    if not isinstance(f, ast.Attribute):
        return False
    if isinstance(f.value, ast.Name) and f.value.id == "torch":
        if f.attr in ("cat", "stack"):
            return True
        if f.attr in _DEVICE_CTORS:
            return any(kw.arg == "device" for kw in node.keywords)
        return False
    if f.attr == "cuda":
        return True
    if f.attr == "to":
        if any(kw.arg == "device" for kw in node.keywords):
            return True
        return bool(node.args) and not _is_dtype_arg(node.args[0])
    return False


def find_alloc_sites(root: str) -> List[str]:
    """``<relpath>::<site>`` for every device allocation outside the
    device-program functions in the accounted modules."""
    from .memory import ALLOC_CHECK_MODULES
    from .watchdog import KNOWN_JIT_SITES

    found = set()
    for rel in ALLOC_CHECK_MODULES:
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            continue
        tree = _parse(path)
        if tree is None:
            continue
        skip = {s.partition("::")[2] for s in KNOWN_JIT_SITES
                if s.startswith(rel + "::")}
        v = _Visitor(_is_alloc_call, skip)
        v.visit(tree)
        found.update(f"{rel}::{name}" for _lineno, name in v.sites)
    return sorted(found)


def check_alloc_registration(root: str) -> List[str]:
    """The UNREGISTERED allocation sites (empty == check passes)."""
    from .memory import KNOWN_ALLOC_SITES

    return [s for s in find_alloc_sites(root) if s not in KNOWN_ALLOC_SITES]


def stale_alloc_sites(root: str) -> List[str]:
    """Manifest entries the walk no longer finds."""
    from .memory import KNOWN_ALLOC_SITES

    live = set(find_alloc_sites(root))
    return sorted(s for s in KNOWN_ALLOC_SITES if s not in live)
