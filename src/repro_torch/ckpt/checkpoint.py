"""Fault-tolerant checkpointing: atomic, manifest-driven, async-capable —
the torch twin of ``repro.ckpt.checkpoint``, writing the same on-disk
format.

Layout per step::

    <dir>/step_000123/
        arrays.npz          # flattened tree leaves (copied to the host)
        manifest.json       # step, leaf count, leaf shapes/dtypes, caller
                            # metadata (``extra``), completion marker

Writes go to ``step_X.tmp`` and are atomically renamed after fsync — a crash
mid-write can never corrupt the latest checkpoint ("last complete step"
recovery).  ``AsyncCheckpointer`` moves serialization off the caller's
loop, bounding checkpoint stalls to an enqueue.

Trees are nested dicts, lists and tuples; every other object is a leaf
(a torch tensor, a numpy array or a scalar).  Leaves are flattened in the
reference's order: dict entries by sorted key, lists and tuples in order,
``None`` holds no leaf.  ``restore(..., shardings=)`` places each leaf on
a mesh (a ``models.sharding.ShardedTensor``: one shard per coordinate on
its device), which the elastic reshard (``ckpt.elastic``) builds on.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

__all__ = ["save", "restore", "load", "latest_step", "AsyncCheckpointer"]


def _leaves(tree) -> List[Any]:
    """Leaves of ``tree`` in the flatten order described in the module
    docstring."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(like, it):
    """A tree shaped like ``like`` whose leaves are drawn from ``it``."""
    if like is None:
        return None
    if isinstance(like, dict):
        # rebuild in sorted-key order (the order the leaves were drawn in),
        # keep the template's own key order in the result
        out = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        children = [_unflatten(v, it) for v in like]
        # a named tuple takes its fields as arguments, a list or tuple an
        # iterable
        return type(like)(*children) if hasattr(like, "_fields") else type(like)(children)
    return next(it)


def _map_leaves(fn, tree):
    return _unflatten(tree, iter([fn(x) for x in _leaves(tree)]))


def _to_host(x) -> np.ndarray:
    """A leaf as a host numpy array.  A tensor is copied, also one on the
    CPU, whose ``numpy()`` would alias it: its owner may write it in place
    after an async submit.  A bfloat16 tensor goes as float32 (numpy has no
    bfloat16, and float32 holds each of its values exactly) and comes back
    in its template's dtype on restore."""
    if isinstance(x, torch.Tensor):
        dt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
        return x.detach().to("cpu", dtype=dt, copy=True).numpy()
    return np.asarray(x)


def _fsync_dir(path: str) -> None:
    """fsync a directory entry — required for rename durability: POSIX only
    guarantees the rename itself is atomic, not that it has reached disk;
    a crash after rename but before the parent's metadata flush can revert
    to the old directory contents on ext4/xfs."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:       # platforms/filesystems without O_RDONLY dir opens
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save(path: str, step: int, tree: Any, extra: Optional[dict] = None) -> str:
    """Synchronous atomic checkpoint write; returns the final directory.

    Durability order: arrays fsynced, manifest (with the completion marker)
    fsynced, tmp dir entry fsynced, atomic rename, PARENT dir entry fsynced.
    Only after the last step is the checkpoint guaranteed to survive a
    crash; everything before it leaves a ``.tmp`` that recovery ignores."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    host = [_to_host(x) for x in _leaves(tree)]
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, *host)
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        "step": step,
        "n_leaves": len(host),
        "shapes": [list(x.shape) for x in host],
        "dtypes": [str(x.dtype) for x in host],
        "extra": extra or {},
        "complete": True,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic on POSIX
    _fsync_dir(path)        # rename alone is not crash-durable everywhere
    return final


def latest_step(path: str) -> Optional[int]:
    """Largest step with a COMPLETE manifest (ignores torn .tmp writes)."""
    if not os.path.isdir(path):
        return None
    best = None
    for d in os.listdir(path):
        if not d.startswith("step_") or d.endswith(".tmp"):
            continue
        mf = os.path.join(path, d, "manifest.json")
        try:
            with open(mf) as f:
                m = json.load(f)
            if m.get("complete"):
                s = int(m["step"])
                best = s if best is None or s > best else best
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return best


def load(path: str, step: int):
    """Load a checkpoint WITHOUT a ``like`` template: returns
    ``(leaves, manifest)`` with host numpy leaves in saved (flatten) order.
    The fresh-process restore path — shapes and dtypes come from the
    manifest, not from live objects the crashed process no longer has.
    Raises on an incomplete manifest (a torn write's ``.tmp`` never has
    one, but a copied/partial directory might)."""
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if not manifest.get("complete"):
        raise ValueError(f"checkpoint at {d} is incomplete")
    data = np.load(os.path.join(d, "arrays.npz"))
    leaves = [data[f"arr_{i}"] for i in range(manifest["n_leaves"])]
    for leaf, shape, dt in zip(leaves, manifest["shapes"],
                               manifest["dtypes"]):
        if list(leaf.shape) != list(shape) or str(leaf.dtype) != dt:
            raise ValueError(
                f"leaf mismatch in {d}: {leaf.shape}/{leaf.dtype} "
                f"vs manifest {shape}/{dt}"
            )
    return leaves, manifest


def _like_leaf(h: np.ndarray, like):
    """A loaded leaf in the type, dtype and device of its template."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(h)).to(
            device=like.device, dtype=like.dtype
        )
    return h.astype(np.asarray(like).dtype)


def restore(path: str, step: int, like: Any, shardings: Any = None):
    """Load a checkpoint into the structure of ``like`` (shapes checked);
    returns ``(tree, extra)``.  Tensor leaves of ``like`` come back as
    tensors of its dtype on its device, other leaves as numpy arrays.
    ``shardings``: an optional tree of ``NamedSharding`` shaped like
    ``like``; each leaf then comes back placed on its mesh, a
    ``ShardedTensor`` in its template's dtype (``like`` may live on the
    ``meta`` device)."""
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(d, "arrays.npz"))
    host = [data[k] for k in data.files]
    leaves = _leaves(like)
    if len(host) != len(leaves):
        raise ValueError(f"checkpoint has {len(host)} leaves, template "
                         f"{len(leaves)}")
    for h, l in zip(host, leaves):
        if tuple(h.shape) != tuple(np.shape(l)):
            raise ValueError(f"leaf shape {h.shape} vs template {np.shape(l)}")
    if shardings is not None:
        placements = _leaves(shardings)
        if len(placements) != len(leaves):
            raise ValueError(f"shardings tree has {len(placements)} leaves, template "
                             f"{len(leaves)}")
        out = [s.place(torch.from_numpy(h), l.dtype) if isinstance(l, torch.Tensor)
               else s.place(torch.from_numpy(h.astype(np.asarray(l).dtype)))
               for h, l, s in zip(host, leaves, placements)]
    else:
        out = [_like_leaf(h, l) for h, l in zip(host, leaves)]
    return _unflatten(like, iter(out)), manifest["extra"]


class AsyncCheckpointer:
    """Single-writer background checkpoint thread (overlaps the caller).

    A failed background write is never silent: the exception is re-raised
    on the next ``wait()`` OR the next ``submit()`` (whichever comes
    first), then cleared so the checkpointer stays usable — the caller
    decides whether to retry the step or crash.  ``failed_writes`` counts
    surfaced failures for monitoring."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self.failed_writes = 0

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err:
            err, self._err = self._err, None  # surface once, stay usable
            self.failed_writes += 1
            raise err

    def submit(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()  # one in flight at a time
        host = _map_leaves(_to_host, tree)  # device->host on caller thread

        def work():
            try:
                save(self.path, step, host, extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1])
            for d in os.listdir(self.path)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"), ignore_errors=True)
