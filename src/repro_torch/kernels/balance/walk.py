"""Wrapper of the hand-written kernel ``repair_balance_walk.cu``, with its
plain version.

``repair_balance_walk(cand, cand_lab, cand_nw, labels, bw, L)`` walks the
candidates of the final balance repair in order and moves each, as
:func:`repro_torch.core.initial_partition.repair_balance` decides, to the
lightest block that still fits; it stops once no block is above ``L``.  It
returns new labels and the number of nodes moved (an int64 scalar tensor);
its inputs are not written.  Any k runs: the kernel keeps the block weights
in shared memory up to :func:`shared_k_limit` blocks and in a global
scratch copy beyond.  Tensors on the CPU go to the plain version
(:func:`repair_balance_walk_ref`, a Python loop over the candidates); CUDA
tensors go to the kernel or raise.  The kernel is built
from the source beside this file at its first launch.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from ..build import load

__all__ = ["repair_balance_walk", "repair_balance_walk_ref", "shared_k_limit", "SOURCE"]

SOURCE = Path(__file__).with_name("repair_balance_walk.cu")

Walk = Tuple[torch.Tensor, torch.Tensor]


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if lib.repair_balance_walk_launch.argtypes is None:
        lib.repair_balance_walk_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.repair_balance_walk_launch.restype = ctypes.c_int
        lib.repair_balance_walk_error.argtypes = [ctypes.c_int]
        lib.repair_balance_walk_error.restype = ctypes.c_char_p
        lib.repair_balance_walk_shared_k.argtypes = []
        lib.repair_balance_walk_shared_k.restype = ctypes.c_longlong
    return lib


def shared_k_limit(device=None) -> int:
    """The most blocks whose weights the kernel keeps in shared memory on
    ``device`` (the current CUDA device by default); a larger k walks with
    them in global memory."""
    lib = _lib()
    with torch.cuda.device(device):
        return int(lib.repair_balance_walk_shared_k())


def repair_balance_walk_ref(cand: torch.Tensor, cand_lab: torch.Tensor,
                            cand_nw: torch.Tensor, labels: torch.Tensor,
                            bw: torch.Tensor, L: float) -> Walk:
    """The walk on the CPU: the host's loop over the candidates only, in
    Python floats (IEEE float64, as numpy's), with the kernel's cached
    argmin and count of blocks above ``L``."""
    w = bw.tolist()
    k = len(w)
    over = sum(x > L for x in w)
    tgt = w.index(min(w))   # first index of the minimum
    moved_v, moved_t = [], []
    if over:
        for v, b, x in zip(cand.tolist(), cand_lab.tolist(), cand_nw.tolist()):
            if not 0 <= b < k:
                continue
            wb = w[b]
            if wb <= L:
                continue
            wt = w[tgt]
            if wt + x > L or tgt == b:
                continue
            w[b] = wb - x
            w[tgt] = wt + x
            moved_v.append(v)
            moved_t.append(tgt)
            over -= (w[b] <= L) + (wt > L)
            if over == 0:
                break
            tgt = w.index(min(w))
    out = labels.clone()
    if moved_v:
        out[torch.tensor(moved_v, dtype=torch.int64)] = torch.tensor(
            moved_t, dtype=out.dtype)
    return out, torch.tensor(len(moved_v), dtype=torch.int64)


def repair_balance_walk(cand: torch.Tensor, cand_lab: torch.Tensor,
                        cand_nw: torch.Tensor, labels: torch.Tensor,
                        bw: torch.Tensor, L: float) -> Walk:
    """(C,) int64 candidate ids, their (C,) int32 blocks and (C,) float32
    weights, (N,) int32 labels and (k,) float64 block weights -> new labels
    and the moved count."""
    ts = (cand, cand_lab, cand_nw, labels, bw)
    if all(t.device.type == "cpu" for t in ts):
        return repair_balance_walk_ref(cand, cand_lab, cand_nw, labels, bw, L)
    dev = labels.device
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError(
            "repair_balance_walk: tensors on "
            f"{sorted({str(t.device) for t in ts})}; all must be on the CPU "
            "or on one CUDA device")
    want = (torch.int64, torch.int32, torch.float32, torch.int32, torch.float64)
    if tuple(t.dtype for t in ts) != want:
        raise TypeError(
            f"repair_balance_walk: want dtypes {want}, got "
            f"{tuple(t.dtype for t in ts)}")
    C = cand.shape[0] if cand.dim() == 1 else -1
    if any(t.dim() != 1 for t in ts) or cand_lab.shape[0] != C or cand_nw.shape[0] != C:
        raise ValueError(
            "repair_balance_walk: want 1-D tensors, the three candidate "
            f"tensors of one length, got {[tuple(t.shape) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("repair_balance_walk: every tensor must be contiguous")
    k = bw.shape[0]
    if not 1 <= k < 2**31:
        raise ValueError(f"repair_balance_walk: k={k} outside [1, 2^31)")
    out = labels.clone()
    work = bw.clone()   # the kernel's scratch when k outgrows shared memory
    moved = torch.zeros((), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repair_balance_walk_launch(
            cand.data_ptr(), cand_lab.data_ptr(), cand_nw.data_ptr(), C,
            out.data_ptr(), out.shape[0], work.data_ptr(), k, float(L),
            moved.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            "repair_balance_walk launch failed: "
            f"{lib.repair_balance_walk_error(rc).decode()}")
    repair_balance_walk.launches += 1
    return out, moved


repair_balance_walk.launches = 0
