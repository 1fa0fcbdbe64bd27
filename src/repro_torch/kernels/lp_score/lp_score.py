"""Wrapper of the hand-written Hopper kernel ``lp_score_rows.cu``.

``lp_score_rows(lbl, w, k)`` computes per-ELL-row block scores
``S[r, b] = sum_j w[r, j] * [lbl[r, j] == b]`` (labels outside [0, k)
contribute 0).  Tensors on the CPU go to the plain version
(:func:`~repro_torch.kernels.lp_score.ref.lp_score_rows_ref`); CUDA tensors
go to the kernel or raise — there is no fallback.  The kernel is built
from the source beside this file at its first launch.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import load
from .ref import lp_score_rows_ref

__all__ = ["lp_score_rows", "SOURCE"]

SOURCE = Path(__file__).with_name("lp_score_rows.cu")
_SMEM_LIMIT = 48 * 1024   # shared memory a block gets without an opt-in
_MAX_ROWS_PER_BLOCK = 32


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if lib.lp_score_rows_launch.argtypes is None:
        lib.lp_score_rows_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.lp_score_rows_launch.restype = ctypes.c_int
        lib.lp_score_rows_error.argtypes = [ctypes.c_int]
        lib.lp_score_rows_error.restype = ctypes.c_char_p
    return lib


def lp_score_rows(lbl: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """(R, W) int32 labels and float32 weights -> (R, k) float32 scores."""
    if lbl.device.type == "cpu" and w.device.type == "cpu":
        return lp_score_rows_ref(lbl, w, k)
    if not (lbl.is_cuda and w.is_cuda and lbl.device == w.device):
        raise ValueError(
            f"lp_score_rows: lbl on {lbl.device} and w on {w.device}; "
            "both must be on the CPU or on one CUDA device"
        )
    if lbl.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(
            f"lp_score_rows: want int32 labels and float32 weights, got "
            f"{lbl.dtype} and {w.dtype}"
        )
    if lbl.dim() != 2 or lbl.shape != w.shape:
        raise ValueError(
            f"lp_score_rows: want two (R, W) tensors of one shape, got "
            f"{tuple(lbl.shape)} and {tuple(w.shape)}"
        )
    if not (lbl.is_contiguous() and w.is_contiguous()):
        raise ValueError("lp_score_rows: lbl and w must be contiguous")
    k = int(k)
    if k < 1 or k * 4 > _SMEM_LIMIT:
        raise ValueError(f"lp_score_rows: k={k} outside [1, {_SMEM_LIMIT // 4}]")
    R, W = lbl.shape
    out = torch.empty((R, k), dtype=torch.float32, device=lbl.device)
    if R == 0 or W == 0:
        return out.zero_()
    rows = _MAX_ROWS_PER_BLOCK
    while rows > 1 and rows * k * 4 > _SMEM_LIMIT:
        rows //= 2
    vec = W % 4 == 0 and lbl.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    lib = _lib()
    with torch.cuda.device(lbl.device):
        stream = torch.cuda.current_stream(lbl.device).cuda_stream
        rc = lib.lp_score_rows_launch(
            lbl.data_ptr(), w.data_ptr(), out.data_ptr(),
            R, W, k, rows, int(vec), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"lp_score_rows launch failed: {lib.lp_score_rows_error(rc).decode()}"
        )
    lp_score_rows.launches += 1
    return out


lp_score_rows.launches = 0
