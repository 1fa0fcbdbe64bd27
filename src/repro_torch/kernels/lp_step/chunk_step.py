"""Wrapper of the hand-written kernel ``lp_chunk_step.cu``: the chunk steps
of :func:`repro_torch.core.label_propagation.lp_sweep_batched` on the card.

``ChunkStep(...)`` takes one sweep's CUDA tensors, checks them, and holds
new label and weight rows and the kernel's scratch; ``step(it, c)`` makes
step ``c`` of iteration ``it`` (three launches: segment, propose, apply)
and ``step.result()`` returns ``(labels, weights, moves)`` as the plain
version does.  The plain version is
:func:`~repro_torch.core.label_propagation.lp_sweep_plain`, which every
tensor on the CPU takes; CUDA tensors take this kernel or raise.  The
kernel is built from the source beside this file at its first launch.

Counters: ``ChunkStep.launches`` (kernel launches, three a step) and
:func:`block_nodes` (the hubs, nodes of more arcs in their chunk than
:func:`light_arcs`, whose arcs the kernel spreads over blocks in pieces),
kept on the card and read with a synchronize.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from ..build import load

__all__ = ["ChunkStep", "StepArgs", "block_nodes", "check_inputs", "light_arcs", "SOURCE"]

SOURCE = Path(__file__).with_name("lp_chunk_step.cu")

_BLOCK_NODES: Dict[torch.device, torch.Tensor] = {}   # the kernel's counter, per card


class StepArgs(ctypes.Structure):
    """The kernel's argument block (``Args`` in the source): every field 8
    bytes, in the source's order."""

    _fields_ = [(name, ctypes.c_void_p if ptr else ctypes.c_longlong) for name, ptr in (
        ("nodes", 1), ("node_valid", 1), ("node_row", 0),
        ("edge_dst", 1), ("edge_w", 1), ("edge_slot", 1), ("edge_valid", 1), ("edge_row", 0),
        ("nvalid", 1), ("nvalid_row", 0), ("N", 0), ("E", 0),
        ("perm", 1), ("steps", 0), ("base_jit", 1), ("base_gate", 1),
        ("labels", 1), ("A", 0), ("w0", 1), ("w1", 1), ("W", 0),
        ("nw", 1), ("nw_row", 0), ("restr", 1), ("U", 1), ("T", 0), ("B", 0),
        ("seg", 1), ("prop", 1), ("flow", 1), ("hub", 1), ("hub_state", 1), ("hub_tot", 1),
        ("piece", 1), ("ctr", 1), ("tkey", 1), ("tsum", 1), ("trun", 1),
        ("moves", 1), ("block_nodes", 1),
    )]


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if lib.lp_chunk_step_launch.argtypes is None:
        lib.lp_chunk_step_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.lp_chunk_step_launch.restype = ctypes.c_int
        lib.lp_chunk_step_error.argtypes = [ctypes.c_int]
        lib.lp_chunk_step_error.restype = ctypes.c_char_p
        lib.lp_chunk_step_args_size.argtypes = []
        lib.lp_chunk_step_args_size.restype = ctypes.c_longlong
        lib.lp_chunk_step_light_arcs.argtypes = []
        lib.lp_chunk_step_light_arcs.restype = ctypes.c_int
        lib.lp_chunk_step_piece_arcs.argtypes = []
        lib.lp_chunk_step_piece_arcs.restype = ctypes.c_int
        if lib.lp_chunk_step_args_size() != ctypes.sizeof(StepArgs):
            raise RuntimeError(
                f"lp_chunk_step: the kernel's Args is {lib.lp_chunk_step_args_size()} "
                f"bytes, StepArgs {ctypes.sizeof(StepArgs)}")
    return lib


def light_arcs() -> int:
    """The most arcs a node may have in its chunk and still take the
    kernel's warp path; a node with more (a hub) is cut into pieces that
    blocks take."""
    return int(_lib().lp_chunk_step_light_arcs())


def _counter(dev: torch.device) -> torch.Tensor:
    t = _BLOCK_NODES.get(dev)
    if t is None:
        t = _BLOCK_NODES[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    return t


def block_nodes(device=None) -> int:
    """The hub visits of the kernel on ``device`` (the current CUDA device
    by default) since the process began: each a node of more arcs in its
    chunk than :func:`light_arcs`, spread over blocks in pieces; reading it
    synchronizes."""
    dev = torch.device("cuda" if device is None else device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = _BLOCK_NODES.get(dev)
    return 0 if t is None else int(t.item())


def check_inputs(pack: Tuple[torch.Tensor, ...], labels: torch.Tensor,
                 weights: torch.Tensor, nw: torch.Tensor, restrict: torch.Tensor,
                 *, use_restrict: bool) -> Tuple[torch.Tensor, ...]:
    """The sweep's pack ``(nodes, node_valid, edge_dst, edge_w,
    edge_src_slot, edge_valid)``, ``(C, N)``/``(C, E)`` shared by the rows
    or ``(B, C, N)``/``(B, C, E)`` one a row, in the kernel's dtypes
    (int64 ids and slots, bool masks, float32 weights; a copy only where a
    dtype or layout differs).  Raises on what the kernel does not take:
    labels ``(B, A)`` int32 or int64, weights ``(B, W)`` float32, node
    weights ``(A,)`` or ``(B, A)`` float32, and with ``use_restrict`` an
    ``(A,)`` int32 restriction."""
    want = (torch.int64, torch.bool, torch.int64, torch.float32, torch.int64, torch.bool)
    out = tuple(t.to(dt).contiguous() for t, dt in zip(pack, want))
    lead = out[0].dim() - 2
    B, A = labels.shape
    C, N = out[0].shape[-2:]
    E = out[2].shape[-1]
    shapes = [(C, N), (C, N), (C, E), (C, E), (C, E), (C, E)]
    if lead not in (0, 1) or any(
            tuple(t.shape[lead:]) != s or (lead and t.shape[0] != B)
            for t, s in zip(out, shapes)):
        raise ValueError(
            "lp_chunk_step: want a pack of (C, N) nodes and (C, E) arcs, or one a row, "
            f"got {[tuple(t.shape) for t in out]} for {B} rows")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"lp_chunk_step: want int32 or int64 labels, got {labels.dtype}")
    if weights.dtype != torch.float32 or nw.dtype != torch.float32:
        raise TypeError("lp_chunk_step: want float32 block and node weights, got "
                        f"{weights.dtype} and {nw.dtype}")
    if weights.dim() != 2 or weights.shape[0] != B:
        raise ValueError(f"lp_chunk_step: want (B, W) weights, got {tuple(weights.shape)}")
    if nw.shape not in ((A,), (B, A)):
        raise ValueError(f"lp_chunk_step: want (A,) or (B, A) node weights, got {tuple(nw.shape)}")
    if use_restrict and (restrict.dtype != torch.int32 or restrict.shape != (A,)):
        raise ValueError("lp_chunk_step: want an (A,) int32 restriction, got "
                         f"{tuple(restrict.shape)} {restrict.dtype}")
    if E >= 2**30:
        raise ValueError(f"lp_chunk_step: E={E} arcs a chunk, at most 2^30 - 1")
    return out


class ChunkStep:
    """The chunk steps of one sweep on the card (see the module docstring).
    ``perm`` ``(B, steps)``, ``base_jit`` and ``base_gate`` ``(iters, B,
    steps)`` are int64 CUDA tensors (``base_gate`` unused outside refine
    mode), ``U`` a ``(B,)`` float32 one; ``labels`` and ``weights`` are not
    written."""

    launches = 0

    def __init__(self, pack, labels: torch.Tensor, weights: torch.Tensor, nw: torch.Tensor,
                 restrict: torch.Tensor, U: torch.Tensor, perm: torch.Tensor,
                 base_jit: torch.Tensor, base_gate: torch.Tensor, T: int, *,
                 refine_mode: bool, use_restrict: bool):
        dev = labels.device
        ts = (*pack, labels, weights, nw, restrict, U, perm, base_jit, base_gate)
        if not all(t.is_cuda and t.device == dev for t in ts):
            raise ValueError(
                "lp_chunk_step: tensors on "
                f"{sorted({str(t.device) for t in ts})}; all must be on one CUDA device")
        pack = check_inputs(pack, labels, weights, nw, restrict, use_restrict=use_restrict)
        B, A = labels.shape
        C, N = pack[0].shape[-2:]
        E = pack[2].shape[-1]
        W = weights.shape[1]
        if not 0 <= T < W or B > 65535:
            raise ValueError(f"lp_chunk_step: T={T} outside [0, W={W}) or B={B} > 65535")
        lanes = pack[0].dim() == 3
        self.refine = bool(refine_mode)
        self.labels = labels.contiguous().clone()
        self.w = (weights.contiguous().clone(),
                  weights.contiguous().clone() if self.refine else None)
        self.moves = torch.zeros(B, dtype=torch.int64, device=dev)
        self.parity = 0
        self._idle = B == 0 or N == 0     # no node slot: a step moves nothing
        nw = nw.contiguous()
        self._lib = lib = _lib()
        # hubs a row: at most one a light_arcs() + 1 arcs; their pieces: at
        # most one a piece_arcs() arcs, and one more a hub
        hubs = B * min(N, E // (lib.lp_chunk_step_light_arcs() + 1)) + 1
        pieces = B * (E // lib.lp_chunk_step_piece_arcs() + 1) + hubs
        i32 = dict(dtype=torch.int32, device=dev)
        # kept alive for the kernel: every tensor whose address it holds
        self._keep = (pack, pack[5].sum(-1, dtype=torch.int32), nw, restrict,
                      U.contiguous(), perm.contiguous(), base_jit.contiguous(),
                      base_gate.contiguous(), torch.empty((B, N, 2), **i32),
                      torch.empty((B, N), **i32),
                      torch.zeros((2, 2, B, W) if self.refine else (1,),
                                  dtype=torch.float32, device=dev),
                      torch.empty((hubs, 4), **i32), torch.empty((hubs, 3), **i32),
                      torch.empty(hubs, dtype=torch.int64, device=dev),
                      torch.empty((pieces, 2), **i32), torch.zeros(3, **i32),
                      torch.empty((B, 2 * E), **i32),
                      torch.empty((B, 2 * E), dtype=torch.float32, device=dev),
                      torch.empty((B, E), **i32))
        (_, nvalid, _, restr, U_, perm_, bj, bg, seg, prop, flow, hub, hub_state, hub_tot,
         piece, ctr, tkey, tsum, trun) = self._keep
        p = [t.data_ptr() for t in pack]
        self.args = StepArgs(
            p[0], p[1], C * N if lanes else 0, p[2], p[3], p[4], p[5], C * E if lanes else 0,
            nvalid.data_ptr(), C if lanes else 0, N, E,
            perm_.data_ptr(), perm_.shape[1], bj.data_ptr(), bg.data_ptr(),
            self.labels.data_ptr(), A, self.w[0].data_ptr(),
            self.w[1].data_ptr() if self.refine else 0, W,
            nw.data_ptr(), A if nw.dim() == 2 else 0, restr.data_ptr(), U_.data_ptr(),
            int(T), B, seg.data_ptr(), prop.data_ptr(), flow.data_ptr(), hub.data_ptr(),
            hub_state.data_ptr(), hub_tot.data_ptr(), piece.data_ptr(), ctr.data_ptr(),
            tkey.data_ptr(), tsum.data_ptr(), trun.data_ptr(), self.moves.data_ptr(),
            _counter(dev).data_ptr(),
        )
        self._flags = (int(self.refine), int(use_restrict),
                       int(self.labels.dtype == torch.int64))
        self._stream = torch.cuda.current_stream(dev).cuda_stream
        self._ref = ctypes.byref(self.args)

    def __call__(self, it: int, c: int) -> None:
        """Step ``c`` of iteration ``it``: three launches on the current
        stream, no synchronize."""
        if self._idle:
            return
        rc = self._lib.lp_chunk_step_launch(self._ref, it, c, self.parity, *self._flags,
                                            self._stream)
        if rc != 0:
            raise RuntimeError(
                f"lp_chunk_step launch failed: {self._lib.lp_chunk_step_error(rc).decode()}")
        ChunkStep.launches += 3
        if self.refine:
            self.parity ^= 1

    def result(self):
        """``(labels, weights, moves)`` after the steps made so far."""
        return self.labels, self.w[self.parity], self.moves
