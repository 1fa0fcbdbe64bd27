"""What the dense refinement's ``lp_score_rows`` launches read and return.

The capture wraps the kernel where the dense round calls it
(``repro_torch.kernels.lp_score.ops.lp_score_rows``): every launch's shape
is kept for its byte count, and ``rows`` rows drawn from the seed are
gathered on the device (a few small kernels a launch) and moved to the host
after the call, for the reference to recompute.  :meth:`missed` holds the
capture against the program's own counts of the kernel's calls."""

from __future__ import annotations

import numpy as np
import torch


class KernelCapture:
    def __init__(self, rows: int, seed: int):
        self.rows = int(rows)
        self.seed = int(seed)
        self.shapes = []      # (R, W, k) per launch
        self.samples = []     # (lbl, w, scores, k) host rows
        self._pending = []
        self._gens = {}
        self._ops = None
        self._inner = None

    def install(self) -> "KernelCapture":
        from repro_torch.kernels.lp_score import ops

        self._ops, self._inner = ops, ops.lp_score_rows
        self._launches0 = self._launches()
        ops.lp_score_rows = self
        return self

    def _launches(self) -> int:
        return int(getattr(self._inner, "launches", 0))

    def missed(self, dense_rounds: int) -> int:
        """Kernel calls since :meth:`install` that the capture did not see,
        by the program's own counts: the kernel's launch counter (CUDA
        launches only) or the engine's dense rounds (one call each),
        whichever is larger.  A call that reaches the kernel by another name
        or from another site is left unchecked, and counts here."""
        due = max(self._launches() - self._launches0, int(dense_rounds))
        return max(0, due - len(self.shapes))

    def uninstall(self) -> None:
        if self._ops is not None:
            self._ops.lp_score_rows = self._inner
            self._ops = None

    def _gen(self, device) -> torch.Generator:
        key = str(device)
        if key not in self._gens:
            g = torch.Generator(device=device)
            g.manual_seed(self.seed)
            self._gens[key] = g
        return self._gens[key]

    def __call__(self, lbl, w, k):
        out = self._inner(lbl, w, k)
        R, W = lbl.shape
        self.shapes.append((int(R), int(W), int(k)))
        if R and self.rows:
            idx = torch.randint(0, R, (min(self.rows, R),), generator=self._gen(lbl.device),
                                device=lbl.device)
            self._pending.append((lbl[idx], w[idx], out[idx], int(k)))
        return out

    def drain(self) -> None:
        """Move the samples of finished launches to the host."""
        for lbl, w, out, k in self._pending:
            self.samples.append((lbl.cpu().numpy(), w.cpu().numpy(),
                                 out.cpu().numpy().astype(np.float64), k))
        self._pending.clear()
