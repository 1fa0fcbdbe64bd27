"""Undirected edge lists to the host CSR arrays the program takes."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def csr_arrays(n: int, lo: torch.Tensor, hi: torch.Tensor,
               perm: Optional[torch.Tensor] = None) -> dict:
    """Symmetric CSR (rows sorted, unit weights) of the edges ``(lo, hi)``,
    node ``x`` renamed ``perm[x]`` when ``perm`` is given.  Built on the
    tensors' device, returned as numpy: ``indptr`` int64, ``indices`` int32,
    ``ew`` and ``nw`` float32."""
    if perm is not None:
        lo, hi = perm[lo], perm[hi]
    src = torch.cat([lo, hi])
    dst = torch.cat([hi, lo])
    order = torch.argsort(src * n + dst)
    indices = dst[order].to(torch.int32)
    counts = torch.bincount(src, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=lo.device)
    indptr[1:] = torch.cumsum(counts, 0)
    m = int(indices.shape[0])
    return dict(indptr=indptr.cpu().numpy(), indices=indices.cpu().numpy(),
                ew=np.ones(m, np.float32), nw=np.ones(n, np.float32))
