"""Plain PyTorch versions of the lp_score kernel (the CPU path and the
on-card yardstick of ``lp_score_rows.cu``)."""

from __future__ import annotations

import torch

__all__ = ["lp_score_rows_ref", "node_scores_ref"]


def lp_score_rows_ref(lbl: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """(R, W) labels/weights -> (R, k) scores; labels outside [0, k)
    contribute 0.  A masked ``scatter_add_`` into a spare column k, never
    the (R, W, k) one-hot."""
    R = lbl.shape[0]
    ok = (lbl >= 0) & (lbl < k)
    idx = torch.where(ok, lbl, k).to(torch.int64)
    out = torch.zeros((R, k + 1), dtype=torch.float32, device=lbl.device)
    out.scatter_add_(1, idx, torch.where(ok, w, 0.0))
    return out[:, :k]


def node_scores_ref(indptr, indices, ew, labels, k: int) -> torch.Tensor:
    """Direct CSR oracle: S[v, b] = sum of w(v, u) over u in Gamma(v) with
    label b."""
    n = indptr.shape[0] - 1
    src = torch.repeat_interleave(
        torch.arange(n, device=indptr.device), indptr[1:] - indptr[:-1]
    )
    out = torch.zeros((n, k), dtype=torch.float32, device=indptr.device)
    return out.index_put_((src, labels[indices].to(torch.int64)), ew, accumulate=True)
