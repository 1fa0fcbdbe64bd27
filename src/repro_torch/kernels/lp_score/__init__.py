from .lp_score import lp_score_rows
from .ops import (
    dense_eligibility,
    dense_round_device,
    lp_refine_dense_round,
    node_scores,
)
from .ref import lp_score_rows_ref, node_scores_ref

__all__ = [
    "lp_score_rows",
    "lp_score_rows_ref",
    "node_scores",
    "node_scores_ref",
    "lp_refine_dense_round",
    "dense_round_device",
    "dense_eligibility",
]
