"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its full
power limit of 700 W)."""

HBM_BYTES_PER_S = 3.35e12


def lp_score_rows_bytes(R: int, W: int, k: int) -> int:
    """What one ``lp_score_rows`` launch on ``(R, W)`` rows must move: its
    int32 labels and float32 weights read once, its ``(R, k)`` float32
    scores written once."""
    return R * W * (4 + 4) + R * k * 4
