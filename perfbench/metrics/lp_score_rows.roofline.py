"""``lp_score_rows``'s share of its roofline, in %: the least time its
launches could take (each input byte read once and each output byte written
once at the H100's published 3.35 TB/s; the bytes bound it, the adds are
under a hundredth of it) over the device time the profiler gives its
kernel."""

from perfbench.benchlib.peaks import HBM_BYTES_PER_S, lp_score_rows_bytes


def read(run):
    tl = run.timeline
    if tl is None or not run.launches:
        return None
    seconds, count = tl.op_seconds("lp_score_rows")
    if count != len(run.launches) or seconds <= 0:
        return None
    need = sum(lp_score_rows_bytes(R, W, k) for R, W, k in run.launches)
    return 100.0 * need / HBM_BYTES_PER_S / seconds
