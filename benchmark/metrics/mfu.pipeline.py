"""The serving chain's operations over the traced window (the detector's
and the decode's, ``flops_detector.pipeline_flops``, counted from the
widths) at the peak of the cell's dtype, as a share of the window: the
least time the card could take over the time it took."""

from benchmark.peaks import PEAK_OPS


def read(run):
    ops = run.counters.get("pipeline_ops")
    if not ops:
        return None
    return 100.0 * sum(n / PEAK_OPS[dtype] for dtype, n in ops.items()) / run.window_s
